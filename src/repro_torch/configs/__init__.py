"""Architecture registry: the configurations the PyTorch port serves.

``base.py`` and ``llama3_8b.py`` are copies of ``repro.configs`` (the JAX
package's modules import nothing of JAX, but the port keeps its own copy
so that it never imports the reference package)."""
from .base import (REGISTRY, SHAPES, ArchConfig, ShapeConfig, cell_supported,
                   get_config, reduce_for_smoke)
from . import llama3_8b  # noqa: F401  (registration side effect)

ALL_ARCHS = sorted(REGISTRY)
