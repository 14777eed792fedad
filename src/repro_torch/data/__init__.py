"""The deterministic, seekable synthetic data pipeline (port of
``repro.data``)."""

from .pipeline import DataConfig, device_batch, make_batch

__all__ = ["DataConfig", "device_batch", "make_batch"]
