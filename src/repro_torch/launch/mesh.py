"""Meshes (port of ``repro.launch.mesh``).

``make_host_mesh`` builds a ``DeviceMesh`` over the ranks of the
initialised process group, ("data", "model"); ``make_production_mesh``
gives the reference's production meshes as shapes and names
(``MeshShape``: no processes), for checking specs against them.
"""

from __future__ import annotations

import math
import os

from repro_torch.device import resolve_device
from repro_torch.sharding.specs import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_host_mesh(model_parallel: int = 1, device=None):
    """(world / model_parallel, model_parallel) ranks as ("data",
    "model") on ``device``'s type (the card unless the caller asks for
    the CPU).  The process group must be initialised.  On the card the
    rank's device is set first: ``device``'s index, else ``LOCAL_RANK``
    (torchrun's), else 0."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else int(os.environ.get("LOCAL_RANK", "0")))
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel "
                         f"{model_parallel}")
    return init_device_mesh(device.type, (n // model_parallel,
                                          model_parallel),
                            mesh_dim_names=("data", "model"))


def mesh_chip_count(mesh) -> int:
    return math.prod(tuple(mesh.shape))
