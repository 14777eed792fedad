"""Meshes (port of ``repro.launch.mesh``) and the card's constants.

``make_host_mesh`` builds a ``DeviceMesh`` over the ranks of the
initialised process group, ("data", "model"); ``make_production_mesh``
gives the reference's production meshes as shapes and names
(``MeshShape``: no processes), for checking specs against them, and
``make_fake_mesh`` lays one out over a process group of any size whose
collectives move nothing (``launch/dryrun.py``).

The constants are the counterparts of the reference's TPU v5e ones, for
an NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, from NVIDIA's
H100 data sheet: dense bf16 tensor-core peak, HBM rate and size, and
NVLink 4's 900 GB/s a card, 450 GB/s each way, among the 8 cards of
one host.  Between hosts a card has one 400 Gb/s NIC, as a DGX H100 has
one ConnectX-7 a card (NVIDIA's DGX H100 user guide); a group of ranks
inside one host runs on NVLink, any other on the NICs (``ranks_link``,
``axis_links``).
"""

from __future__ import annotations

import math
import os

from repro_torch.device import resolve_device
from repro_torch.sharding.specs import MeshShape

CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS_BF16 = 989e12        # per card, dense
HBM_BW = 3.35e12                # bytes/s per card
HBM_BYTES = 80 * 10 ** 9        # 80 GB per card
NVLINK_BW = 450e9               # bytes/s per card, each way, within a host
NIC_BW = 400e9 / 8              # bytes/s per card between hosts
CARDS_PER_HOST = 8


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


def make_fake_mesh(mesh_shape: MeshShape, device=None):
    """A ``DeviceMesh`` of ``mesh_shape`` over a new process group of the
    "fake" backend (``torch.testing``'s ``FakeStore``), this process rank
    0 of ``prod(mesh_shape.shape)``: its collectives return at once and
    write nothing, so one process can trace a rank of the production
    meshes.  No process group may be initialised; destroy it with
    ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    device = resolve_device(device)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh_shape.shape))
    return init_device_mesh(device.type, tuple(mesh_shape.shape),
                            mesh_dim_names=tuple(mesh_shape.axis_names))


def ranks_link(ranks) -> dict:
    """The link a group of ``ranks`` runs on, {"link": "nvlink" or
    "nic", "bytes_per_s": rate}: ranks fill hosts ``CARDS_PER_HOST`` at
    a time, and a group inside one host runs on NVLink; a one-rank group
    sends nothing ("local", an unbounded rate)."""
    if len(ranks) == 1:
        return {"link": "local", "bytes_per_s": math.inf}
    inside = len({r // CARDS_PER_HOST for r in ranks}) == 1
    return {"link": "nvlink" if inside else "nic",
            "bytes_per_s": NVLINK_BW if inside else NIC_BW}


def axis_ranks(mesh_shape, axes) -> list[int]:
    """The ranks of rank 0's group over the mesh axes ``axes`` (names),
    ranks numbered in mesh order, the last axis fastest."""
    names, sizes = list(mesh_shape.axis_names), list(mesh_shape.shape)
    ranks = [0]
    for a in axes:
        i = names.index(a)
        stride = math.prod(sizes[i + 1:])
        ranks = [r + j * stride for r in ranks for j in range(sizes[i])]
    return sorted(ranks)


def axis_links(mesh_shape, combos=()) -> dict[str, dict]:
    """Each mesh axis's link (``ranks_link`` of its groups), and each
    combination in ``combos`` ("pod+data": a group over both), keyed by
    name."""
    keys = list(mesh_shape.axis_names) + list(combos)
    return {k: ranks_link(axis_ranks(mesh_shape, k.split("+") if k else []))
            for k in keys}


def group_axes(mesh_shape, ranks) -> str:
    """The mesh axes rank 0's group of ``ranks`` spans, joined by "+"
    in mesh order ("model", "pod+data"); "" for a one-rank group."""
    names, sizes = list(mesh_shape.axis_names), list(mesh_shape.shape)
    coords = []
    for r in ranks:
        c = []
        for n in reversed(sizes):
            r, x = divmod(r, n)
            c.append(x)
        coords.append(c[::-1])
    return "+".join(a for i, a in enumerate(names)
                    if len({c[i] for c in coords}) > 1)
