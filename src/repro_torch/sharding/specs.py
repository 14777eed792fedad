"""Logical-axis sharding rules (port of ``repro.sharding.specs``) on a
``torch.distributed`` ``DeviceMesh``.

Arrays are described by *logical* axis names ("batch", "embed", "heads",
...); a rule set maps each to mesh axes ("pod", "data", "model").
``spec_for`` turns a tuple of logical names into the reference's
PartitionSpec, as a plain tuple with the same entries (``None``, an axis
name, or a tuple of names major to minor), and ``placements_for`` turns
that spec into DTensor placements, one per mesh dimension: ``Shard(d)``
where a mesh axis splits array dimension ``d``, else ``Replicate()``.

Parallelism mapping, as in the reference:
  batch    -> ("pod", "data")   data parallel across pods and the data axis
  embed    -> "data"            parameters, moments and error buffers
                                 sharded over data (ZeRO-3 storage)
  heads/mlp/vocab/kv/expert -> "model"
  seq      -> "model"           the decode caches' sequence dimension,
                                 and the residual stream's between the
                                 split products (tensor_parallel.py)

The reference hands the specs to XLA's SPMD partitioner, which also
decides where each product runs.  In the port the specs lay out storage,
and the steps (``train.loop.make_sharded_train_step``,
``serve.decode.jit_decode``/``jit_prefill``) decide the compute: they
split it over the "model" axis as the specs split the leaves (heads,
kv_heads, mlp, experts and vocab; ``sharding/tensor_parallel.py``), each
layer's pieces gathered over the data axes only.  ``model_group``
and ``shard_range`` give a step the "model" axis and this rank's index
range along a split dimension.  ``logical_constraint``, XLA's layout hint
inside model code, returns its input unchanged.

``spec_for`` takes a ``DeviceMesh`` or a ``MeshShape`` (axis names and
sizes, no processes), so rules can be checked against a 2 x 16 x 16 mesh
without 512 ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import NamedTuple

import torch

# logical axis -> mesh axes; order matters for multi-axis assignments
DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),
    "seq": "model",
    "embed": "data",          # FSDP axis for parameters
    "embed_act": None,        # activations keep embed replicated
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "layers": None,
    "qkv": None,
    "conv": None,
    "state": None,
    "capacity": None,
    "image": None,
}

class MeshShape(NamedTuple):
    """A mesh's axis sizes and names, with no processes behind it."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``):
    ``spec`` as ``spec_for`` returns it; ``placements`` per mesh dim.  A
    tree leaf, not a node: trees of shardings mirror trees of tensors."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``, in mesh
    order."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


_ctx = threading.local()


def _state():
    if not hasattr(_ctx, "mesh"):
        _ctx.mesh, _ctx.rules = None, DEFAULT_RULES
    return _ctx


@contextlib.contextmanager
def use_mesh(mesh, rules: dict | None = None):
    """Install a mesh (and rules over the defaults) for this thread, so
    ``spec_for`` and ``named_sharding`` use it without being passed it."""
    st = _state()
    prev = (st.mesh, st.rules)
    st.mesh = mesh
    st.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield mesh
    finally:
        st.mesh, st.rules = prev


def current_mesh():
    return _state().mesh


def spec_for(logical_axes: tuple[str | None, ...],
             rules: dict | None = None, mesh=None,
             shape: tuple[int, ...] | None = None) -> tuple:
    """Logical axis names -> the reference's PartitionSpec as a tuple.

    Divisibility-aware: mesh axes that don't exist (``pod`` on a one-pod
    mesh) or whose size doesn't divide the array dimension (kv_heads 8
    on a 16-way ``model`` axis, granite's 40 experts) are dropped, and
    the dimension stays replicated.  Every mesh axis is used at most
    once."""
    st = _state()
    rules = rules or st.rules
    mesh = mesh if mesh is not None else st.mesh
    sizes = mesh_axes(mesh)
    out, used = [], set()
    for i, ax in enumerate(logical_axes):
        assign = rules.get(ax) if ax is not None else None
        if assign is None:
            out.append(None)
            continue
        if isinstance(assign, str):
            assign = (assign,)
        dim = shape[i] if shape is not None and i < len(shape) else None
        picked = []
        prod = 1
        for a in assign:
            if a not in sizes or a in used:
                continue
            if dim is not None and dim % (prod * sizes[a]) != 0:
                continue
            picked.append(a)
            prod *= sizes[a]
        used.update(picked)
        if len(picked) == 0:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return tuple(out)


def placements_for(spec: tuple, mesh) -> tuple:
    """A spec -> DTensor placements, one per mesh dim.  A dimension over
    several mesh axes (``batch`` -> ("pod", "data")) is split major to
    minor, which is DTensor's order when the axes come in mesh order;
    another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"major-to-minor order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def logical_constraint(x, logical_axes: tuple[str | None, ...]):
    """XLA's layout hint in the reference; the port's steps lay tensors
    out themselves, so this returns ``x`` unchanged.  The reference's one
    constraint that moves compute, the residual stream's ("batch", "seq",
    "embed_act") with "seq" on "model", is the split step's sequence
    split: ``TensorParallel.splits_sequence`` decides it by ``spec_for``
    as the reference does, and ``enter``/``exit`` gather and
    reduce-scatter the rows around each split product
    (``sharding/tensor_parallel.py``)."""
    del logical_axes
    return x


def named_sharding(logical_axes: tuple[str | None, ...],
                   shape: tuple[int, ...] | None = None):
    """``NamedSharding`` of the installed mesh, or None without one."""
    st = _state()
    if st.mesh is None:
        return None
    return NamedSharding(st.mesh, spec_for(logical_axes, shape=shape))


def _is_axes(t) -> bool:
    return isinstance(t, tuple) and not hasattr(t, "_fields")


def tree_shardings(axes_tree, mesh, abstract_tree=None,
                   rules: dict | None = None):
    """A tree (nested dicts) of logical-axis tuples -> the same tree of
    ``NamedSharding``; with ``abstract_tree`` (the same structure, leaves
    with ``.shape``) each spec is divisibility-checked against its
    leaf's shape."""
    if _is_axes(axes_tree):
        shape = None if abstract_tree is None else tuple(abstract_tree.shape)
        return NamedSharding(mesh, spec_for(axes_tree, rules, mesh, shape))
    return {k: tree_shardings(v, mesh, None if abstract_tree is None
                              else abstract_tree[k], rules)
            for k, v in axes_tree.items()}


# ---------------------------------------------------------------------------
# DTensor helpers: lay a plain tensor out on a sharding, and back
# ---------------------------------------------------------------------------

def local_chunk(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's piece of ``full`` under ``placements`` (a view): each
    mesh dim that shards a dimension splits it evenly, mesh dims in
    order (the first the major split), by this rank's coordinate."""
    coord = mesh.get_coordinate()
    out = full
    for i, pl in enumerate(placements):
        if pl.is_shard():
            out = out.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return out


def distribute(full: torch.Tensor, sharding: NamedSharding):
    """A DTensor on ``sharding`` from the whole tensor, which every rank
    holds the same (seeded or loaded): each rank keeps its own chunk,
    with no communication."""
    mesh, pl = sharding.mesh, sharding.placements
    local = local_chunk(full, mesh, pl)
    # a strict piece is copied, so that the whole tensor can be freed
    local = local.clone() if local.numel() < full.numel() else local
    return distribute_local(local, mesh, pl, full.shape)


def zeros(shape, dtype, sharding: NamedSharding):
    """A DTensor of zeros on ``sharding``; each rank allocates its chunk
    only."""
    local_shape = list(shape)
    for i, pl in enumerate(sharding.placements):
        if pl.is_shard():
            local_shape[pl.dim] //= sharding.mesh.size(i)
    device = (torch.device("cuda", torch.cuda.current_device())
              if sharding.mesh.device_type == "cuda" else torch.device("cpu"))
    return distribute_local(torch.zeros(local_shape, dtype=dtype,
                                        device=device), sharding.mesh,
                            sharding.placements, shape)


def distribute_local(local: torch.Tensor, mesh, placements, shape):
    """A DTensor from this rank's piece ``local`` of a tensor of global
    ``shape`` under ``placements`` (``Partial`` ones included)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(tuple(shape),
                                                 device="meta").stride())


def map_leaves(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts and named tuples (None
    stays None), with trees of the same structure alongside."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, v, *(getattr(r, f) for r in rest))
                            for f, v in zip(tree._fields, tree)))
    return None if tree is None else fn(tree, *rest)


def distribute_tree(tree, shardings):
    """Every leaf of ``tree`` (whole tensors, the same on every rank)
    laid out on its sharding in ``shardings``."""
    return map_leaves(lambda t, sh: distribute(t, sh), tree, shardings)


def shard_index(placements, mesh, dim: int = 0) -> tuple[int, int]:
    """(how many pieces ``dim`` is split into, which piece this rank
    holds) under ``placements``."""
    coord = mesh.get_coordinate()
    n, idx = 1, 0
    for i, pl in enumerate(placements):
        if pl.is_shard(dim):
            n, idx = n * mesh.size(i), idx * mesh.size(i) + coord[i]
    return n, idx


def shard_range(placements, mesh, size: int, dim: int = 0) -> tuple[int, int]:
    """This rank's index range [lo, hi) along ``dim`` (of ``size``
    entries) under ``placements``."""
    n, idx = shard_index(placements, mesh, dim)
    return idx * size // n, (idx + 1) * size // n


def model_group(mesh) -> tuple:
    """(the index of ``mesh``'s "model" dimension or None, its size, this
    rank's coordinate on it, its process group or None when it has one
    rank)."""
    names = tuple(mesh.mesh_dim_names)
    if "model" not in names:
        return None, 1, 0, None
    m = names.index("model")
    n = mesh.size(m)
    return m, n, mesh.get_coordinate()[m], mesh.get_group(m) if n > 1 \
        else None
