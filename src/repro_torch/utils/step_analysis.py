"""Step accounting: collective traffic, cost, memory and roofline terms
(port of ``repro.utils.hlo_analysis``).

The reference compiles a step and reads XLA's HLO: the output bytes of
every collective instruction, ``cost_analysis()``'s FLOPs and bytes and
``memory_analysis()``'s argument, output and temp bytes.  The port runs
the step itself, on fake tensors when nothing should be allocated
(``launch/dryrun.py``), and counts the same things at dispatch:

  * ``collective_bytes`` sums the output bytes of each collective that
    ``StepCollectives`` recorded (``output_bytes``), per rank, under the
    reference's op names, and ``calls_by_group`` counts them by group
    (output size is the usual per-rank wire proxy; ring algorithms move
    about 2 (n-1)/n of it, left to the link rate);
  * ``StepCost`` counts FLOPs with ``FlopCounterMode`` and bytes as each
    dispatched op's input and output bytes (the port runs unfused, so
    each op reads its inputs from and writes its outputs to memory;
    views and collectives are not counted);
  * ``StepMemory`` follows every storage a step allocates until it is
    freed, each rounded up to 512 bytes as the CUDA caching allocator
    rounds a block.

Roofline terms, at the H100's constants in ``launch/mesh.py``:
    T_comp = FLOPs / PEAK_FLOPS_BF16
    T_mem  = bytes / HBM_BW
    T_coll = sum over mesh axes of the axis's collective bytes over its
             link's rate (``mesh.axis_links``: NVLink inside a host, the
             NIC between hosts)
all per rank: the step traced is one rank's.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch.mesh import HBM_BW, NIC_BW, PEAK_FLOPS_BF16
from repro_torch.sharding.tensor_parallel import CollectiveLog

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the op name's stem (c10d's and the functional collectives') -> kind
_KINDS = {"allgather": "all-gather", "all_gather": "all-gather",
          "allreduce": "all-reduce", "all_reduce": "all-reduce",
          "reduce_scatter": "reduce-scatter", "alltoall": "all-to-all",
          "all_to_all": "all-to-all", "send": "collective-permute"}

GRANULE = 512             # the CUDA caching allocator's block rounding


def collective_kind(op: str) -> str | None:
    """The reference's name for a recorded op ("c10d._allgather_base_.
    default", "_c10d_functional.all_reduce.default", ...), or None for
    what is not one of ``COLLECTIVES`` (waits, barriers, broadcasts)."""
    name = op.split(".")[1].strip("_") if "." in op else op
    for stem, kind in _KINDS.items():
        if name.startswith(stem):
            return kind
    return None


def output_bytes(call, sizes: dict | None = None) -> int:
    """A recorded collective's output bytes on this rank: c10d's ops
    write their first tensor argument (the port calls the tensor forms:
    ``_allgather_base_``, ``_reduce_scatter_base_``, ``allreduce_``,
    ``alltoall_base_``); the functional ones (DTensor's) return a tensor
    of their input's size, an all-gather's ``n`` times it and a
    reduce-scatter's 1/``n`` of it, ``n`` the group's size in ``sizes``
    ({group name: ranks})."""
    first = call.nbytes[0]
    if call.op.startswith("c10d."):
        return first
    kind = collective_kind(call.op)
    n = (sizes or {}).get(call.group, 1)
    return first * n if kind == "all-gather" else \
        first // n if kind == "reduce-scatter" else first


def collective_bytes(calls, axes: dict | None = None,
                     sizes: dict | None = None) -> dict:
    """Sum per-op output bytes (``output_bytes``) of every collective in
    ``calls`` (``CollectiveLog.calls``): {"by_op_bytes", "by_op_count",
    "total_bytes"} as the reference's, and with ``axes`` ({group name:
    mesh axis name}) "by_axis_bytes" too."""
    out = {op: 0 for op in COLLECTIVES}
    counts = {op: 0 for op in COLLECTIVES}
    by_axis: dict = {}
    for c in calls:
        kind = collective_kind(c.op)
        if kind is None:
            continue
        b = output_bytes(c, sizes)
        out[kind] += b
        counts[kind] += 1
        if axes is not None:
            ax = axes.get(c.group, c.group)
            by_axis[ax] = by_axis.get(ax, 0) + b
    rec = {"by_op_bytes": out, "by_op_count": counts,
           "total_bytes": sum(out.values())}
    if axes is not None:
        rec["by_axis_bytes"] = by_axis
    return rec


class StepCollectives(CollectiveLog):
    """``CollectiveLog`` with each functional collective's group read
    from its last string argument: its reduce op ("sum") comes before
    it, and ``CollectiveLog`` keeps the first string it finds.  (Fixing
    ``CollectiveLog`` itself books DTensor's functional all-reduces in
    the split train step to "model", among them one of a parameter
    piece's shape, which ``test_torch_split_dense``'s activation-size
    rule forbids: ROADMAP, queue 3.)"""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        n = len(self.calls)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        names = [a for a in args if isinstance(a, str)]
        if len(self.calls) > n and func.namespace == "_c10d_functional" \
                and names:
            self.calls[-1] = self.calls[-1]._replace(group=names[-1])
        return out


def calls_by_group(calls, names: dict | None = None) -> dict:
    """{group: {op: {"calls", "largest_bytes"}}} of ``calls``
    (``CollectiveLog.calls``): each op by its own name
    (``_allgather_base_``, ``all_reduce``, ...), its count and its
    largest tensor argument's bytes; ``names`` ({group name: label},
    a mesh axis) relabels the groups."""
    out: dict = {}
    for c in calls:
        g = (names or {}).get(c.group, str(c.group))
        slot = out.setdefault(g, {}).setdefault(
            c.op.split(".")[1], {"calls": 0, "largest_bytes": 0})
        slot["calls"] += 1
        slot["largest_bytes"] = max(slot["largest_bytes"],
                                    max(c.nbytes, default=0))
    return out


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local piece; any other tensor itself."""
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _bytes(t: torch.Tensor) -> int:
    """A tensor's bytes; none for a "meta" one (a layout's stand-in,
    ``specs.distribute_local``'s strides), which holds no memory."""
    t = _local(t)
    return 0 if t.device.type == "meta" else t.numel() * t.element_size()


class StepCost(TorchDispatchMode):
    """Bytes of every op dispatched while on, and its calls by op
    (``ops``); ``summarize_cost`` adds a ``FlopCounterMode``'s FLOPs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        self.ops[name] = self.ops.get(name, 0) + 1
        # views move nothing; nor do the device queries ("prim") that
        # fake tensors dispatch
        if not func.is_view and func.namespace != "prim" \
                and collective_kind(str(func)) is None:
            self.bytes += sum(_bytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_bytes(t) for t in _tensors(out))
        return out


def summarize_cost(flops, cost: StepCost) -> dict:
    """(a ``FlopCounterMode`` or its total, a ``StepCost``) ->
    {"flops", "bytes"}, the keys of the reference's."""
    total = flops if isinstance(flops, (int, float)) \
        else flops.get_total_flops()
    return {"flops": float(total), "bytes": float(cost.bytes)}


def _rounded(n: int) -> int:
    return -(-n // GRANULE) * GRANULE


class StepMemory(TorchDispatchMode):
    """Live device bytes while on, at dispatch: each storage an op
    allocates counts, rounded up to ``GRANULE``, from the op that makes
    it until its last tensor is freed.  ``arguments(tree)`` counts the
    step's inputs first; ``outputs(tree)`` names its results after.

    ``memory()`` gives XLA's ``memory_analysis`` keys:
    argument_size_in_bytes (the inputs' storages), output_size_in_bytes
    (the results' storages not among the inputs) and temp_size_in_bytes
    (the peak of live bytes above the arguments, results included), and
    peak_bytes (arguments + temp)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.args = 0
        self.out = 0
        self._held: dict[int, int] = {}
        self._arg_keys: set[int] = set()

    def _track(self, t: torch.Tensor) -> int:
        st = _local(t).untyped_storage()
        key = st._cdata
        if key in self._held:
            return key
        n = 0 if _local(t).device.type == "meta" else _rounded(st.nbytes())
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return key

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def arguments(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as the step's
        inputs."""
        for t in _tensors(tree):
            self._arg_keys.add(self._track(t))
        self.args = sum(self._held[k] for k in self._arg_keys
                        if k in self._held)
        self.peak = max(self.peak, self.live)

    def outputs(self, tree) -> None:
        """Name ``tree``'s tensors as the step's results."""
        keys = {_local(t).untyped_storage()._cdata for t in _tensors(tree)}
        self.out = sum(self._held.get(k, 0) for k in keys - self._arg_keys)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self._track(t)
        return out

    def memory(self) -> dict:
        return {"argument_size_in_bytes": self.args,
                "output_size_in_bytes": self.out,
                "temp_size_in_bytes": self.peak - self.args,
                "peak_bytes": self.peak}


def roofline_terms(flops: float, byts: float, coll_bytes: float,
                   chips: int, *, by_axis: dict | None = None,
                   links: dict | None = None) -> dict:
    """Terms in seconds + the dominant bottleneck, per rank (the step
    traced is one rank's; ``chips`` is kept for reporting only).  The
    collective term takes each mesh axis's bytes (``by_axis``) over its
    link (``links``, ``mesh.axis_links``); without them all the bytes
    go over the NIC.  "links" names the link assumed for each axis."""
    del chips
    t_comp = flops / PEAK_FLOPS_BF16
    t_mem = byts / HBM_BW
    if by_axis and links:
        t_coll = sum(b / links[ax]["bytes_per_s"] for ax, b in by_axis.items())
        assumed = {ax: links[ax]["link"] for ax in by_axis}
    else:
        t_coll = coll_bytes / NIC_BW
        assumed = {"all": "nic"}
    terms = {"t_comp": t_comp, "t_mem": t_mem, "t_coll": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        **terms,
        "dominant": dom,
        "bound_s": bound,
        "comp_fraction": t_comp / bound if bound > 0 else 0.0,
        "links": assumed,
    }


def model_flops(n_params: int, n_tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference forward)."""
    return (6.0 if kind == "train" else 2.0) * n_params * n_tokens
