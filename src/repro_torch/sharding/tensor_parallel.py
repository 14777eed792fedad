"""Tensor-parallel compute over the mesh's "model" axis, with the
parameters' "data" pieces gathered one layer at a time (FSDP), for every
family: the dense and MoE decoders, the hybrid (attention beside a Mamba
branch), the xLSTM, the vlm (its self and gated cross layers) and the
audio encoder.

The reference hands its logical-axis specs to XLA, whose partitioner
splits the products: heads, kv_heads, mlp and vocab over "model".  Here
the same split is written out, Megatron style, over
``mesh.get_group("model")``:

* The residual stream splits by sequence (Megatron's sequence
  parallelism) wherever the reference's ``spec_for(("batch", "seq",
  "embed_act"))`` puts "model" on its sequence (``splits_sequence``: S a
  multiple of the "model" size): between the split products a rank holds
  its own S/m rows, [B/dp, S/m, d], and runs the norms and residual adds
  on them.  Before a column-split product (wq/wk/wv, w_gate/w_up, the
  MoE layer, the Mamba and xLSTM inputs, the unembedding) the normed rows
  are all-gathered along the sequence (``_GatherModel``: the backward
  reduce-scatters); after a row-split product (wo, w_down, the
  embedding's vocab rows) the sum over "model" is a reduce-scatter along
  the sequence (``_ScatterModel``: the backward all-gathers).  A part
  that runs whole takes the same gather and keeps its rows of the whole
  output (a slice).  Every rank's gradient then covers its own rows'
  terms of the loss only, so every leaf that is not split on "model"
  (the norms, hubert's ``b_out``, a whole part's leaves) computes on
  ``Partial`` there and the data mean sums it (``LeafPlan``).  The
  unembedding keeps only the rows for its backward and gathers them
  again (``_RowsUnembed``).  Decode (one token a lane) and a sequence
  that does not divide never split:
* there ``copy_to_model`` (``enter``) goes before a column-split
  product: identity forward, all-reduce backward; ``reduce_from_model``
  (``exit``) after a row-split product: all-reduce forward, identity
  backward.  All are ``torch.autograd.Function``s over plain
  ``torch.distributed`` calls.
* ``TensorParallel.layer`` gathers one layer's parameter pieces over the
  mesh dims other than "model" (``_Gather``: an all-gather forward; its
  backward is ``train.loop._Layout.reduce``, the data mean
  reduce-scattered onto the leaf's own piece, one leaf at a time).  Each
  rank keeps its own "model" piece; nothing gathers the whole tree.
* The vocabulary split follows the reference's ``REPRO_SHARDED_CE``: the
  embedding looks up this rank's vocab rows (zero elsewhere) and
  all-reduces; the unembedding computes this rank's vocab columns in
  fp32; the loss all-reduces only [B, S]-sized partials (the max, the
  sum of exponentials, the label's logit).
* Decode over the sequence-sharded cache (``combine``): each rank attends
  its own positions for every head and returns (out, lse); the pieces
  merge by lse weights across "model" after a MAX all-reduce of the lse,
  so a rank whose positions are all masked weighs 0.
* The vlm's cross layers run on this rank's heads as the self layers
  do: q of its heads against the image K/V of its KV heads, ``wo``
  row-split.  Their ``gate``, ``q_norm`` and ``k_norm`` stay whole on
  every rank but act on this rank's heads only, so their gradient is a
  partial sum over "model" (``_MODEL_PARTIAL``: the leaf's plan
  computes on ``Partial`` there, and the data mean sums it).  The audio
  MLP's ``b_in`` splits with ``w_in``'s columns; ``b_out`` is added
  once, after the sum over "model".
* The MoE layer (``moe.moe_ffn_split``) runs this rank's experts on its
  rows' choices of them, the router's logits gathered over "model" (its
  backward a reduce-scatter), or every expert on its d_ff columns where
  the experts do not split; its dispatch ranks a data rank's choices
  after the earlier data ranks' (an all-gather of [E] counts) and its
  aux loss sums the data ranks' shares (``data_sum``).
* The hybrid's Mamba branch (part "ssm") runs this rank's channels of
  d_inner: ``in_proj`` [d, 2 di] is one matrix whose "model" piece is
  contiguous (x's columns on the first ranks, z's on the last), so it is
  gathered over "model" with the layer (``_GatherModel``, whose backward
  reduce-scatters the gradient onto the piece) and the rank takes its x
  and z columns (``ssm_columns``); a decode step instead gathers the
  products of the input with each rank's piece (``ssm_in``); the conv,
  dt and A run per channel;
  ``x_proj``'s output (dt, B and C) is summed over "model" forward and
  backward, ``out_proj``'s after it.  The xLSTM (part "xlstm") runs this
  rank's heads of both branches: ``m_og``'s contiguous d/m columns are
  its heads' channels, ``m_out`` and ``s_out`` are row-split and summed.
  Decode reads this rank's channels or heads of the recurrent state
  (whole over "model", as the reference lays it out) and gathers the
  new pieces back in one all-gather a layer (``gather_state``).

What splits is what ``spec_for`` split: a part (attention, the MLP, the
vocabulary) runs split only when all of its leaves shard on "model"
(``TensorParallel.split``); a part that ``spec_for`` left whole on some
leaf (kv_heads that do not divide the "model" size) runs whole on every
rank, its leaves gathered over "model" too, and ``whole_parts`` names it
so that the step can warn.  On a mesh whose "model" size is 1 every part
is split trivially and no collective runs on that axis.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PARTS = ("attn", "mlp", "moe", "vocab", "ssm", "xlstm")
# the leaves of each part (paths under the parameter tree's root, the
# vlm's "blocks/self/" and "blocks/cross/" read as "blocks/")
_PART_LEAVES = {
    "attn": ("blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wv",
             "blocks/attn/wo", "blocks/attn/bq", "blocks/attn/bk",
             "blocks/attn/bv"),
    "mlp": ("blocks/mlp/w_gate", "blocks/mlp/w_up", "blocks/mlp/w_down",
            "blocks/mlp/w_in", "blocks/mlp/b_in", "blocks/mlp/w_out"),
    "moe": ("blocks/moe/router", "blocks/moe/w_gate", "blocks/moe/w_up",
            "blocks/moe/w_down"),
    "vocab": ("embed", "unembed"),
    "ssm": tuple(f"blocks/ssm/{k}" for k in (
        "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
        "A_log", "D", "out_proj")),
    "xlstm": tuple(f"blocks/{k}" for k in (
        "m_qkv", "m_if", "m_if_b", "m_og", "m_out", "s_w", "s_r", "s_b",
        "s_out")),
}
# leaves whole on every rank that act on this rank's heads when attention
# is split, so that each rank's gradient is its part of the sum over
# "model"
_MODEL_PARTIAL = ("blocks/cross/attn/gate", "blocks/cross/attn/q_norm",
                  "blocks/cross/attn/k_norm")
# the MoE part's split by the dimension "model" shards in one layer of
# w_gate [E, d, ff]: by expert or by d_ff column
_MOE_MODES = {0: "expert", 2: "mlp"}


def _part_of(path: str) -> str | None:
    path = path.replace("blocks/self/", "blocks/").replace("blocks/cross/",
                                                             "blocks/")
    for part, names in _PART_LEAVES.items():
        if path in names:
            return part
    return None


def layer_dims(path: str) -> int:
    """The leading layer dimensions of the leaf at ``path``: 2 for the
    vlm's self stack [ns, inner, ...], 1 for another stacked leaf, 0 at
    the top level."""
    if path.startswith("blocks/self/"):
        return 2
    return int(path.startswith("blocks/"))


def _reduce_scatter(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The sum over ``n`` ranks of ``t``, each rank keeping its own of
    ``n`` equal pieces along ``dim``: the backend's reduce-scatter (NCCL,
    the fake group), or an all-reduce and a slice on gloo, which has
    none."""
    import torch.distributed as dist

    x = t.movedim(dim, 0).contiguous()
    if dist.get_backend(group) != "gloo":
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        # reduce_scatter_single is the newer name (as all_gather_single)
        scatter = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor
        scatter(out, x, group=group)
    else:
        dist.all_reduce(x, group=group)
        out = x.chunk(n)[dist.get_rank(group)]
    return out.movedim(0, dim).contiguous()


def _all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """``n`` ranks' pieces of ``t`` concatenated along ``dim`` (rank
    order), contiguous."""
    import torch.distributed as dist

    # all_gather_single is the newer name; all_gather_into_tensor, which
    # it deprecates, is the only one in older releases
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    gather(out, x, group=group)
    return out.movedim(0, dim).contiguous()


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient over "model"."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce (sum) over "model" forward, identity backward: every
    rank computes the same loss from the sum, so each rank's gradient of
    the sum is already the gradient of its own term."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """All-gather over "model" along ``dim``; backward: the ranks'
    gradients summed, each rank keeping its own piece (reduce-scatter):
    each rank's gradient of the gathered tensor covers only its own
    terms of the loss."""

    @staticmethod
    def forward(ctx, t, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _all_gather(t, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.n), None, None, \
            None


class _ScatterModel(torch.autograd.Function):
    """The sum over "model", each rank keeping its own piece along
    ``dim`` (reduce-scatter); backward: the pieces' gradients
    all-gathered, since every rank's term of the sum takes the whole
    gradient of it (the mirror of ``_GatherModel``)."""

    @staticmethod
    def forward(ctx, t, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _reduce_scatter(t, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _RowsUnembed(torch.autograd.Function):
    """This rank's rows of the normed stream [B, S/m, d] (of its last
    position, [B, 1, d], with ``last``) -> the logits of every row (of
    the stream's last position, which the last rank holds), fp32: the
    rows all-gathered along the sequence, then ``layers.unembed``.  The
    backward keeps only the rows and gathers them again for the table's
    gradient, where autograd would keep the gathered [B, S, d].  With
    the vocabulary split the rank's logits are its vocab columns, and
    the rows' gradient is reduce-scattered back; with it whole every
    rank computes every logit, and only this rank's rows' terms flow
    back (the table then computes on ``Partial``)."""

    @staticmethod
    def _gathered(x, tp, last):
        """Every rank's rows, or with ``last`` the stream's last one."""
        xg = _all_gather(x, 1, tp.group, tp.size)
        return xg[:, -1:] if last else xg

    @staticmethod
    def forward(ctx, x, table, tp, last):
        from repro_torch.models.layers import unembed

        ctx.tp, ctx.last = tp, last
        ctx.save_for_backward(x, table)
        return unembed(_RowsUnembed._gathered(x, tp, last), table)

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        tp, last = ctx.tp, ctx.last
        t32 = table.float()
        if tp.split["vocab"]:
            xg = _RowsUnembed._gathered(x, tp, last)
            gt = g.flatten(0, 1).T @ xg.float().flatten(0, 1)
            gx = g @ t32
            if last:            # the gathered rows but the last: no term
                gx = torch.cat([gx.new_zeros(
                    (gx.shape[0], tp.size - 1, gx.shape[2])), gx], dim=1)
            gx = _reduce_scatter(gx, 1, tp.group, tp.size)
        else:
            if last:
                own = g if tp.rank == tp.size - 1 else torch.zeros_like(g)
            else:
                own = tp.own_rows(g)
            gt = own.flatten(0, 1).T @ x.float().flatten(0, 1)
            gx = own @ t32
        return gx.to(x.dtype), gt.to(table.dtype), None, None


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over a group, forward and backward: every rank's
    loss holds the sum, so each rank's input takes the sum of every
    rank's gradient of it."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _rows_group(mesh, placements):
    """(pieces, this rank's piece, the process group over them or None)
    of a batch split by ``placements`` over the data axes, the pieces in
    the mesh's flattened ("pod", "data") order."""
    from repro_torch.sharding.specs import shard_index

    if placements is None:
        return 1, 0, None
    n, idx = shard_index(placements, mesh)
    dims = [i for i, pl in enumerate(placements)
            if pl.is_shard(0) and mesh.size(i) > 1]
    if not dims:
        return n, idx, None
    if len(dims) == 1:
        return n, idx, mesh.get_group(dims[0])
    names = tuple(mesh.mesh_dim_names[i] for i in dims)
    return n, idx, mesh[names]._flatten().get_group()


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How one parameter leaf (one layer of a stacked leaf) moves in the
    step: ``gathers`` (mesh dim, tensor dim) all-gathered before use,
    minor mesh dim first; ``compute`` the placements of the tensor the
    layer computes with (``Partial`` on "model" for a leaf whose
    gradient is a partial sum there: ``_MODEL_PARTIAL``, and under the
    sequence split every leaf not split on "model"); ``placements``
    the leaf's own; ``shape`` the layer's global shape."""
    mesh: object
    gathers: tuple
    compute: tuple
    placements: tuple
    shape: tuple

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        for i, d in self.gathers:
            local = _all_gather(local, d, self.mesh.get_group(i),
                                self.mesh.size(i))
        return local


class _Gather(torch.autograd.Function):
    """A leaf's piece -> the tensor its layer computes with (all-gathered
    over the mesh dims in ``plan.gathers``); backward: this rank's
    gradient of it -> this rank's piece of the data-mean gradient
    (``TensorParallel.reduce``)."""

    @staticmethod
    def forward(ctx, local, plan, tp):
        ctx.plan, ctx.tp = plan, tp
        return plan.gather(local) if plan.gathers else local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.reduce(g, ctx.plan), None, None


def _placements_without(placements, lead: int = 1) -> tuple:
    """A stacked leaf's placements -> those of one layer (its ``lead``
    leading layer dimensions gone)."""
    from torch.distributed.tensor import Shard

    out = []
    for pl in placements:
        if pl.is_shard():
            if pl.dim < lead:
                raise ValueError("a layer-stacked leaf is split on its "
                                 "layer dimension")
            out.append(Shard(pl.dim - lead))
        else:
            out.append(pl)
    return tuple(out)


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _nest_like(tree, flat: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _nest_like(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    return flat[prefix[:-1]]


class TensorParallel:
    """The split of one model's parameters on a mesh, and the pieces of
    the split step (module docstring).

    ``p_sh`` is the parameters' tree of ``NamedSharding``s
    (``specs.tree_shardings``) and ``params_abs`` their abstract tree.
    ``reduce`` is the gradients' data mean (``train.loop._Layout.reduce``:
    a per-rank gradient, the leaf's placements, the placements and global
    shape it was computed on -> this rank's piece); inference needs
    none.  ``rows``: the placements that split the batch's rows over the
    data axes when each rank computes its own rows (None: every rank
    computes every row); an MoE dispatch ranks across them
    (``moe.moe_ffn_split``).

    ``plans``/``block_plans`` are the leaves' ``LeafPlan``s for the
    unsplit stream, ``sp_plans``/``sp_block_plans`` for the stream split
    by sequence (``splits_sequence``), where every leaf not split on
    "model" computes on ``Partial`` there.

    The MoE part (``moe_mode``) follows ``spec_for``, which puts "model"
    on the experts when E divides its size, else on d_ff when that
    divides: "expert" (this rank's experts, ``moe_experts`` = (E/m, the
    first), the router's columns of them), "mlp" (every expert on this
    rank's d_ff columns, the router whole) or None (the whole layer on
    every rank, with ``warn_whole``'s warning)."""

    def __init__(self, cfg, mesh, p_sh, params_abs, *, reduce=None,
                 rows=None):
        from repro_torch.sharding.specs import model_group, shard_range

        self.cfg, self.mesh = cfg, mesh
        self.m, self.size, self.rank, self.group = model_group(mesh)
        self._reduce = reduce
        n, idx, self._data_group = _rows_group(mesh, rows)
        self.rows = (n, idx)
        sh, abs_ = _flat(p_sh), _flat(params_abs)

        def on_model(path):
            return self.m is not None and \
                sh[path].placements[self.m].is_shard()
        self.split = {part: all(on_model(p) for p in sh
                                if _part_of(p) == part) for part in PARTS}
        self.moe_mode, self.moe_experts = None, (cfg.n_experts, 0)
        if "blocks/moe/w_gate" in sh:
            pl = _placements_without(sh["blocks/moe/w_gate"].placements)
            if self.m is not None and pl[self.m].is_shard():
                self.moe_mode = _MOE_MODES[pl[self.m].dim]
            self.split["moe"] = self.moe_mode is not None
            if self.moe_mode == "expert":
                lo, hi = shard_range(pl, mesh, cfg.n_experts)
                self.moe_experts = (hi - lo, lo)
        self.moe = "blocks/moe/w_gate" in sh

        def plan(path, sp: bool) -> LeafPlan:
            lead = layer_dims(path)
            pl = _placements_without(sh[path].placements, lead)
            part = _part_of(path)
            keep = part is not None and self.split[part]
            # the leaf's gradient on a rank is its part of the sum over
            # "model": it acts on this rank's heads, or (under the
            # sequence split) on this rank's rows
            partial = self.size > 1 and (sp or (
                path in _MODEL_PARTIAL and self.split["attn"]))
            compute, gathers = [], []
            for i, p in enumerate(pl):
                if p.is_shard() and mesh.size(i) > 1 \
                        and not (i == self.m and keep):
                    gathers.append((i, p.dim))
                    compute.append(_partial() if i == self.m and partial
                                   else _replicate())
                elif i == self.m and partial and not p.is_shard():
                    compute.append(_partial())
                else:
                    compute.append(p)
            return LeafPlan(mesh, tuple(reversed(gathers)), tuple(compute),
                            pl, tuple(abs_[path].shape)[lead:])

        def blocks(plans):
            return _nest_like(p_sh["blocks"], {
                k[len("blocks/"):]: v for k, v in plans.items()
                if k.startswith("blocks/")})
        # the plans of the unsplit stream, and (sp) of the stream split by
        # sequence
        self.plans = {path: plan(path, False) for path in sh}
        self.sp_plans = {path: plan(path, True) for path in sh}
        self.block_plans = blocks(self.plans)
        self.sp_block_plans = blocks(self.sp_plans)
        # this rank's vocab rows [start, start + rows) of the tables
        self.vocab_start, end = (0, cfg.vocab)
        if self.split["vocab"]:
            table = "unembed" if cfg.embed_inputs else "embed"
            self.vocab_start, end = shard_range(sh[table].placements,
                                                mesh, cfg.vocab)
        self.vocab_rows = end - self.vocab_start

    # -- the split ----------------------------------------------------------

    def whole_parts(self) -> list[str]:
        """The parts ``spec_for`` left whole on some leaf: they run whole
        on every rank, their leaves gathered over "model"."""
        return [p for p in PARTS if not self.split[p]]

    def warn_whole(self, what: str) -> None:
        """One warning naming the parts this step computes whole."""
        whole = self.whole_parts()
        if whole and self.size > 1:
            warnings.warn(
                f"{self.cfg.name}: {what} computes {', '.join(whole)} whole "
                f"on each of the {self.size} \"model\" ranks (spec_for "
                f"left a leaf of each unsplit), gathering their leaves",
                stacklevel=3)

    # -- the sequence split -------------------------------------------------

    def splits_sequence(self, B: int, S: int) -> bool:
        """Whether a [B, S, d] residual stream of this rank's B rows
        splits by sequence over "model" (module docstring): where the
        reference's ``spec_for(("batch", "seq", "embed_act"))`` of the
        whole batch puts "model" on the sequence, on more than one
        rank."""
        from repro_torch.sharding.specs import spec_for

        if self.group is None:
            return False
        seq = spec_for(("batch", "seq", "embed_act"), mesh=self.mesh,
                       shape=(B * self.rows[0], S, self.cfg.d_model))[1]
        return "model" in ((seq,) if isinstance(seq, str) else (seq or ()))

    def own_rows(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's rows of ``t`` along the sequence ``dim`` (a view):
        piece ``rank`` of ``size`` equal pieces."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * n, n)

    # -- the collectives over "model" -----------------------------------------

    def enter(self, x, part: str, sp: bool = False):
        """Before a column-split product of ``part``: identity forward,
        the gradient all-reduced over "model".  With ``sp`` (the stream
        split by sequence) this rank's rows [B, S/m, d] all-gathered along
        the sequence, the gradient reduce-scattered back: for a part that
        runs whole too, whose every rank then computes the whole
        sequence."""
        if self.group is None:
            return x
        if sp:
            return _GatherModel.apply(x, 1, self.group, self.size)
        if not self.split[part]:
            return x
        return _CopyToModel.apply(x, self.group)

    def exit(self, y, part: str, sp: bool = False):
        """After a row-split product of ``part``: the sum over ranks.
        With ``sp`` the sum reduce-scattered along the sequence (this
        rank's rows of it; the gradient all-gathered back), or, where
        ``part`` runs whole, this rank's rows of its whole output (a
        slice: the gradient covers those rows only, and the part's leaves
        compute on ``Partial``)."""
        if self.group is None:
            return y
        if sp:
            if self.split[part]:
                return _ScatterModel.apply(y, 1, self.group, self.size)
            return self.own_rows(y)
        if not self.split[part]:
            return y
        return _ReduceFromModel.apply(y, self.group)

    def gather_model(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t``'s pieces over "model" along ``dim``, the gradient's sum
        over the ranks scattered back (``_GatherModel``)."""
        if self.group is None:
            return t
        return _GatherModel.apply(t, dim, self.group, self.size)

    def moe_aux(self, aux, sp: bool = False):
        """The MoE loss's terms summed over "model" when each rank holds
        its own experts' (``moe.moe_ffn_split``: split by expert, or any
        mode under the sequence split ``sp``), identity backward."""
        if self.group is None or aux is None or not self.moe or (
                self.moe_mode != "expert" and not sp):
            return aux
        return _ReduceFromModel.apply(aux.reshape(1), self.group)[0]

    # -- the collectives over the data axes (the batch's rows) ----------------

    def data_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[n, *t.shape]: every data rank's ``t`` in row order (no
        gradient)."""
        if self._data_group is None:
            return t[None]
        return _all_gather(t.detach()[None], 0, self._data_group,
                           self.rows[0])

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data ranks (``_SumOver``)."""
        if self._data_group is None:
            return t
        return _SumOver.apply(t, self._data_group)

    def model_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over "model" (no gradient)."""
        if self.group is None:
            return t
        import torch.distributed as dist

        t = t.detach().contiguous().clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def gather_heads(self, t: torch.Tensor) -> torch.Tensor:
        """[..., H/tp, hd] -> [..., H, hd] over "model" (inference)."""
        if self.group is None or not self.split["attn"]:
            return t
        return _all_gather(t, t.dim() - 2, self.group, self.size)

    def gather_qkv(self, q, k, v):
        """A decode step's q [B, H/tp, hd] and k, v [B, KV/tp, hd] of this
        rank's heads -> every head's, in one all-gather over "model"."""
        if self.group is None or not self.split["attn"]:
            return q, k, v
        sizes = [t.shape[1] for t in (q, k, v)]
        every = _all_gather(torch.cat([q, k, v], dim=1), 1, self.group,
                            self.size)
        parts = every.unflatten(1, (self.size, sum(sizes))).split(sizes,
                                                                  dim=2)
        return tuple(t.flatten(1, 2) for t in parts)

    def own_heads(self, t: torch.Tensor) -> torch.Tensor:
        """[..., H, hd] -> this rank's heads [..., H/tp, hd]."""
        if self.size == 1 or not self.split["attn"]:
            return t
        n = t.shape[-2] // self.size
        return t[..., self.rank * n:(self.rank + 1) * n, :]

    # -- the recurrent branches ---------------------------------------------

    def ssm_channels(self) -> range:
        """This rank's channels of the Mamba branch's d_inner (= d): its
        columns of x in ``in_proj``, and of z d_inner further on."""
        di = self.cfg.d_model
        if self.size == 1 or not self.split["ssm"]:
            return range(di)
        n = di // self.size
        return range(self.rank * n, (self.rank + 1) * n)

    def ssm_columns(self, w: torch.Tensor) -> torch.Tensor:
        """``in_proj``'s piece [d, 2 di/m] (gathered over the data axes)
        -> this rank's x columns, then its z columns, [d, 2 di/m]
        (``ssm_channels``): the matrix gathered over "model" (its
        gradient's sum scattered back onto the piece), so the Mamba
        branch computes the same channels of x and of z.  The matrix
        itself where the part runs whole or on one rank."""
        if self.group is None or not self.split["ssm"]:
            return w
        whole = self.gather_model(w, w.dim() - 1)
        ch, di = self.ssm_channels(), whole.shape[-1] // 2
        return torch.cat([whole[..., ch.start:ch.stop],
                          whole[..., di + ch.start:di + ch.stop]], dim=-1)

    def ssm_in(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``h`` [..., d] times ``in_proj`` -> x and z of this rank's
        channels [..., 2 di/m].  Where a gradient flows, or where the
        tokens outnumber d (a prefill), through ``ssm_columns``: the
        matrix gathered.  Otherwise (a decode step) ``h`` times the
        rank's own piece, the products' columns all-gathered over
        "model" and this rank's taken: [tokens, 2 di] moved in place of
        the [d, 2 di] matrix."""
        tokens = h.numel() // h.shape[-1]
        if (self.group is None or not self.split["ssm"]
                or tokens >= h.shape[-1] or (torch.is_grad_enabled() and (
                    h.requires_grad or w.requires_grad))):
            return h @ self.ssm_columns(w).to(h.dtype)
        every = _all_gather(h @ w.to(h.dtype), h.dim() - 1, self.group,
                            self.size)
        ch, di = self.ssm_channels(), every.shape[-1] // 2
        return torch.cat([every[..., ch.start:ch.stop],
                          every[..., di + ch.start:di + ch.stop]], dim=-1)

    def own_state(self, state: dict, dims: dict, part: str) -> dict:
        """A layer's recurrent state, whole over "model" -> this rank's
        channels or heads of each leaf (``dims``: leaf name -> the
        dimension ``part`` splits), views; the whole state where the part
        runs whole."""
        if self.size == 1 or not self.split[part]:
            return state
        out = {}
        for k, t in state.items():
            n = t.shape[dims[k]] // self.size
            out[k] = t.narrow(dims[k], self.rank * n, n)
        return out

    def gather_state(self, state: dict, dims: dict, part: str) -> dict:
        """This rank's pieces of a layer's new recurrent state -> every
        rank's, whole along ``dims`` as ``own_state`` cut them, in ONE
        all-gather over "model" (the leaves packed in fp32, each returned
        in its own dtype; no gradient).  Identity where the part runs
        whole or on one rank."""
        if self.group is None or not self.split[part]:
            return state
        names = list(state)
        flat = torch.cat([state[k].detach().float().reshape(-1)
                          for k in names])
        every = _all_gather(flat, 0, self.group, self.size).view(
            self.size, -1)
        out, at = {}, 0
        for k in names:
            t, d = state[k], dims[k]
            n = t.numel()
            piece = every[:, at:at + n].reshape((self.size,) + t.shape)
            out[k] = piece.movedim(0, d).flatten(d, d + 1).to(t.dtype)
            at += n
        return out

    # -- parameters -------------------------------------------------------

    def layer(self, p_local: dict, stack: str | None = None,
              sp: bool = False) -> dict:
        """One layer's pieces (views of the stacked local leaves) -> the
        tensors the layer computes with; ``stack`` names the vlm's
        "self" or "cross" stack, ``sp`` takes the plans of the stream
        split by sequence."""
        plans = self.sp_block_plans if sp else self.block_plans
        return _map2(self._take, p_local,
                     plans if stack is None else plans[stack])

    def leaf(self, path: str, local: torch.Tensor,
             sp: bool = False) -> torch.Tensor:
        """A top-level leaf's piece -> the tensor the step computes with."""
        return self._take(local, (self.sp_plans if sp else self.plans)[path])

    def _take(self, local, plan):
        if not plan.gathers and not local.requires_grad:
            return local
        return _Gather.apply(local, plan, self)

    def reduce(self, g: torch.Tensor, plan: LeafPlan) -> torch.Tensor:
        """This rank's gradient of a computed tensor -> its piece of the
        data mean on the leaf's placements (summed in fp32)."""
        if self._reduce is None:
            raise RuntimeError("TensorParallel built without a data mean "
                               "cannot reduce gradients")
        return self._reduce(g, plan.placements, plan.compute, plan.shape)

    # -- the vocabulary -----------------------------------------------------

    def embed(self, tokens: torch.Tensor, table: torch.Tensor,
              sp: bool = False):
        """Embedding rows of ``tokens`` from this rank's vocab rows of
        ``table`` (zero for the others), summed over "model" (with ``sp``
        reduce-scattered: this rank's rows of the sequence); with the
        vocabulary whole, the table's rows of the tokens (with ``sp``, of
        this rank's tokens only)."""
        import torch.nn.functional as F

        if self.group is None or not self.split["vocab"]:
            return F.embedding((self.own_rows(tokens) if sp
                                else tokens).long(), table)
        v0 = self.vocab_start
        ok = (tokens >= v0) & (tokens < v0 + self.vocab_rows)
        rows = F.embedding(torch.where(ok, tokens - v0, 0).long(), table)
        return self.exit(rows * ok[..., None].to(rows.dtype), "vocab", sp)

    def unembed(self, x: torch.Tensor, table: torch.Tensor,
                sp: bool = False, last: bool = False):
        """The normed stream -> this rank's vocab columns of the logits
        (every column where the vocabulary runs whole), fp32.  With
        ``sp`` ``x`` is this rank's rows (with ``last`` its last row) and
        the logits are every row's (the stream's last position's), by
        ``_RowsUnembed``."""
        from repro_torch.models.layers import unembed

        if sp:
            return _RowsUnembed.apply(x, table, self, last)
        return unembed(self.enter(x, "vocab"), table)

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor):
        """(ce, z) of the reference's ``REPRO_SHARDED_CE`` form from this
        rank's vocab columns ``logits`` [B, S, V/tp] fp32: the max, the
        sum of exponentials and the label's logit reduced over "model",
        each [B, S]."""
        split = self.split["vocab"]
        m = logits.max(dim=-1, keepdim=True).values.detach()
        if split:
            m = self.model_max(m)
        sumexp = torch.exp(logits - m).sum(dim=-1)
        vpos = self.vocab_start + torch.arange(logits.shape[-1],
                                               device=logits.device)
        lab = torch.where(vpos == labels[..., None], logits, 0.0).sum(-1)
        if split:
            sumexp, lab = self.exit(sumexp, "vocab"), self.exit(lab, "vocab")
        lse = torch.log(sumexp) + m[..., 0]
        return (lse - lab).mean(), lse.square().mean()

    # -- decode over the sequence-sharded cache -------------------------------

    def combine(self, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """Merge ranks' attention over their own positions: out [B, KV, G,
        hd] and lse [B, KV, G] per rank -> the attention over all
        positions, in ``out``'s dtype.  The lse's max over ranks first, so
        a rank whose positions are all masked weighs 0."""
        if self.group is None:
            return out
        import torch.distributed as dist

        m = self.model_max(lse)
        w = torch.exp(lse - m)
        acc = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
        dist.all_reduce(acc, group=self.group)
        return (acc[..., :-1] / acc[..., -1:]).to(out.dtype)

    def seq_layout(self, k: torch.Tensor, length: int, seq_split: bool):
        """A layer's prompt K (or V) [B, S, KVl, hd] of this rank's heads
        -> this rank's rows of the cache [B, length/tp, KV, hd] (every
        head at this rank's positions; an all-to-all over "model"), or
        [B, length, KV, hd] when the cache is not split by sequence.  Rows
        past the prompt are zeros, as ``init_decode_state`` leaves them."""
        import torch.distributed as dist

        B, S, KVl, hd = k.shape
        heads_split = self.group is not None and self.split["attn"]
        if not seq_split or self.size == 1:
            full = k.new_zeros((B, length, KVl, hd))
            full[:, :S] = k
            return self.gather_heads(full) if heads_split else full
        rows = length // self.size
        if not heads_split:
            lo = self.rank * rows
            out = k.new_zeros((B, rows, KVl, hd))
            n = max(min(S - lo, rows), 0)
            out[:, :n] = k[:, lo:lo + n]
            return out
        send = k.new_zeros((self.size, B, rows, KVl, hd))
        for j in range(self.size):
            n = max(min(S - j * rows, rows), 0)
            if n:
                send[j, :, :n] = k[:, j * rows:j * rows + n]
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        # recv[i]: rank i's heads at this rank's positions
        return recv.permute(1, 2, 0, 3, 4).reshape(B, rows, self.size * KVl,
                                                   hd)


class Collective(NamedTuple):
    """One collective call: the op, its group's name, and the shape and
    bytes of each tensor argument."""
    op: str
    group: str | None
    shapes: list
    nbytes: list


class CollectiveLog(TorchDispatchMode):
    """Records every collective dispatched while the mode is on, in
    ``calls``: ``torch.distributed``'s own calls (c10d) and DTensor's
    (functional collectives) alike."""

    def __init__(self):
        super().__init__()
        self.calls: list[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace in ("c10d", "_c10d_functional"):
            group, shapes, nbytes = None, [], []
            for a in list(args) + list((kwargs or {}).values()):
                for t in (a if isinstance(a, (list, tuple)) else [a]):
                    if isinstance(t, torch.Tensor):
                        shapes.append(list(t.shape))
                        nbytes.append(t.numel() * t.element_size())
                    elif isinstance(t, str) and group is None:
                        group = t
                    elif type(t).__name__ == "ScriptObject" and \
                            "ProcessGroup" in str(t._type()):
                        group = torch._C._distributed_c10d.ProcessGroup \
                            .unbox(t).group_name
            self.calls.append(Collective(str(func), group, shapes, nbytes))
        return func(*args, **(kwargs or {}))


def _replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()


def _partial():
    from torch.distributed.tensor import Partial
    return Partial()


def _map2(fn, tree, plans):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, plans[k]) for k, v in tree.items()}
    return fn(tree, plans)


def local_tree(tree):
    """Every DTensor leaf's local piece (no communication)."""
    from repro_torch.sharding.specs import map_leaves
    return map_leaves(lambda t: t.to_local(), tree)
