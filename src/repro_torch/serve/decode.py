"""Serving steps (port of ``repro.serve.decode``): ``make_decode_fn`` and
``make_prefill_fn`` (plain functions, as the reference's), the tiered
decode step against one store (``make_tiered_decode_step``), the
chunked-prefill step (``make_chunk_prefill_fn``), and ``StepGraphs``,
which plays the part of ``jax.jit`` for the serving steps: each step is
captured once as a CUDA graph and then replayed.

The sharded serving steps (``jit_decode``, ``jit_prefill``; the names
are the reference's) run on a ``DeviceMesh``: parameters laid out by
their logical axes, the decode state by ``decode_state_shardings`` (the
caches' lanes over the data axes, their positions over "model"), the
inputs by ``batch_shardings``.  They compute tensor parallel
(``sharding/tensor_parallel.py``): each rank runs its heads, MLP columns
(or experts), Mamba channels and vocab columns on its lanes, each
layer's pieces gathered over the data axes only; prefill lays each
layer's K/V out by sequence, and decode attends each rank's own
positions and merges the pieces by their log-sum-exp, so the cache never
moves (the vlm's image K/V stay whole over "model", as the reference
lays them out, and each rank reads its KV heads of them); the recurrent
states stay whole over "model", each rank stepping its channels or
heads of them and gathering the new pieces."""

from __future__ import annotations

import gc
import importlib
import time
from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch._scatter import on_device
from repro_torch.serve import tiered as srv
from repro_torch.tiered import kvcache as tk

PATHS = ("zero_copy", "fused", "concat")

# every wrapper's launch counters (module, names): a replay runs no Python,
# so ``StepGraphs`` books each graph's launches itself
LAUNCH_COUNTERS = (
    ("repro_torch.kernels.paged_attention.ops",
     ("launches", "split_launches", "unified_launches")),
    ("repro_torch.kernels.flash_attention.ops", ("launches", "bwd_launches")),
    ("repro_torch.kernels.remap_gather.ops", ("launches", "replay_launches")),
    ("repro_torch.kernels.irt_lookup.ops", ("launches", "walk2_launches")),
)
# state leaves updated in place by every step: a step must hand them back
# as the same tensors (a pool is never copied on a step)
POOL_LEAVES = frozenset(("fast_k", "fast_v", "slow_k", "slow_v", "k", "v"))


def make_decode_fn(cfg):
    """fn(params, state, tokens [B]) -> (logits [B, vocab], state): one
    decode step over the dense caches (``models.decode_step``)."""
    from repro_torch.models import decode_step

    def fn(params, state, tokens):
        return decode_step(cfg, params, state, tokens)
    return fn


def make_prefill_fn(cfg, shape):
    """fn(params, batch) -> (last-position logits [B, vocab], state) with
    the caches padded to ``shape.seq_len`` (no other position is
    unembedded); an encoder's fn returns the logits over every frame."""
    from repro_torch.models import forward, prefill

    if cfg.is_encoder:
        def encode(params, batch):
            logits, _, _ = forward(cfg, params, batch)
            return logits
        return encode

    def fn(params, batch):
        logits, state = prefill(cfg, params, batch, max_len=shape.seq_len,
                                last=True)
        return logits[:, -1], state
    return fn


# ---------------------------------------------------------------------------
# sharded steps
# ---------------------------------------------------------------------------

def _cache_axes(path: str, ndim: int) -> tuple:
    """A decode-state leaf's logical axes: KV caches' lanes over
    "batch" and positions over "seq", image K/V and recurrent states
    lanes only."""
    leaf = path.split("/")[-1]
    if leaf in ("k", "v"):
        if ndim == 6:     # vlm: [ns, inner, B, S, KV, hd]
            return ("layers", None, "batch", "seq", None, None)
        return ("layers", "batch", "seq", None, None)
    if leaf in ("ik", "iv"):                    # image KV: [ns,B,T,KV,hd]
        return ("layers", "batch", None, None, None)
    return ("layers", "batch") + (None,) * (ndim - 2)


def _state_axes(state) -> Any:
    """The decode state's tree of logical axes: ``pos`` replicated, as
    the reference's; each cache leaf by ``_cache_axes``."""
    from repro_torch.models import DecodeState

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        return () if node.dim() == 0 else _cache_axes(path, node.dim())
    return DecodeState((), walk(state.caches, "caches"))


def decode_state_shardings(cfg, state_abs, mesh):
    """``NamedSharding`` tree matching a ``DecodeState``."""
    from repro_torch.sharding.specs import NamedSharding, map_leaves, spec_for

    return map_leaves(
        lambda ax, leaf: NamedSharding(mesh, spec_for(
            ax, mesh=mesh, shape=tuple(leaf.shape))),
        _state_axes(state_abs), state_abs)


def batch_shardings(batch_specs: dict, mesh) -> dict:
    """Every input's rows over "batch"."""
    from repro_torch.sharding.specs import NamedSharding, spec_for

    return {k: NamedSharding(mesh, spec_for(
        ("batch",) + (None,) * (len(v.shape) - 1), mesh=mesh,
        shape=tuple(v.shape))) for k, v in batch_specs.items()}


class _Split(NamedTuple):
    """A split serving step's layout: the ``TensorParallel``, this rank's
    lanes [lo, hi), whether the caches hold this rank's positions only,
    and the logits' placements as computed."""
    tp: Any
    lo: int
    hi: int
    seq_split: bool
    logits_pl: tuple


def _split(cfg, mesh, params_abs, lanes_sh, B: int, s_sh, what: str,
           vocab_dim: int = 1):
    """The split step on ``mesh`` (``TensorParallel``).  Each rank
    computes its own lanes; an MoE dispatch ranks them after the earlier
    ranks' lanes (``moe.moe_ffn_split``).  The caches are split by
    sequence when "model" shards their "seq" dimension (the third from
    last: [L, B, S, KV, hd], the vlm's [ns, inner, B, S, KV, hd]);
    ``s_sh`` None (the encoder) or without "k" (the xLSTM) has no KV
    caches.  The logits' vocabulary is their dimension ``vocab_dim``."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import abstract_params_and_axes
    from repro_torch.sharding import specs
    from repro_torch.sharding.tensor_parallel import TensorParallel

    p_sh = specs.tree_shardings(abstract_params_and_axes(cfg)[1], mesh,
                                params_abs)
    tp = TensorParallel(cfg, mesh, p_sh, params_abs,
                        rows=lanes_sh.placements)
    tp.warn_whole(what)
    lo, hi = specs.shard_range(lanes_sh.placements, mesh, B)
    seq_split = False
    if s_sh is not None and "k" in s_sh.caches and tp.size > 1:
        k = s_sh.caches["k"]
        seq_split = k.placements[tp.m].is_shard(len(k.spec) - 3)
    logits_pl = tuple(
        Shard(0) if pl.is_shard() else
        Shard(vocab_dim) if i == tp.m and tp.split["vocab"] else Replicate()
        for i, pl in enumerate(lanes_sh.placements))
    return _Split(tp, lo, hi, seq_split, logits_pl)


def jit_decode(cfg, shape, mesh):
    """The decode step on ``mesh``: returns (step, (params_abs,
    state_abs, tokens_abs)), as the reference's.  step(params, state,
    tokens) takes DTensors (params on their logical axes' shardings, the
    state on ``decode_state_shardings``, tokens [B] over "batch") and
    returns (logits [B, vocab] over ("batch", "vocab"), the new state on
    the state's shardings).  The state is donated, as the reference's
    is: its pieces may be updated in place.

    The step is split (``models.decode_step(tp=...)``): no parameter
    piece leaves its "model" rank (the hybrid's ``in_proj`` products
    are exchanged, ``TensorParallel.ssm_in``), the caches are updated in
    place on the rank that holds each position (a ring cache's slot
    ``pos % W``), and the recurrent states in place on every rank; the
    encoder's step raises when called, as the reference's does."""
    from repro_torch.models import (abstract_decode_state,
                                    abstract_params_and_axes)
    from repro_torch.sharding.specs import NamedSharding, spec_for

    params_abs, _ = abstract_params_and_axes(cfg)
    state_abs = abstract_decode_state(cfg, shape)
    s_sh = decode_state_shardings(cfg, state_abs, mesh)
    B = shape.global_batch
    t_abs = torch.empty((B,), dtype=torch.int32, device="meta")
    t_sh = NamedSharding(mesh, spec_for(("batch",), mesh=mesh, shape=(B,)))
    logits_sh = NamedSharding(mesh, spec_for(
        ("batch", "vocab"), mesh=mesh, shape=(B, cfg.vocab)))
    split = _split(cfg, mesh, params_abs, t_sh, B, s_sh, "jit_decode")
    return _split_decode(cfg, mesh, split, s_sh, logits_sh, B), (
        params_abs, state_abs, t_abs)


def _split_decode(cfg, mesh, split: _Split, s_sh, logits_sh, B: int):
    from repro_torch.models import DecodeState, decode_step
    from repro_torch.sharding.specs import distribute_local, map_leaves
    from repro_torch.sharding.tensor_parallel import local_tree

    def step(params, state, tokens):
        pos = state.pos.to_local()                 # replicated [B]
        logits, _ = decode_step(
            cfg, local_tree(params), DecodeState(
                pos[split.lo:split.hi], map_leaves(lambda t: t.to_local(),
                                                   state.caches)),
            tokens.to_local(), tp=split.tp, seq_split=split.seq_split)
        logits = distribute_local(logits, mesh, split.logits_pl,
                                  (B, cfg.vocab)).redistribute(
            mesh, logits_sh.placements)
        return logits, DecodeState(distribute_local(
            pos + 1, mesh, s_sh.pos.placements, (B,)), state.caches)
    return step


def jit_prefill(cfg, shape, mesh):
    """The prefill step on ``mesh``: returns (step, (params_abs,
    input_specs)), as the reference's.  step(params, batch) takes
    DTensors (the batch over "batch"; prompts of up to ``shape.seq_len``
    tokens, the caches padded to it as ``make_prefill_fn`` pads them, so
    ``jit_decode`` at the same shape continues them) and returns
    (last-position logits [B, vocab] over ("batch", "vocab"), the decode
    state on ``decode_state_shardings``); an encoder's step returns its
    logits [B, S, vocab] over ("batch", None, "vocab").  The step is
    split (``models.prefill(tp=...)``, the encoder's
    ``models.forward(tp=...)``): each rank's K/V heads go to the ranks
    that hold their positions, one layer at a time; the recurrent
    families return the reference's cold state (``pos`` 0).  Where the
    prompt's length divides the "model" size a rank holds its own S/m
    rows of the residual stream between the split products, [B/dp, S/m,
    d] (``TensorParallel.splits_sequence``), and the gathered input of
    each layer's products, [B/dp, S, d], only while they run."""
    from repro_torch.models import (abstract_decode_state,
                                    abstract_params_and_axes, input_specs)
    from repro_torch.sharding.specs import NamedSharding, spec_for

    params_abs, _ = abstract_params_and_axes(cfg)
    specs_in = input_specs(cfg, shape)
    b_sh = batch_shardings(specs_in, mesh)
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder:
        out_sh = NamedSharding(mesh, spec_for(
            ("batch", None, "vocab"), mesh=mesh, shape=(B, S, cfg.vocab)))
        split = _split(cfg, mesh, params_abs, next(iter(b_sh.values())), B,
                       None, "jit_prefill", vocab_dim=2)
        return _split_encode(cfg, mesh, split, out_sh), (params_abs,
                                                         specs_in)

    state_abs = abstract_decode_state(cfg, shape)
    s_sh = decode_state_shardings(cfg, state_abs, mesh)
    logits_sh = NamedSharding(mesh, spec_for(
        ("batch", "vocab"), mesh=mesh, shape=(B, cfg.vocab)))
    split = _split(cfg, mesh, params_abs, next(iter(b_sh.values())), B,
                   s_sh, "jit_prefill")
    return _split_prefill(cfg, mesh, split, s_sh, state_abs, logits_sh,
                          shape), (params_abs, specs_in)


def _split_encode(cfg, mesh, split: _Split, out_sh):
    """The encoder's split step: ``models.forward(tp=...)`` on this
    rank's lanes -> the logits over every frame, this rank's vocab
    columns, laid out on ``out_sh``."""
    from repro_torch.models import forward
    from repro_torch.sharding.specs import distribute_local
    from repro_torch.sharding.tensor_parallel import local_tree

    def encode(params, batch):
        logits, _, _ = forward(cfg, local_tree(params), {
            k: v.to_local() for k, v in batch.items()}, tp=split.tp)
        B, S = batch["embeds"].shape[:2]
        return distribute_local(logits, mesh, split.logits_pl,
                                (B, S, cfg.vocab)).redistribute(
            mesh, out_sh.placements)
    return encode


def _split_prefill(cfg, mesh, split: _Split, s_sh, state_abs, logits_sh,
                   shape):
    from repro_torch.models import DecodeState, prefill
    from repro_torch.models.transformer import COLD_PREFILL
    from repro_torch.sharding.specs import distribute_local, map_leaves
    from repro_torch.sharding.tensor_parallel import local_tree

    B = shape.global_batch
    # the recurrent families' state is cold: it starts at position 0
    cold = cfg.family in COLD_PREFILL

    def step(params, batch):
        local = {k: v.to_local() for k, v in batch.items()}
        tokens = local["tokens"]
        logits, st = prefill(cfg, local_tree(params), local,
                             max_len=shape.seq_len, tp=split.tp,
                             seq_split=split.seq_split)
        logits = distribute_local(logits[:, -1], mesh, split.logits_pl,
                                  (B, cfg.vocab)).redistribute(
            mesh, logits_sh.placements)
        pos = torch.full((B,), 0 if cold else tokens.shape[1],
                         dtype=torch.int32, device=tokens.device)
        state = DecodeState(pos, st.caches)
        return logits, map_leaves(
            lambda t, sh, ab: distribute_local(t, mesh, sh.placements,
                                               ab.shape),
            state, s_sh, state_abs)
    return step


def _counts() -> dict:
    return {(m, a): getattr(importlib.import_module(m), a)
            for m, names in LAUNCH_COUNTERS for a in names}


def _book(counts: dict, sign: int = 1) -> None:
    for (m, a), n in counts.items():
        if n:
            mod = importlib.import_module(m)
            setattr(mod, a, getattr(mod, a) + sign * n)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _leaf_name(path) -> str:
    k = path[-1] if path else None
    return str(getattr(k, "name", getattr(k, "key", "")))


class _Graph(NamedTuple):
    """One captured step: the graph, its static inputs, its outputs (kept
    alive; read before the next replay), the launches it makes and the
    seconds its capture took."""
    graph: Any
    args: list
    out: Any
    counts: dict
    seconds: float


class StepGraphs:
    """Serving steps captured once per key as CUDA graphs and replayed,
    over one set of static state buffers (``bind``).

    ``run(key, fn, state, *args)`` runs ``fn(state, *args) -> (out,
    new_state)``, where ``new_state`` has ``state``'s structure.  The
    first call of a key runs ``fn`` eagerly as the real step, on the
    runner's side stream (which loads the kernel libraries, makes that
    stream's cuBLAS handle and the paged kernels' counters outside any
    capture), writes ``new_state`` back into the static buffers, then
    captures ``fn`` on the same stream with the write-back inside the
    graph; later calls replay it.  The runner writes only into buffers
    it owns: the bound state, tensors handed to ``own``, its graphs'
    outputs and static arguments.  At capture an argument it owns is the
    graph's static input as it stands, any other is cloned into one.
    Before each call every leaf of ``state`` and ``args`` whose storage
    differs from its static buffer is copied in (the scheduler and the
    eager steps replace leaves between steps); the caller gets the static
    buffers back as the new state.  A pool leaf (``POOL_LEAVES``) must
    come back as the same tensor, else the capture raises: a pool is
    never copied on a step.  Each graph's outputs are its own buffers,
    overwritten by its next replay.  Every graph of the runner shares one
    memory pool.  The wrappers' launch counters count a replay as the
    eager step would.  A capture that fails raises; nothing falls back to
    the eager step.  Python's cyclic collector is off during a capture: a
    graph destroyed mid-capture invalidates the capture, and a collection
    there would finalize any unreachable cycle that holds graphs.  Engines
    once were such cycles (each scheduler held its engine, and two
    callbacks on the engine captured it), so only the collector freed
    them; the schedulers now hold a ``weakref.proxy`` and the callbacks
    reach the engine weakly, so ``del engine`` frees its graphs, their
    pool and its KV pools at once (``tests/test_torch_engine_lifetime.py``).

    ``enabled`` None: graphs on a card, the eager step on the CPU (there
    are no graphs there); False: always eager; True on the CPU raises."""

    def __init__(self, device, enabled: bool | None = None):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        if enabled and not cuda:
            raise ValueError(f"CUDA graphs need a card; the device is "
                             f"{self.device}")
        self.enabled = cuda if enabled is None else bool(enabled)
        self.graphs: dict = {}
        self.pool_bytes = 0               # the graph pool's reserved bytes
        self._static = None               # (leaves, names, spec)
        self._owned: dict = {}            # data_ptr -> a buffer it owns
        if self.enabled:
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    @property
    def captures(self) -> int:
        return len(self.graphs)

    @property
    def capture_seconds(self) -> dict:
        return {k: g.seconds for k, g in self.graphs.items()}

    def bind(self, state):
        """Make ``state``'s tensors the static buffers every graph reads
        and writes (once); later binds copy ``state`` into them.  Returns
        the static state."""
        flat, spec = pytree.tree_flatten_with_path(state)
        leaves = [t for _, t in flat]
        if self._static is None:
            self._static = (leaves, [_leaf_name(p) for p, _ in flat], spec)
            for t in leaves:
                self.own(t)
        else:
            self._fill(self._static[0], leaves, "state")
        return self.state

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """Hand ``t`` to the runner: a graph may take it as a static input
        as it stands (the engine's token buffer, the server's ``pos``)."""
        if isinstance(t, torch.Tensor):
            self._owned[t.data_ptr()] = t
        return t

    @property
    def state(self):
        leaves, _, spec = self._static
        return pytree.tree_unflatten(leaves, spec)

    @staticmethod
    def _fill(static, leaves, what):
        if len(static) != len(leaves):
            raise ValueError(f"StepGraphs: the {what} has {len(leaves)} "
                             f"leaves, its static buffers {len(static)}")
        for s, t in zip(static, leaves):
            if not isinstance(t, torch.Tensor):
                if t != s:
                    raise ValueError(f"StepGraphs: a non-tensor {what} leaf "
                                     f"changed ({s!r} -> {t!r})")
                continue
            if t.shape != s.shape or t.dtype != s.dtype:
                raise ValueError(
                    f"StepGraphs: a {what} leaf changed from {s.dtype} "
                    f"{tuple(s.shape)} to {t.dtype} {tuple(t.shape)}")
            if t.data_ptr() != s.data_ptr():
                s.copy_(t)

    def _write_back(self, new_state):
        """Copy the step's new state leaves into the static buffers (inside
        the capture when capturing)."""
        leaves, names, spec = self._static
        flat, new_spec = pytree.tree_flatten(new_state)
        if new_spec != spec:
            raise ValueError("StepGraphs: the step returned a state of "
                             "another structure")
        storage = {_storage(s) for s in leaves if s.numel()}
        for s, t, name in zip(leaves, flat, names):
            if t.numel() == 0 or (t.data_ptr() == s.data_ptr()
                                  and t.shape == s.shape):
                continue
            if name in POOL_LEAVES:
                raise RuntimeError(
                    f"StepGraphs: the step returned pool leaf {name!r} as a "
                    f"new tensor; a pool must be updated in place, never "
                    f"copied on a step")
            if _storage(t) in storage:
                raise RuntimeError(
                    f"StepGraphs: the step returned leaf {name!r} as a view "
                    f"of a static buffer")
            s.copy_(t)

    def run(self, key, fn, state, *args):
        """``fn(state, *args)`` through the graph of ``key`` -> (out,
        state): the static state when graphs are on."""
        if not self.enabled:
            return fn(state, *args)
        if self._static is None:
            self.bind(state)
        else:
            self._fill(self._static[0], pytree.tree_leaves(state), "state")
        g = self.graphs.get(key)
        if g is None:
            return self._capture(key, fn, args)
        arg_leaves = pytree.tree_leaves(args)
        self._fill(g.args, arg_leaves, "argument")
        g.graph.replay()
        _book(g.counts)
        return g.out, self.state

    def _capture(self, key, fn, args):
        leaves, spec = pytree.tree_flatten(args)
        static_args = [self.own(t if not isinstance(t, torch.Tensor)
                                or t.data_ptr() in self._owned
                                else t.clone()) for t in leaves]
        args = pytree.tree_unflatten(static_args, spec)
        state = self.state
        cur = torch.cuda.current_stream(self.device)
        s = self._stream
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            out_eager, new = fn(state, *args)     # the real step
            self._write_back(new)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=s,
                                  capture_error_mode="thread_local"):
                out, new = fn(state, *args)
                self._write_back(new)
        finally:
            if collecting:
                gc.enable()
        seconds = time.perf_counter() - t0
        after = _counts()
        counts = {k: after[k] - before[k] for k in after}
        _book(counts, -1)                 # the capture launched nothing
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        with torch.cuda.stream(s):        # this call's outputs: the step's
            for a, b in zip(_tensors(out), _tensors(out_eager)):
                a.copy_(b)
        cur.wait_stream(s)
        for t in _tensors(out):
            self.own(t)
        self.graphs[key] = _Graph(graph, static_args, out, counts, seconds)
        return out, self.state


def make_tiered_decode_step(tcfg: tk.TieredConfig, *,
                            path: str = "zero_copy",
                            n_pages: int | None = None):
    """One decode step against the store: append this step's K/V token per
    lane, then read attention through the translated page table.

    ``path`` (all give the same output on live lanes):
      "zero_copy"  cached device table + split-pool kernel, no pool byte
                   moves (the production path);
      "fused"      one fused append+attend kernel (``srv.attend_tokens``);
      "concat"     the legacy baseline: full re-translation + unified-pool
                   concatenation per step (pair with
                   ``cache_device_table=False``).

    Returned signature: step(state, q, k_new, v_new, pos) -> (out, state)
    with q [B, KV, G, hd], k_new/v_new [B, KV, hd] and ``pos`` a Python
    int or an int tensor on the state's device, scalar or [B]
    (seq_lens = max(pos + 1, 0): a negative lane reads nothing).  With
    ``path="fused"`` a token axis may ride second (q [B, K, KV, G, hd],
    k_new/v_new [B, K, KV, hd]).  ``n_pages`` (fused only) is the
    live-page bucket."""
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r}; want one of {PATHS}")
    if path == "fused":
        def fused_step(st, q, k_new, v_new, pos):
            if q.dim() == 4:            # k = 1 with the flat signature
                q, k_new, v_new = q[:, None], k_new[:, None], v_new[:, None]
            return srv.attend_tokens(tcfg, st, q, k_new, v_new, pos,
                                     n_pages=n_pages)
        return fused_step
    if n_pages is not None:
        raise ValueError(
            f"n_pages (live-page bucket) only applies to path='fused'; "
            f"got path={path!r}")
    read = srv.attend if path == "zero_copy" else srv.attend_concat

    def step(st, q, k_new, v_new, pos):
        dev = st.leaf_table.device
        pos = on_device(pos, torch.int32, dev)
        seqs = torch.arange(tcfg.n_seqs, dtype=torch.int32, device=dev)
        st = tk.append_token(tcfg, st, seqs, k_new, v_new, pos)
        seq_lens = torch.clamp(pos + 1, min=0).expand(tcfg.n_seqs)
        return read(tcfg, st, q, seq_lens.contiguous())

    return step


def make_chunk_prefill_fn(cfg, *, logits: bool = False):
    """One chunked-prefill step (DESIGN.md §9): step(params, chunk_tokens
    [B, C] (array or tensor), buf_k, buf_v, start) -> (buf_k, buf_v),
    plus the chunk's logits [B, C, vocab] with ``logits=True``.  The
    buffers [L, B, P, KV, hd] (``models.init_chunk_buffers``) are padded
    to the length P the one-shot prefill would run at, and rows
    [start, start + C) are written in place (``models.forward_chunk``)."""
    from repro_torch.models.transformer import forward_chunk

    def step(params, chunk_tokens, buf_k, buf_v, start):
        tokens = torch.as_tensor(chunk_tokens, device=buf_k.device)
        return forward_chunk(cfg, params, tokens, buf_k, buf_v, start,
                             return_logits=logits)

    return step
