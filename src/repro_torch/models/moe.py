"""Mixture-of-Experts FFN with sort-based token dispatch (port of
``repro.models.moe``).

Token-choice top-k routing: each token's k experts come from an fp32
router, each (token, choice) takes the next free row of its expert's
fixed-capacity buffer [E, C, d] (dropped on overflow), the experts run
as batched SwiGLU matrix products over [E, C, d], and the outputs
combine weighted by the renormalised router probabilities.

The capacity ``C`` follows from the token count of the call (``capacity``),
so which tokens drop depends on everything the call routes: parked
decode lanes and prefill padding included, as in the reference.  Nothing
here waits for the card: the scatter into the buffers is an
``index_add_`` whose kept rows are unique (exact), and the dropped rows
all land in one sink row past the end.
"""

from __future__ import annotations

import os
import warnings

import torch
import torch.nn.functional as F

from repro_torch._scatter import top_k
from repro_torch.configs.base import ArchConfig
from repro_torch.device import torch_dtype

from .layers import stacked_init


def moe_init(g: torch.Generator, cfg: ArchConfig, device, cut=None) -> dict:
    """Seeded layer-stacked experts in the reference's layout: ``router``
    [L, d, E] in fp32 (as the reference keeps it), ``w_gate``/``w_up``
    [L, E, d, ff] and ``w_down`` [L, E, ff, d] in ``cfg.dtype``, each
    scaled by 1/sqrt of its contracted input size.  ``cut`` (a leaf's
    path -> the piece of one layer kept, ``transformer.init_params``)
    keeps a rank's piece of each layer as it is drawn."""
    d, ff, E, L = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_layers
    dt = torch_dtype(cfg.dtype)

    def draw(name, shape, dtype, fan_in):
        piece = cut(f"blocks/moe/{name}") if cut is not None else None
        return stacked_init(g, L, shape, dtype, device, fan_in, piece=piece)
    return {"router": draw("router", (d, E), torch.float32, d),
            "w_gate": draw("w_gate", (E, d, ff), dt, d),
            "w_up": draw("w_up", (E, d, ff), dt, d),
            "w_down": draw("w_down", (E, ff, d), dt, ff)}


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Rows per expert for a call routing ``n_tokens`` tokens: the
    expected load times ``capacity_factor``, up to a multiple of 8, at
    least 8."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(-(-c // 8) * 8, 8)


def _gates(logits, k: int):
    """Router logits [T, E] fp32 -> (probs [T, E], gate [T, K], eidx [T,
    K] int64): the softmax, its top k (ties to the lower expert, as
    ``jax.lax.top_k``) renormalised."""
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = top_k(probs, k)
    return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), eidx


def _shares(probs, eidx, n_experts: int):
    """(share of the tokens whose first choice is each expert, mean
    probability of each expert), each [E]."""
    experts = torch.arange(n_experts, device=eidx.device)
    return (eidx[:, :1] == experts).float().mean(0), probs.mean(0)


def route(p, xf, cfg: ArchConfig):
    """xf [T, d] -> (gate [T, K] fp32, eidx [T, K] int64, aux): the fp32
    router's gates (``_gates``) and the Switch load-balancing loss
    E * sum_e(share of tokens whose first choice is e * mean prob of e)."""
    probs, gate, eidx = _gates(xf.float() @ p["router"], cfg.top_k)
    frac, mean_p = _shares(probs, eidx, cfg.n_experts)
    return gate, eidx, cfg.n_experts * (frac * mean_p).sum()


def dispatch(eidx, n_experts: int, cap: int, offset=None):
    """eidx [T, K] -> (slot [T*K] int64, keep [T*K] bool): each
    (token, choice), in token-major order, takes the next row of its
    expert; a choice past ``cap`` rows is dropped to the sink slot
    ``E * cap``.  The rank within an expert comes from a stable sort of
    the flat expert ids, the expert's first row from ``searchsorted``.
    ``offset`` [E] (the choices that earlier data ranks routed to each
    expert) shifts every rank, so that a rank's piece of a batch takes
    the rows the whole batch's ranking gives it."""
    flat_e = eidx.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    experts = torch.arange(n_experts, device=eidx.device)
    first = torch.searchsorted(sorted_e, experts, right=False)
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(flat_e.numel(), device=eidx.device) \
        - first[sorted_e]
    if offset is not None:
        pos = pos + offset[flat_e]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, n_experts * cap)
    return slot, keep


def _experts(p, xs, gate, slot, keep, cap: int, n_experts: int,
             reduce=None):
    """Tokens xs [T, d] through ``n_experts`` experts' buffers of ``cap``
    rows: each (token, choice) row scattered to its ``slot`` (the sink
    ``n_experts * cap`` when not ``keep``), the batched SwiGLU products
    (their output passed through ``reduce`` when given), and the outputs
    combined by ``gate`` [T, K] -> [T, d]."""
    T, d = xs.shape
    K = gate.shape[1]
    rows = xs[:, None].expand(T, K, d).reshape(T * K, d)   # each row K times
    buf = torch.zeros((n_experts * cap + 1, d), dtype=xs.dtype,
                      device=xs.device)
    h = buf.index_add_(0, slot, rows)[:n_experts * cap].view(n_experts, cap,
                                                             d)
    g = F.silu(torch.bmm(h, p["w_gate"].to(xs.dtype)))
    u = torch.bmm(h, p["w_up"].to(xs.dtype))
    y = torch.bmm(g * u, p["w_down"].to(xs.dtype)).view(n_experts * cap, d)
    if reduce is not None:
        y = reduce(y)
    gathered = y[slot.clamp(max=n_experts * cap - 1)] \
        * keep[:, None].to(xs.dtype)
    return (gathered.view(T, K, d) * gate.view(T, K, 1).to(xs.dtype)).sum(1)


def _moe_tokens(p, xf, cfg: ArchConfig):
    """xf [T, d] -> (y [T, d], aux)."""
    E = cfg.n_experts
    C = capacity(cfg, xf.shape[0])
    gate, eidx, aux = route(p, xf, cfg)
    slot, keep = dispatch(eidx, E, C)
    return _experts(p, xf, gate, slot, keep, C, E), aux


def groups() -> int:
    """``REPRO_MOE_GROUPS`` (0 when unset), read at each call as the
    reference reads it at each trace."""
    return int(os.environ.get("REPRO_MOE_GROUPS", "0"))


def data_shards(cfg: ArchConfig, n: int, rows: int) -> int:
    """How many pieces a call over ``rows`` rows, split in ``n`` equal
    data shards, computes apart while giving the reference's values:
    ``n`` when ``n`` divides ``rows`` (an MoE dispatch ranks each rank's
    choices after the earlier ranks', ``moe_ffn_split``).  Else 1: every
    rank computes every row, n times the work and the activations, and a
    warning says so."""
    if n == 1 or rows % n == 0:
        return n
    warnings.warn(f"{cfg.name}: every one of {n} data ranks computes the "
                  f"whole batch ({rows} rows do not split over {n} data "
                  f"ranks)", stacklevel=2)
    return 1


def moe_ffn(p, x, cfg: ArchConfig):
    """x [B, S, d] -> (y [B, S, d], aux loss, a 0-d fp32 tensor).  All
    B*S tokens route together, as the reference routes them; with
    ``REPRO_MOE_GROUPS`` = G > 1 dividing B, each of G groups of B / G
    rows routes on its own (its own capacity, its own ranks) and aux is
    the groups' mean, as the reference's grouped dispatch."""
    B, S, d = x.shape
    G = groups()
    if G > 1 and B % G == 0:
        xg = x.reshape(G, (B // G) * S, d)
        ys, auxs = zip(*(_moe_tokens(p, xg[i], cfg) for i in range(G)))
        return torch.stack(ys).reshape(B, S, d), torch.stack(auxs).mean()
    y, aux = _moe_tokens(p, x.reshape(B * S, d), cfg)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# the split layer: this rank's rows, this rank's experts (or d_ff columns)
# ---------------------------------------------------------------------------

def _segments(Bl: int, n: int, idx: int, B_group: int) -> list:
    """This rank's rows [idx Bl, (idx + 1) Bl) of the call's n Bl rows cut
    at the routing groups' edges (groups of ``B_group`` rows): a list of
    (group, first local row, end local row)."""
    out, r, end = [], idx * Bl, (idx + 1) * Bl
    while r < end:
        g = r // B_group
        e = min(end, (g + 1) * B_group)
        out.append((g, r - idx * Bl, e - idx * Bl))
        r = e
    return out


def _router_logits(p, h, tp):
    """h [T, d] -> logits [T, E] fp32 over every expert.  Split by
    expert, each rank's router columns give its experts' logits, and the
    smaller of the logits [T, E/m] and the router piece [d, E/m] is
    gathered over "model"; its backward sums the ranks' gradients
    (``tp.gather_model``)."""
    if tp.moe_mode != "expert":
        return h.float() @ p["router"]
    if h.shape[0] < h.shape[1]:
        return tp.gather_model(h.float() @ p["router"], -1)
    return h.float() @ tp.gather_model(p["router"], -1)


def moe_ffn_split(p, x, cfg: ArchConfig, tp, *, aux: bool = True,
                  sp: bool = False):
    """``moe_ffn`` on this rank's rows x [Bl, S, d] and this rank's piece
    of the layer ``p``, with ``tp`` a ``TensorParallel`` of mode
    ``tp.moe_mode``: "expert" (this rank's E/m experts), "mlp" (every
    expert on its d_ff/m columns) or None (the whole layer).  Returns (y
    [Bl, S, d], summed over "model", and with ``aux`` the load-balancing
    loss, or None); split by expert, aux holds this rank's experts'
    terms only (``tp.moe_aux`` sums them over "model").

    With ``sp`` (the stream split by sequence) ``x`` is this rank's rows
    [Bl, S/m, d]: they are all-gathered first, so the dispatch ranks the
    choices of every token of the sequence as without it, and ``y``
    comes back as this rank's rows of the sum, reduce-scattered.  By
    d_ff column ("mlp") the sum over "model" then runs on the combined
    [Bl, S, d] output, where without ``sp`` it runs on the [E, C, d]
    products: the combine is linear in the products, the reduce-scatter
    moves [Bl, S, d] in place of all-reducing [E, C, d], and each rank's
    gradient stays its own columns' share, router included (the router
    computes on ``Partial``), where cutting a whole combined output
    would hand every rank the whole router gradient, to be summed m
    times over the gathered rows.  For the same reason aux holds this
    rank's share of the experts in every mode (E/m of them, the last
    ranks one fewer where E does not divide), summed over "model".

    The values are the reference's on the whole batch: ``tp.rows`` = (n,
    i) says that the call's n Bl rows lie over n data ranks in rank
    order, this rank holding piece i.  Each routing group (the whole
    batch, or one of ``REPRO_MOE_GROUPS`` = G groups) ranks its (token,
    choice) pairs token-major, so a rank's pairs rank after those of the
    earlier ranks of its group: each rank counts its choices per expert,
    the counts are all-gathered over the data ranks, and an exclusive
    prefix sum over the earlier ranks of the group offsets the rank's own
    ranks (``dispatch``), against the group's capacity.  The kept set and
    the slots are the reference's exactly.  The aux loss takes the
    group's first-choice shares and mean probabilities, sums all-reduced
    over the data ranks (its backward all-reduces too: each rank's loss
    holds the whole aux).  Where every group lies on one rank (one data
    rank, or G a multiple of n dividing the rows) nothing crosses data
    ranks and aux is the rank's groups' mean."""
    h = tp.enter(x, "moe", sp)                 # into the experts
    Bl, S, d = h.shape
    E, K = cfg.n_experts, cfg.top_k
    E_l, e0 = tp.moe_experts
    n, idx = tp.rows
    G = groups()
    B = Bl * n
    B_group = B // G if G > 1 and B % G == 0 else B
    local = n == 1 or Bl % B_group == 0
    cap = capacity(cfg, B_group * S)
    experts = torch.arange(E, device=x.device)
    hr = h if tp.moe_mode == "expert" or sp else x   # into the router
    routed = []
    for g, a, b in _segments(Bl, n, idx, B_group):
        probs, gate, eidx = _gates(_router_logits(
            p, hr[a:b].reshape(-1, d), tp), K)
        routed.append((g, a, b, probs, gate, eidx))
    offsets = {}
    if not local:
        counts = torch.zeros((B // B_group, E), dtype=torch.int64,
                             device=x.device)
        for g, *_, eidx in routed:
            counts[g] = (eidx.reshape(-1, 1) == experts).sum(0)
        every = tp.data_gather(counts)             # [n, groups, E]
        offsets = {g: every[:idx, g].sum(0) for g, *_ in routed}
    # by d_ff column every expert's product is a partial sum over "model"
    reduce = (lambda t: tp.exit(t, "moe")) if tp.moe_mode == "mlp" \
        and not sp else None
    ys = []
    for g, a, b, probs, gate, eidx in routed:
        slot, keep = dispatch(eidx, E, cap, offsets.get(g))
        if E_l < E:          # the other ranks' experts' choices: zeros
            flat_e = eidx.reshape(-1)
            keep = keep & (flat_e >= e0) & (flat_e < e0 + E_l)
            slot = torch.where(keep, slot - e0 * cap, E_l * cap)
        ys.append(_experts(p, h[a:b].reshape(-1, d), gate, slot, keep, cap,
                           E_l, reduce))
    y = torch.cat(ys) if len(ys) > 1 else ys[0]
    if sp:
        y = tp.exit(y.view(Bl, S, d), "moe", sp)
    else:
        if tp.moe_mode == "expert":
            y = tp.exit(y, "moe")
        y = y.view(Bl, S, d)
    if not aux:
        return y, None
    own = slice(e0, e0 + E_l)
    if sp and tp.moe_mode != "expert":
        own = slice(tp.rank * E // tp.size, (tp.rank + 1) * E // tp.size)
    if local:
        auxs = []
        for *_, probs, _, eidx in routed:
            frac, mean_p = _shares(probs, eidx, E)
            auxs.append(E * (frac[own] * mean_p[own]).sum())
        return y, torch.stack(auxs).mean() if len(auxs) > 1 else auxs[0]
    mine = torch.stack([torch.stack([(eidx[:, :1] == experts).float().sum(0),
                                     probs.sum(0)])
                        for *_, probs, _, eidx in routed])
    g0 = routed[0][0]                  # this rank's groups are consecutive
    sums = F.pad(mine, (0, 0, 0, 0, g0, B // B_group - g0 - len(routed)))
    tot = tp.data_sum(sums) / (B_group * S)        # [groups, 2, E]
    return y, (E * (tot[:, 0, own] * tot[:, 1, own]).sum(-1)).mean()
