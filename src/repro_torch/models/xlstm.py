"""xLSTM blocks (port of ``repro.models.xlstm``): mLSTM (matrix memory,
parallelisable) and sLSTM (scalar memory, sequential) with exponential
gating, attention-free.  Prefill runs mLSTM in its chunkwise stabilised
parallel form and sLSTM as a loop over the sequence; decode updates both
one step at a time from an O(1) state per layer.

Every layer carries both branch parameter sets (the reference keeps the
layer stack homogeneous for its scan over layers); a per-layer flag
(``transformer.layer_flags``) picks the branch.  Parameters of one layer
(layer-stacked [L, ...] in the port): ``m_qkv`` [d,3,H,hd], ``m_og`` and
``m_out`` [d,d], ``s_w`` [d,4,H,hd], ``s_out`` [d,d] in ``cfg.dtype``;
``m_if`` [d,2,H], ``m_if_b`` [2,H], ``s_r`` [H,hd,4,hd] and ``s_b``
[4,H,hd] in fp32, as the reference keeps them.

Every function takes the head count from its weights, so under tensor
parallelism (``sharding/tensor_parallel.py``, part "xlstm") it runs this
rank's H/m heads: ``m_og``'s d/m columns are those heads' channels, and
the output is this rank's term of the ``m_out`` / ``s_out`` sum over
"model", which the caller takes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import torch_dtype

from .layers import stacked_const, stacked_init

NEG_INF = -1e30
MLSTM_CHUNK = 1024  # bounds the [B,H,C,C] intra-chunk decay matrices


def xlstm_init(g: torch.Generator, cfg: ArchConfig, device, *, cut=None,
               prefix: str = "blocks/") -> dict:
    """Seeded layer-stacked parameters of both branches in the reference's
    layout and dtypes.  Projections are scaled by 1/sqrt of the
    reference's fan-in, ``shape[-2]``: d for the [d, d] matrices, H for
    ``m_qkv`` [d,3,H,hd] and ``s_w`` [d,4,H,hd]; the fp32
    gate matrices ``m_if`` and ``s_r`` by 0.02 (the reference's scale);
    the gate biases are the reference's constants (mLSTM input/forget 0/3,
    sLSTM z/i/f/o 0/0/3/0).  ``cut`` (``transformer.init_params``'s)
    keeps a piece of each layer's draw, each leaf named by its path
    under ``prefix``: the same draws in the same order."""
    L, d, H = cfg.n_layers, cfg.d_model, cfg.n_heads
    hd = d // H
    dt = torch_dtype(cfg.dtype)
    f32 = torch.float32

    def piece(name):
        return cut(prefix + name) if cut is not None else None

    def stacked(name, shape, dtype=dt, scale=None):
        return stacked_init(g, L, shape, dtype, device, shape[-2],
                            scale=scale, piece=piece(name))

    def const(name, vals, shape):
        v = torch.tensor(vals, dtype=f32, device=device)
        one = v.reshape((len(vals),) + (1,) * (len(shape) - 1)).expand(shape)
        return stacked_const(L, one, piece(name))

    return {"m_qkv": stacked("m_qkv", (d, 3, H, hd)),
            "m_if": stacked("m_if", (d, 2, H), f32, 0.02),
            "m_if_b": const("m_if_b", [0.0, 3.0], (2, H)),
            "m_og": stacked("m_og", (d, d)),
            "m_out": stacked("m_out", (d, d)),
            "s_w": stacked("s_w", (d, 4, H, hd)),
            "s_r": stacked("s_r", (H, hd, 4, hd), f32, 0.02),
            "s_b": const("s_b", [0.0, 0.0, 3.0, 0.0], (4, H, hd)),
            "s_out": stacked("s_out", (d, d))}


def _proj(x, w):
    """einsum("bsd,d...->bs...", x, w) as one matrix product in x's
    dtype."""
    d = w.shape[0]
    return (x @ w.reshape(d, -1).to(x.dtype)).reshape(
        *x.shape[:-1], *w.shape[1:])


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _m_gates(p, x):
    """x [B,S,d] -> i_pre, f_pre [B,S,H], fp32."""
    if_pre = _proj(x.float(), p["m_if"]) + p["m_if_b"]
    return if_pre[:, :, 0], if_pre[:, :, 1]


def mlstm_parallel(p, x):
    """Chunkwise stabilised parallel form, x [B,S,d] -> [B,S,d]: a loop
    over ``MLSTM_CHUNK``-token chunks carries the stabilised matrix memory
    (C~, n~, m) (true values C~ e^m, n~ e^m); within a chunk the quadratic
    masked form.  S must be at most ``MLSTM_CHUNK`` or a multiple of it.
    Scores are taken in x's dtype, then fp32, as the reference does."""
    B, S, _ = x.shape
    qkv = _proj(x, p["m_qkv"])                    # [B,S,3,H,hd]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    H, hd = q.shape[2], q.shape[3]
    i_pre, f_pre = _m_gates(p, x)
    logf = F.logsigmoid(f_pre)
    C = min(MLSTM_CHUNK, S)
    assert S % C == 0
    scale = 1.0 / math.sqrt(hd)
    dev = x.device
    tril = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev))
    Cm = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    hs = []
    for c0 in range(0, S, C):
        sl = slice(c0, c0 + C)
        qc, kc, vc = q[:, sl], k[:, sl], v[:, sl]            # [B,C,H,hd]
        bT = torch.cumsum(logf[:, sl], dim=1).transpose(1, 2)  # [B,H,C]
        iT = i_pre[:, sl].transpose(1, 2)
        # intra-chunk log weights: D[s,t] = b_s - b_t + i_t (t <= s)
        D = bT[:, :, :, None] - bT[:, :, None, :] + iT[:, :, None, :]
        D = torch.where(tril, D, NEG_INF)
        m_intra = D.amax(-1)                                 # [B,H,C]
        m_inter = m[:, :, None] + bT
        m_s = torch.maximum(m_intra, m_inter)
        logits = torch.einsum("bshk,bthk->bhst", qc, kc).float() * scale
        W = logits * torch.exp(D - m_s[..., None])
        del D, logits
        inter_w = torch.exp(m_inter - m_s)
        qf = qc.transpose(1, 2).float() * scale              # [B,H,C,hd]
        vf, kf = vc.float(), kc.float()
        num = torch.einsum("bhst,bthk->bhsk", W, vf) \
            + inter_w[..., None] * torch.einsum("bhsk,bhkv->bhsv", qf, Cm)
        den = W.sum(-1) + inter_w * torch.einsum("bhsk,bhk->bhs", qf, n)
        den = torch.maximum(den.abs(), torch.exp(-m_s))
        hs.append((num / den[..., None]).transpose(1, 2))    # [B,C,H,hd]
        # carry to the end of the chunk
        btot = bT[:, :, -1]
        gl = btot[:, :, None] - bT + iT                      # log gain [B,H,C]
        m_new = torch.maximum(m + btot, gl.amax(-1))
        wt = torch.exp(gl - m_new[:, :, None])
        kv = torch.einsum("bht,bthk,bthv->bhkv", wt, kf, vf)
        ksum = torch.einsum("bht,bthk->bhk", wt, kf)
        decay_old = torch.exp(m + btot - m_new)
        Cm = Cm * decay_old[..., None, None] + kv
        n = n * decay_old[..., None] + ksum
        m = m_new
    h = torch.cat(hs, dim=1).reshape(B, S, H * hd).to(x.dtype)
    og = torch.sigmoid(x @ p["m_og"].to(x.dtype))
    return (h * og) @ p["m_out"].to(x.dtype)


def mlstm_step(p, x, state):
    """x [B,1,d]; state {"C" [B,H,hd,hd], "n" [B,H,hd], "m" [B,H]} fp32 ->
    (out [B,1,d], new state)."""
    B = x.shape[0]
    qkv = _proj(x, p["m_qkv"])[:, 0]                 # [B,3,H,hd]
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    hd = q.shape[-1]
    i_pre, f_pre = _m_gates(p, x)
    i_pre, f_pre = i_pre[:, 0], f_pre[:, 0]          # [B,H]
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    a = torch.exp(logf + state["m"] - m_new)[..., None]
    bgate = torch.exp(i_pre - m_new)[..., None]
    kf, vf, qf = k.float(), v.float(), q.float()
    C = state["C"] * a[..., None] \
        + bgate[..., None] * kf[..., :, None] * vf[..., None, :]
    n = state["n"] * a + bgate * kf
    num = torch.einsum("bhkv,bhk->bhv", C, qf / math.sqrt(hd))
    den = torch.maximum((n * qf / math.sqrt(hd)).sum(-1).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).to(x.dtype)
    og = torch.sigmoid(x[:, 0] @ p["m_og"].to(x.dtype))
    out = ((h.reshape(B, -1) * og) @ p["m_out"].to(x.dtype))[:, None]
    return out, {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _s_cell(p, gates_x, st):
    """One sLSTM step.  gates_x [B,4,H,hd] (the W x + b part); st {"h",
    "c", "n", "m"} each [B,H,hd] fp32."""
    rec = torch.einsum("bhk,hkgl->bghl", st["h"], p["s_r"])
    z_pre, i_pre, f_pre, o_pre = (gates_x[:, g].float() + rec[:, g]
                                  for g in range(4))
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + st["m"], i_pre)
    a = torch.exp(logf + st["m"] - m_new)
    bg = torch.exp(i_pre - m_new)
    c = a * st["c"] + bg * torch.tanh(z_pre)
    n = a * st["n"] + bg
    h = torch.sigmoid(o_pre) * c / n.clamp_min(1e-6)
    return {"h": h, "c": c, "n": n, "m": m_new}


def _s_gates(p, x):
    """W x + b: x [B,S,d] -> [B,S,4,H,hd] in x's dtype."""
    return _proj(x, p["s_w"]) + p["s_b"].to(x.dtype)


def slstm_scan(p, x):
    """Sequential sLSTM over the sequence, one ``_s_cell`` per token:
    x [B,S,d] -> [B,S,d]."""
    B, S, _ = x.shape
    H, hd = p["s_r"].shape[0], p["s_r"].shape[1]
    gates = _s_gates(p, x)
    st = slstm_state_init(B, H, hd, x.device)
    hs = []
    for t in range(S):
        st = _s_cell(p, gates[:, t], st)
        hs.append(st["h"])
    h = torch.stack(hs, dim=1).reshape(B, S, H * hd).to(x.dtype)
    return h @ p["s_out"].to(x.dtype)


def slstm_step(p, x, st):
    """x [B,1,d] -> (out [B,1,d], new state)."""
    B = x.shape[0]
    st = _s_cell(p, _s_gates(p, x)[:, 0], st)
    out = st["h"].reshape(B, -1).to(x.dtype) @ p["s_out"].to(x.dtype)
    return out[:, None], st


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

# the dimension of each leaf of a step's state (``mlstm_step``'s C, n, m;
# ``slstm_step``'s h, c, n, m) that holds the heads
STATE_DIMS = {"C": 1, "n": 1, "m": 1, "h": 1, "c": 1}


def slstm_state_init(batch: int, H: int, hd: int, device) -> dict:
    def z():
        return torch.zeros((batch, H, hd), dtype=torch.float32,
                           device=device)
    return {"h": z(), "c": z(), "n": z(), "m": z()}


def xlstm_state_init(cfg: ArchConfig, batch: int, device) -> dict:
    """Zero state of one layer, both branches: mLSTM ``mC`` [B,H,hd,hd],
    ``mn`` [B,H,hd], ``mm`` [B,H] and the sLSTM ``s``, all fp32.  ``mm``
    starts at 0, as the reference's decode state does; its parallel form
    starts the stabiliser at -1e30."""
    H = cfg.n_heads
    hd = cfg.d_model // H

    def z(*s):
        return torch.zeros((batch,) + s, dtype=torch.float32, device=device)
    return {"mC": z(H, hd, hd), "mn": z(H, hd), "mm": z(H),
            "s": slstm_state_init(batch, H, hd, device)}
