"""Selective state-space (Mamba-style) branch of the hybrid blocks (port of
``repro.models.ssm``): in-projection with gate, depthwise causal conv,
selective SSM with input-dependent dt/B/C and a diagonal A.  Prefill runs
the scan over sequence chunks; decode updates an O(1) state per lane.

Parameters of one layer (the port keeps them layer-stacked, [L, ...]):
``in_proj`` [d, 2di], ``conv_w`` [K, di], ``conv_b`` [di], ``x_proj``
[di, dt_rank + 2 state], ``dt_proj`` [dt_rank, di], ``out_proj`` [di, d]
in ``cfg.dtype``; ``dt_bias`` [di], ``A_log`` [di, state] and ``D`` [di]
in fp32, as the reference keeps them.  d_inner == d_model.

Under tensor parallelism (``sharding/tensor_parallel.py``, part "ssm")
``ssm_scan`` and ``ssm_step`` run on this rank's channels of d_inner:
``p`` holds its pieces of the per-channel leaves, ``xz`` its x and z
channels (``TensorParallel.ssm_in``), the state its channels, and
``tp`` sums ``x_proj``'s output over "model"; the caller sums the
output's ``out_proj`` terms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import torch_dtype

from .layers import stacked_const, stacked_init

SSM_CHUNK = 1024  # sequence chunk: bounds the [B,C,di,state] intermediates


def ssm_init(g: torch.Generator, cfg: ArchConfig, device, *, cut=None,
             prefix: str = "blocks/ssm/") -> dict:
    """Seeded layer-stacked parameters in the reference's layout and
    dtypes.  Matrices are scaled by 1/sqrt of their input size, the conv
    taps by 0.5 (the reference's scale); ``dt_bias`` starts at -4.6
    (softplus^-1(0.01)), ``A_log`` at log(1..state), ``D`` at 1 and the
    conv bias at 0, as in the reference.  ``cut`` (``transformer.
    init_params``'s) keeps a piece of each layer's draw, each leaf named
    by its path under ``prefix``: the same draws in the same order."""
    L, d, st, K = cfg.n_layers, cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    di, r = d, max(d // 16, 1)
    dt = torch_dtype(cfg.dtype)
    f32 = torch.float32

    def piece(name):
        return cut(prefix + name) if cut is not None else None

    def stacked(name, shape, fan_in=0, scale=None):
        return stacked_init(g, L, shape, dt, device, fan_in, scale=scale,
                            piece=piece(name))

    def const(name, one):
        return stacked_const(L, one, piece(name))

    a_log = torch.log(torch.arange(1, st + 1, dtype=f32,
                                   device=device)).expand(di, st)
    return {"in_proj": stacked("in_proj", (d, 2 * di), d),
            "conv_w": stacked("conv_w", (K, di), scale=0.5),
            "conv_b": const("conv_b", torch.zeros(di, dtype=dt,
                                                  device=device)),
            "x_proj": stacked("x_proj", (di, r + 2 * st), di),
            "dt_proj": stacked("dt_proj", (r, di), r),
            "dt_bias": const("dt_bias", torch.full((di,), -4.6, dtype=f32,
                                                   device=device)),
            "A_log": const("A_log", a_log),
            "D": const("D", torch.ones(di, dtype=f32, device=device)),
            "out_proj": stacked("out_proj", (di, d), di)}


def _causal_conv(x, w, b):
    """Depthwise causal conv: x [B,S,di], w [K,di]."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    return sum(pad[:, i:i + S, :] * w[i] for i in range(K)) + b


def _ssm_inputs(p, x, cfg: ArchConfig, tp=None):
    """x [B,S,di] -> decay, drive [B,S,di,state] and C [B,S,state], all
    fp32.  With ``tp`` x holds this rank's channels: dt, B and C, a
    contraction over every channel, are summed over "model" (and so is
    their gradient: every rank's channels read all of them)."""
    st = cfg.ssm_state
    r = p["dt_proj"].shape[0]
    bcd = x @ p["x_proj"].to(x.dtype)
    if tp is not None:
        bcd = tp.enter(tp.exit(bcd, "ssm"), "ssm")
    dt = F.softplus(bcd[..., :r].float() @ p["dt_proj"].float()
                    + p["dt_bias"])                          # [B,S,di]
    Bm = bcd[..., r:r + st].float()
    Cm = bcd[..., r + st:].float()
    A = -torch.exp(p["A_log"])                               # [di,st]
    decay = torch.exp(dt[..., None] * A)
    drive = (dt * x.float())[..., None] * Bm[..., None, :]
    return decay, drive, Cm


def _linear_scan(decay, drive):
    """Inclusive scan of h_t = decay_t * h_{t-1} + drive_t along dim 1
    (h_{-1} = 0), as log2(C) doubling steps over shifted views: step s
    combines each position with the one s earlier, (d, h) <- (d' d,
    h + d h') for the earlier pair (d', h').  The reference runs
    ``lax.associative_scan`` with the same combine."""
    d, h = decay, drive
    C, s = d.shape[1], 1
    while s < C:
        h = torch.cat([h[:, :s], h[:, s:] + d[:, s:] * h[:, :-s]], dim=1)
        if 2 * s < C:
            d = torch.cat([d[:, :s], d[:, s:] * d[:, :-s]], dim=1)
        s *= 2
    return h


def ssm_scan(p, xz, cfg: ArchConfig, tp=None):
    """Prefill selective scan over ``SSM_CHUNK``-token chunks: the
    [B,di,state] state carries from chunk to chunk, each chunk scans in
    ``_linear_scan``.  xz [B,S,2di] -> [B,S,d].  S must be at most
    ``SSM_CHUNK`` or a multiple of it.  ``tp``: this rank's channels
    (module docstring); the output is this rank's term of the sum."""
    di = xz.shape[-1] // 2
    B, S, _ = xz.shape
    xm, z = xz[..., :di], xz[..., di:]
    xm = F.silu(_causal_conv(xm, p["conv_w"].to(xm.dtype),
                             p["conv_b"].to(xm.dtype)))
    C = min(SSM_CHUNK, S)
    assert S % C == 0, (S, C)
    h = torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                    device=xz.device)
    ys = []
    for c0 in range(0, S, C):
        xc = xm[:, c0:c0 + C]
        decay, drive, Cm = _ssm_inputs(p, xc, cfg, tp)
        drive[:, 0] += decay[:, 0] * h          # fold the carried state in
        hs = _linear_scan(decay, drive)
        del decay, drive
        ys.append((hs * Cm[:, :, None, :]).sum(-1) + p["D"] * xc.float())
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)
    return (y.to(xz.dtype) * F.silu(z)) @ p["out_proj"].to(xz.dtype)


def ssm_step(p, xz, state, cfg: ArchConfig, tp=None):
    """One decode step.  xz [B,1,2di]; state {"h" [B,di,state] fp32,
    "conv" [B,K-1,di] the causal conv's lookback} -> (out [B,1,d], new
    state).  ``tp``: this rank's channels, as ``ssm_scan``'s."""
    di = xz.shape[-1] // 2
    xm, z = xz[..., :di], xz[..., di:]
    hist = torch.cat([state["conv"], xm], dim=1)    # [B,K,di]
    w = p["conv_w"].to(xm.dtype)
    xc = F.silu((hist * w[None]).sum(1, keepdim=True)
                + p["conv_b"].to(xm.dtype))
    decay, drive, Cm = _ssm_inputs(p, xc, cfg, tp)               # [B,1,..]
    h = state["h"] * decay[:, 0] + drive[:, 0]
    y = (h * Cm[:, 0, None, :]).sum(-1) + p["D"] * xc[:, 0].float()
    out = (y[:, None].to(xz.dtype) * F.silu(z)) @ p["out_proj"].to(xz.dtype)
    return out, {"h": h, "conv": hist[:, 1:]}


# the dimension of each state leaf that holds the channels
STATE_DIMS = {"h": 1, "conv": 2}


def ssm_state_init(cfg: ArchConfig, batch: int, device) -> dict:
    """Zero state of one layer: h [B,di,state] fp32, conv [B,K-1,di] in
    ``cfg.dtype``."""
    di = cfg.d_model
    return {"h": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, di),
                                dtype=torch_dtype(cfg.dtype), device=device)}

