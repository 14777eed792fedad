"""Selective state-space (Mamba-style) branch of the hybrid blocks (port of
``repro.models.ssm``): in-projection with gate, depthwise causal conv,
selective SSM with input-dependent dt/B/C and a diagonal A.  Prefill runs
the scan over sequence chunks; decode updates an O(1) state per lane.

Parameters of one layer (the port keeps them layer-stacked, [L, ...]):
``in_proj`` [d, 2di], ``conv_w`` [K, di], ``conv_b`` [di], ``x_proj``
[di, dt_rank + 2 state], ``dt_proj`` [dt_rank, di], ``out_proj`` [di, d]
in ``cfg.dtype``; ``dt_bias`` [di], ``A_log`` [di, state] and ``D`` [di]
in fp32, as the reference keeps them.  d_inner == d_model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import torch_dtype

from .layers import stacked_init

SSM_CHUNK = 1024  # sequence chunk: bounds the [B,C,di,state] intermediates


def ssm_init(g: torch.Generator, cfg: ArchConfig, device) -> dict:
    """Seeded layer-stacked parameters in the reference's layout and
    dtypes.  Matrices are scaled by 1/sqrt of their input size, the conv
    taps by 0.5 (the reference's scale); ``dt_bias`` starts at -4.6
    (softplus^-1(0.01)), ``A_log`` at log(1..state), ``D`` at 1 and the
    conv bias at 0, as in the reference."""
    L, d, st, K = cfg.n_layers, cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    di, r = d, max(d // 16, 1)
    dt = torch_dtype(cfg.dtype)

    def stacked(shape, fan_in=0, scale=None):
        return stacked_init(g, L, shape, dt, device, fan_in, scale=scale)

    a_log = torch.log(torch.arange(1, st + 1, dtype=torch.float32,
                                   device=device)).expand(L, di, st)
    return {"in_proj": stacked((d, 2 * di), d),
            "conv_w": stacked((K, di), scale=0.5),
            "conv_b": torch.zeros((L, di), dtype=dt, device=device),
            "x_proj": stacked((di, r + 2 * st), di),
            "dt_proj": stacked((r, di), r),
            "dt_bias": torch.full((L, di), -4.6, dtype=torch.float32,
                                  device=device),
            "A_log": a_log.contiguous(),
            "D": torch.ones((L, di), dtype=torch.float32, device=device),
            "out_proj": stacked((di, d), di)}


def _causal_conv(x, w, b):
    """Depthwise causal conv: x [B,S,di], w [K,di]."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    return sum(pad[:, i:i + S, :] * w[i] for i in range(K)) + b


def _ssm_inputs(p, x, cfg: ArchConfig):
    """x [B,S,di] -> decay, drive [B,S,di,state] and C [B,S,state], all
    fp32."""
    st = cfg.ssm_state
    r = p["dt_proj"].shape[0]
    bcd = x @ p["x_proj"].to(x.dtype)
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


def ssm_scan(p, xz, cfg: ArchConfig):
    """Prefill selective scan over ``SSM_CHUNK``-token chunks: the
    [B,di,state] state carries from chunk to chunk, each chunk scans in
    ``_linear_scan``.  xz [B,S,2di] -> [B,S,d].  S must be at most
    ``SSM_CHUNK`` or a multiple of it."""
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
        decay, drive, Cm = _ssm_inputs(p, xc, cfg)
        drive[:, 0] += decay[:, 0] * h          # fold the carried state in
        hs = _linear_scan(decay, drive)
        del decay, drive
        ys.append((hs * Cm[:, :, None, :]).sum(-1) + p["D"] * xc.float())
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)
    return (y.to(xz.dtype) * F.silu(z)) @ p["out_proj"].to(xz.dtype)


def ssm_step(p, xz, state, cfg: ArchConfig):
    """One decode step.  xz [B,1,2di]; state {"h" [B,di,state] fp32,
    "conv" [B,K-1,di] the causal conv's lookback} -> (out [B,1,d], new
    state)."""
    di = xz.shape[-1] // 2
    xm, z = xz[..., :di], xz[..., di:]
    hist = torch.cat([state["conv"], xm], dim=1)    # [B,K,di]
    w = p["conv_w"].to(xm.dtype)
    xc = F.silu((hist * w[None]).sum(1, keepdim=True)
                + p["conv_b"].to(xm.dtype))
    decay, drive, Cm = _ssm_inputs(p, xc, cfg)                   # [B,1,..]
    h = state["h"] * decay[:, 0] + drive[:, 0]
    y = (h * Cm[:, 0, None, :]).sum(-1) + p["D"] * xc[:, 0].float()
    out = (y[:, None].to(xz.dtype) * F.silu(z)) @ p["out_proj"].to(xz.dtype)
    return out, {"h": h, "conv": hist[:, 1:]}


def ssm_state_init(cfg: ArchConfig, batch: int, device) -> dict:
    """Zero state of one layer: h [B,di,state] fp32, conv [B,K-1,di] in
    ``cfg.dtype``."""
    di = cfg.d_model
    return {"h": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, di),
                                dtype=torch_dtype(cfg.dtype), device=device)}

