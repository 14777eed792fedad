"""The xLSTM branches of the ssm family (``repro_torch.models.xlstm``)
against the JAX reference (``repro.models.xlstm``) on xlstm-125m's fp32
smoke config (d 64, 4 heads of 16), with the seeded layer parameters of
the port's ``xlstm_init`` (the fp32 gate biases perturbed).

Against the reference, within 1e-5: ``mlstm_parallel`` at
``MLSTM_CHUNK`` 64 and 16 (one chunk, and four with the carried state),
``mlstm_step`` from the parallel form's stabiliser (m = -1e30) and from
the cold decode state's (m = 0), ``slstm_scan`` and ``slstm_step``.  The
port's own identities at the reference's tolerances
(``test_chunked_mlstm_matches_and_recurrent``): chunked == one chunk
within 1e-3, the recurrent mLSTM from m = -1e30 == the parallel form
within 2e-3; and the sLSTM step loop == the scan within 1e-5 (the same
cell, the W x product batched over the sequence or not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.xlstm as j_x
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import xlstm
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "xlstm-125m"


def _cfg():
    return reduce_for_smoke(get_config(ARCH))


def _params(seed=3):
    """Layer 0 of the port's seeded parameters, gate biases perturbed ->
    (torch dict, jax dict)."""
    g = torch.Generator().manual_seed(seed)
    p = {k: v[0].clone()
         for k, v in xlstm.xlstm_init(g, _cfg(), "cpu").items()}
    for k in ("m_if_b", "s_b"):
        p[k] += 0.5 * torch.randn(p[k].shape, generator=g)
    return p, {k: jnp.asarray(v.numpy()) for k, v in p.items()}


def _x(seed, S, B=2, scale=0.1):
    return (np.random.default_rng(seed).normal(size=(B, S, _cfg().d_model))
            * scale).astype(np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol, err_msg=msg)


def _state(B, m0, seed):
    """A random mLSTM state with the stabiliser at ``m0``: C, n scaled
    as a state after a few steps would be."""
    cfg = _cfg()
    H = cfg.n_heads
    hd = cfg.d_model // H
    rng = np.random.default_rng(seed)
    if m0 < -1e29:                        # the parallel form's start: empty
        C, n = np.zeros((B, H, hd, hd)), np.zeros((B, H, hd))
    else:
        C, n = rng.normal(size=(B, H, hd, hd)), rng.normal(size=(B, H, hd))
    return {"C": C.astype(np.float32), "n": n.astype(np.float32),
            "m": np.full((B, H), m0, np.float32)}


@pytest.mark.parametrize("chunk", [64, 16])
def test_mlstm_parallel_matches_reference(monkeypatch, chunk):
    p, jp = _params()
    x = _x(8, 64)
    monkeypatch.setattr(j_x, "MLSTM_CHUNK", chunk)
    monkeypatch.setattr(xlstm, "MLSTM_CHUNK", chunk)
    want = j_x.mlstm_parallel(jp, jnp.asarray(x))
    _close(xlstm.mlstm_parallel(p, torch.from_numpy(x)), want, 1e-5)


@pytest.mark.parametrize("m0", [-1e30, 0.0])
def test_mlstm_step_matches_reference(m0):
    """Eight steps: output and (C, n, m) after every step within 1e-5."""
    p, jp = _params(seed=4)
    x = _x(9, 8, B=3)
    st0 = _state(3, m0, seed=10)
    st = {k: torch.from_numpy(v) for k, v in st0.items()}
    jst = {k: jnp.asarray(v) for k, v in st0.items()}
    for t in range(8):
        out, st = xlstm.mlstm_step(p, torch.from_numpy(x[:, t:t + 1]), st)
        jout, jst = j_x.mlstm_step(jp, jnp.asarray(x[:, t:t + 1]), jst)
        _close(out, jout, 1e-5, f"out, step {t}")
        for k in ("C", "n", "m"):
            _close(st[k], jst[k], 1e-5, f"{k}, step {t}")


def test_slstm_scan_matches_reference():
    p, jp = _params(seed=5)
    x = _x(11, 32, scale=1.0)
    want = j_x.slstm_scan(jp, jnp.asarray(x))
    _close(xlstm.slstm_scan(p, torch.from_numpy(x)), want, 1e-5)


def test_slstm_step_matches_reference():
    """Eight steps from the zero state: output and (h, c, n, m) after
    every step within 1e-5."""
    p, jp = _params(seed=6)
    cfg = _cfg()
    H = cfg.n_heads
    hd = cfg.d_model // H
    x = _x(12, 8, B=3, scale=1.0)
    st = xlstm.slstm_state_init(3, H, hd, "cpu")
    jst = j_x.slstm_state_init(3, H, hd)
    for t in range(8):
        out, st = xlstm.slstm_step(p, torch.from_numpy(x[:, t:t + 1]), st)
        jout, jst = j_x.slstm_step(jp, jnp.asarray(x[:, t:t + 1]), jst)
        _close(out, jout, 1e-5, f"out, step {t}")
        for k in ("h", "c", "n", "m"):
            _close(st[k], jst[k], 1e-5, f"{k}, step {t}")


def test_mlstm_chunked_and_recurrent_identities(monkeypatch):
    """The port against itself: four carried chunks of 16 equal one chunk
    of 64 within 1e-3; 16 recurrent steps from m = -1e30 equal the
    parallel form's first 16 rows within 2e-3."""
    p, _ = _params(seed=7)
    x = torch.from_numpy(_x(13, 64))
    monkeypatch.setattr(xlstm, "MLSTM_CHUNK", 64)
    full = xlstm.mlstm_parallel(p, x)
    monkeypatch.setattr(xlstm, "MLSTM_CHUNK", 16)
    chunked = xlstm.mlstm_parallel(p, x)
    assert (chunked - full).abs().max().item() <= 1e-3
    st = {k: torch.from_numpy(v) for k, v in _state(2, -1e30, 0).items()}
    outs = []
    for t in range(16):
        o, st = xlstm.mlstm_step(p, x[:, t:t + 1], st)
        outs.append(o)
    assert (torch.cat(outs, 1) - full[:, :16]).abs().max().item() <= 2e-3


def test_slstm_steps_equal_scan():
    p, _ = _params(seed=8)
    cfg = _cfg()
    H = cfg.n_heads
    x = torch.from_numpy(_x(14, 24, scale=1.0))
    full = xlstm.slstm_scan(p, x)
    st = xlstm.slstm_state_init(2, H, cfg.d_model // H, "cpu")
    outs = []
    for t in range(24):
        o, st = xlstm.slstm_step(p, x[:, t:t + 1], st)
        outs.append(o)
    assert (torch.cat(outs, 1) - full).abs().max().item() <= 1e-5
