"""The Mamba branch of the hybrid family (``repro_torch.models.ssm``)
against the JAX reference (``repro.models.ssm``) on hymba-1.5b's fp32
smoke config (d 64, state 8, conv 4), with the seeded layer parameters
of the port's ``ssm_init`` (the fp32 constants ``dt_bias``, ``A_log``,
``D`` and the zero conv bias perturbed, so every term counts).

Tolerances: the chunked scan within 2e-4 of the reference at the same
``SSM_CHUNK`` (the bound ``test_chunked_equivalence.py`` holds the
reference's own chunk sizes to: the port's doubling scan multiplies the
decays in another order than ``lax.associative_scan``); the one-step
update, state and output, within 1e-5; the port's scan against its own
step loop at the reference's 2e-3 (``test_ssm_scan_matches_stepwise``);
the doubling scan against the plain recurrence within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as j_ssm
from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import ssm
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "hymba-1.5b"


def _cfgs():
    return j_reduce(j_get_config(ARCH)), reduce_for_smoke(get_config(ARCH))


def _params(cfg, seed=3):
    """Layer 0 of the port's seeded parameters, constants perturbed ->
    (torch dict, jax dict)."""
    g = torch.Generator().manual_seed(seed)
    p = {k: v[0].clone() for k, v in ssm.ssm_init(g, cfg, "cpu").items()}
    for k in ("dt_bias", "A_log", "D", "conv_b"):
        p[k] += 0.3 * torch.randn(p[k].shape, generator=g)
    return p, {k: jnp.asarray(v.numpy()) for k, v in p.items()}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol, err_msg=msg)


@pytest.mark.parametrize("S,chunk", [(128, 128), (128, 16), (24, 1024)])
def test_ssm_scan_matches_reference(monkeypatch, S, chunk):
    """At the reference's test shape (2 lanes of 128 tokens, unit-normal
    xz) in one chunk and in eight carried chunks, and a 24-token call in
    one chunk that is no power of two."""
    jcfg, cfg = _cfgs()
    p, jp = _params(cfg)
    xz = np.random.default_rng(4).normal(
        size=(2, S, 2 * cfg.d_model)).astype(np.float32)
    monkeypatch.setattr(j_ssm, "SSM_CHUNK", chunk)
    monkeypatch.setattr(ssm, "SSM_CHUNK", chunk)
    want = j_ssm.ssm_scan(jp, jnp.asarray(xz), jcfg)
    _close(ssm.ssm_scan(p, torch.from_numpy(xz), cfg), want, 2e-4)


def test_ssm_step_matches_reference():
    """Six steps from a random state: the state (h, conv) and the output
    after every step within 1e-5."""
    jcfg, cfg = _cfgs()
    p, jp = _params(cfg, seed=5)
    rng = np.random.default_rng(6)
    B, d = 3, cfg.d_model
    h0 = rng.normal(size=(B, d, cfg.ssm_state)).astype(np.float32)
    c0 = rng.normal(size=(B, cfg.ssm_conv - 1, d)).astype(np.float32)
    st = {"h": torch.from_numpy(h0), "conv": torch.from_numpy(c0)}
    jst = {"h": jnp.asarray(h0), "conv": jnp.asarray(c0)}
    for t in range(6):
        xz = rng.normal(size=(B, 1, 2 * d)).astype(np.float32) * 0.5
        out, st = ssm.ssm_step(p, torch.from_numpy(xz), st, cfg)
        jout, jst = j_ssm.ssm_step(jp, jnp.asarray(xz), jst, jcfg)
        _close(out, jout, 1e-5, f"out, step {t}")
        for k in ("h", "conv"):
            _close(st[k], jst[k], 1e-5, f"{k}, step {t}")


def test_ssm_scan_matches_stepwise():
    """The port's own identity, as the reference tests its: 24 steps from
    the zero state give the scan's outputs, within 2e-3."""
    _, cfg = _cfgs()
    p, _ = _params(cfg, seed=7)
    T = 24
    g = torch.Generator().manual_seed(8)
    xz = torch.randn((2, T, 2 * cfg.d_model), generator=g) * 0.3
    full = ssm.ssm_scan(p, xz, cfg)
    st = ssm.ssm_state_init(cfg, 2, "cpu")
    outs = []
    for t in range(T):
        o, st = ssm.ssm_step(p, xz[:, t:t + 1], st, cfg)
        outs.append(o)
    assert (torch.cat(outs, 1) - full).abs().max().item() <= 2e-3


@pytest.mark.parametrize("C", [1, 5, 16, 33])
def test_linear_scan_matches_recurrence(C):
    """The doubling scan against h_t = d_t h_{t-1} + u_t run token by
    token, at lengths that are and are not powers of two."""
    g = torch.Generator().manual_seed(C)
    d = torch.rand((2, C, 3, 4), generator=g)
    u = torch.randn((2, C, 3, 4), generator=g)
    h, want = torch.zeros((2, 3, 4)), []
    for t in range(C):
        h = d[:, t] * h + u[:, t]
        want.append(h)
    got = ssm._linear_scan(d, u)
    assert (got - torch.stack(want, 1)).abs().max().item() <= 1e-5
