"""The MoE FFN against the JAX reference: ``repro_torch.models.moe.moe_ffn``
and ``repro.models.moe.moe_ffn`` on the same seeded fp32 inputs and
experts, with capacity for every token and with a router biased so that
tokens drop.  The reference's routing is read from its own run (a spy on
``jax.lax.top_k`` records its probabilities, gates and expert ids); its
slots follow from those ids by its dispatch, written out below.

Tolerances: expert ids, slots and kept flags exactly equal; y within
1e-5 (fp32 products reduced in another order; |y| stays below ~2); the
aux loss within 1e-6.  Precondition, asserted: every token's gap between
its k-th and (k+1)-th router probability exceeds ten times the largest
probability difference between the two packages, so top-k cannot flip
on a near-tie (a flip would be a tie, not a fault)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import init_params as j_init_params
from repro.models import moe as j_moe
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import init_params, moe
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "granite-moe-3b-a800m"
T_BATCH, T_SEQ = 3, 16          # 48 tokens


def _ref_dispatch(eidx, E, C):
    """The reference's dispatch (``repro/models/moe.py:72-79``) on its
    expert ids: (slot, keep)."""
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = jnp.searchsorted(sorted_e, jnp.arange(E), side="left")
    pos_sorted = jnp.arange(flat_e.size, dtype=jnp.int32) - first[sorted_e]
    pos = jnp.zeros((flat_e.size,), jnp.int32).at[order].set(pos_sorted)
    keep = pos < C
    return np.asarray(jnp.where(keep, flat_e * C + pos, E * C)), \
        np.asarray(keep)


def _inputs(cfg, seed, bias: float):
    """Seeded experts and tokens; ``bias`` > 0 lines every token up with
    router column 0, so expert 0 is every token's first choice and its
    rows overflow."""
    rng = np.random.default_rng(seed)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.normal(0, d ** -0.5, (d, E)).astype(np.float32),
         "w_gate": rng.normal(0, d ** -0.5, (E, d, ff)).astype(np.float32),
         "w_up": rng.normal(0, d ** -0.5, (E, d, ff)).astype(np.float32),
         "w_down": rng.normal(0, ff ** -0.5, (E, ff, d)).astype(np.float32)}
    x = rng.normal(0, 1, (T_BATCH, T_SEQ, d)).astype(np.float32)
    if bias:
        u = p["router"][:, 0] / np.linalg.norm(p["router"][:, 0])
        x += bias * u
    return p, x


@pytest.mark.parametrize("case", ["capacity", "drops"])
def test_moe_ffn_matches_reference(case, monkeypatch):
    base = reduce_for_smoke(get_config(ARCH))
    jbase = j_reduce(j_get_config(ARCH))
    # enough capacity: C = T, no expert can overflow; drops: the
    # config's own factor 1.25 with expert 0 every token's first choice
    factor = base.n_experts / base.top_k if case == "capacity" else 1.25
    cfg = dataclasses.replace(base, capacity_factor=factor)
    jcfg = dataclasses.replace(jbase, capacity_factor=factor)
    p, x = _inputs(cfg, 7, 0.0 if case == "capacity" else 6.0)
    seen = {}
    real_top_k = jax.lax.top_k

    def spy(probs, k):
        gate, eidx = real_top_k(probs, k)
        seen.update(probs=np.asarray(probs), eidx=np.asarray(eidx))
        return gate, eidx

    monkeypatch.setattr(jax.lax, "top_k", spy)
    jy, jaux = j_moe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jcfg)
    monkeypatch.setattr(jax.lax, "top_k", real_top_k)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    y, aux = moe.moe_ffn(tp, torch.from_numpy(x), cfg)

    T, E, K = xf.shape[0], cfg.n_experts, cfg.top_k
    probs = torch.softmax(xf @ tp["router"], -1).numpy()
    diff = np.abs(probs - seen["probs"]).max()
    srt = -np.sort(-probs, -1)
    margin = (srt[:, K - 1] - srt[:, K]).min()
    assert margin > 10 * diff, (margin, diff)

    _, eidx, _ = moe.route(tp, xf, cfg)
    np.testing.assert_array_equal(eidx.numpy(), seen["eidx"])
    C = moe.capacity(cfg, T)
    assert C == j_moe.capacity(jcfg, T)
    slot, keep = moe.dispatch(eidx, E, C)
    jslot, jkeep = _ref_dispatch(jnp.asarray(seen["eidx"]), E, C)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    dropped = int((~keep).sum())
    if case == "capacity":
        assert C >= T and dropped == 0
    else:
        assert dropped > 0, "the biased router dropped no token"
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_capacity_matches_reference():
    """``capacity`` over token counts of decode lanes and padded prefill
    buckets, both packages, the smoke and the published configs."""
    for name in ("granite-moe-3b-a800m", "mixtral-8x22b"):
        for cfg, jcfg in ((get_config(name), j_get_config(name)),
                          (reduce_for_smoke(get_config(name)),
                           j_reduce(j_get_config(name)))):
            for n in (1, 4, 8, 37, 256, 1024, 4600, 8192):
                assert moe.capacity(cfg, n) == j_moe.capacity(jcfg, n)


def test_from_jax_params_keeps_the_router_fp32():
    """In a bf16 config every leaf converts to bf16 except the MoE
    router, which keeps the reference's fp32 values exactly."""
    jcfg = dataclasses.replace(j_reduce(j_get_config(ARCH)),
                               dtype="bfloat16")
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)),
                              dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, j_init_params(jcfg,
                                                     jax.random.key(0)))
    params = from_jax_params(jparams, cfg, "cpu")
    router = params["blocks"]["moe"]["router"]
    assert jparams["blocks"]["moe"]["router"].dtype == np.float32
    assert router.dtype == torch.float32
    np.testing.assert_array_equal(router.numpy(),
                                  jparams["blocks"]["moe"]["router"])
    assert params["blocks"]["moe"]["w_gate"].dtype == torch.bfloat16
    assert params["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert params["embed"].dtype == torch.bfloat16


def test_init_params_layout_matches_reference():
    """The port's seeded ``init_params`` gives every leaf the reference's
    path, shape and dtype, for the MoE and the QKV-bias configs in bf16."""
    for name in ("granite-moe-3b-a800m", "mixtral-8x22b", "qwen2-7b"):
        jcfg = dataclasses.replace(j_reduce(j_get_config(name)),
                                   dtype="bfloat16")
        cfg = dataclasses.replace(reduce_for_smoke(get_config(name)),
                                  dtype="bfloat16")
        ours = init_params(cfg, "cpu", seed=0)
        theirs = j_init_params(jcfg, jax.random.key(0))
        flat_o = dict(jax.tree_util.tree_flatten_with_path(
            ours, is_leaf=lambda t: isinstance(t, torch.Tensor))[0])
        flat_t = dict(jax.tree_util.tree_flatten_with_path(theirs)[0])
        assert flat_o.keys() == flat_t.keys(), name
        for k, v in flat_t.items():
            assert tuple(flat_o[k].shape) == v.shape, (name, k)
            assert str(flat_o[k].dtype).split(".")[-1] == str(v.dtype), \
                (name, k)
