"""PyTorch port vs the JAX reference: the two-tier KV store's ``lookup``
(the iRC probe, the iRT walk, the device-table cache) between appends,
maintenance passes and a release, under every policy preset, cached and
uncached; every metadata field and counter exactly equal, as
``test_torch_kvcache.py`` holds the store's other ops (its helpers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import PRESETS
from repro.core.policy import get_policy as j_get_policy
from repro.tiered import kvcache as jk
from repro_torch.core.policy import get_policy as t_get_policy
from repro_torch.tiered import kvcache as tk
from test_torch_kvcache import (J_APPEND, J_RELEASE, J_SCHED,
                                _assert_state_equal, _filled, _jit)
from torch_threads import one_torch_thread  # noqa: F401

# the reference's lookup geometry (tests/test_tiered_kv.py), cached and
# uncached (the legacy translate-every-call mode)
LOOKUP_GEOM = dict(n_seqs=2, max_pages_per_seq=64, page_tokens=16,
                   n_kv_heads=2, head_dim=32, fast_data_slots=4,
                   dtype="float32")
J_LOOKUP = _jit(jk.lookup)


@pytest.mark.parametrize("cached", [True, False], ids=["CFG", "CFG_NC"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_lookup_exact(preset, cached):
    """lookup (iRC probe, iRT walk, device-table cache) between appends,
    maintenance passes and a release: the device table and every field
    exact.  Each round looks up twice with no mutation between, so the
    second lookup is the steady state where no live row needs
    translating (the reference skips its miss branch there; the port runs
    it with every write masked off)."""
    kw = dict(LOOKUP_GEOM, cache_device_table=cached)
    jcfg = jk.TieredConfig(policy=j_get_policy(preset, epoch_len=2), **kw)
    tcfg = tk.TieredConfig(policy=t_get_policy(preset, epoch_len=2), **kw)
    js, ts = _filled(jcfg, tcfg, 4)
    rng = np.random.default_rng(5)
    seqs = np.arange(2, dtype=np.int32)
    pos = np.array([126, 40], np.int32)
    pages = (np.arange(64)[None, :] + 64 * seqs[:, None]).astype(np.int32)
    for step in range(6):
        k = rng.normal(size=(2, 2, 32)).astype(np.float32)
        js = J_APPEND(jcfg, js, jnp.asarray(seqs), jnp.asarray(k),
                      jnp.asarray(k), jnp.asarray(pos))
        ts = tk.append_token(tcfg, ts, torch.from_numpy(seqs),
                             torch.from_numpy(k), torch.from_numpy(k),
                             torch.from_numpy(pos))
        live = np.arange(64)[None, :] * 16 < (pos + 1)[:, None]
        for rep in range(2):
            jtab, js = J_LOOKUP(jcfg, js, jnp.asarray(pages),
                                jnp.asarray(live))
            ttab, ts = tk.lookup(tcfg, ts, torch.from_numpy(pages),
                                 torch.from_numpy(live))
            np.testing.assert_array_equal(np.asarray(jtab), ttab.numpy(),
                                          f"step {step} table")
            _assert_state_equal(js, ts, where=f"step {step} lookup {rep}")
        js = J_SCHED(jcfg, js, max_moves=3)
        ts = tk.run_scheduler(tcfg, ts, max_moves=3)
        if step == 3:
            js = J_RELEASE(jcfg, js, 1)
            ts = tk.release_seq(tcfg, ts, 1)
            pos[1] = 0
        _assert_state_equal(js, ts, where=f"step {step}")
        pos = pos + 1
    assert int(ts.migrations) > 0
    assert int(ts.lookups) > 0 and (int(ts.dev_hits) > 0) == cached
