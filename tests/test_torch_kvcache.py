"""PyTorch port vs the JAX reference: the two-tier KV store.  After the
same op sequence under every policy preset, every metadata field, every
counter and every pool byte must be exactly equal (the port keeps one
metadata copy for all layers, compared against the reference's layer
0).  Covers the serving path's ops and chunked ingest, direct-to-fast
admission and the multi-tenant maintenance pass (``lookup`` in
``test_torch_kvcache_lookup.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import PRESETS
from repro.core.policy import get_policy as j_get_policy
from repro.tiered import kvcache as jk
from repro_torch.core.policy import get_policy as t_get_policy
from repro_torch.tiered import kvcache as tk
from torch_threads import one_torch_thread  # noqa: F401


def _jit(fn, **kw):
    """The reference op under ``jax.jit`` with the config static (op by op
    dispatch of its scans is far slower than one compile)."""
    return jax.jit(fn, static_argnums=(0,), **kw)


J_APPEND = _jit(jk.append_token)
J_READS = _jit(jk.record_reads)
J_TOUCH = _jit(jk.record_touches)
J_SCHED = _jit(jk.run_scheduler, static_argnames=("max_moves",))
J_MIGRATE = _jit(jk.migrate_one)
J_DEMOTE = _jit(jk.demote_one)
J_RELEASE = _jit(jk.release_seq)
J_RELEASE_ST = _jit(jk.release_seq_stacked)
J_PREFILL_ST = _jit(jk.prefill_tokens_stacked)
J_PLAN = _jit(jk.plan_maintenance, static_argnames=("max_moves",))
J_APPLY = _jit(jk.apply_maintenance_stacked_desc)

GEOM = dict(n_seqs=2, max_pages_per_seq=64, page_tokens=8, n_kv_heads=2,
            head_dim=16, fast_data_slots=4, dtype="float32")


def _cfgs(preset):
    return (jk.TieredConfig(policy=j_get_policy(preset, epoch_len=2), **GEOM),
            tk.TieredConfig(policy=t_get_policy(preset, epoch_len=2), **GEOM))


def _filled(jcfg, tcfg, seed, n_layers=None):
    """Both stores with the same seeded slow pools."""
    rng = np.random.default_rng(seed)
    js = jk.init_state(jcfg)
    ts = tk.init_state(tcfg, "cpu", n_layers=n_layers)
    sk = rng.normal(size=ts.slow_k.shape).astype(np.float32)
    sv = rng.normal(size=ts.slow_v.shape).astype(np.float32)
    ts.slow_k.copy_(torch.from_numpy(sk))
    ts.slow_v.copy_(torch.from_numpy(sv))
    if n_layers is not None:
        js = jax.tree.map(lambda x: jnp.broadcast_to(x, (n_layers,) + x.shape),
                          js)
    return js._replace(slow_k=jnp.asarray(sk), slow_v=jnp.asarray(sv)), ts


def _assert_state_equal(js, ts, stacked=False, where=""):
    for f in jk.TieredState._fields:
        a = np.asarray(getattr(js, f))
        if stacked and f not in tk.POOL_FIELDS:
            a = a[0]
        b = getattr(ts, f).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a, b, f"{where} {f}")
        else:
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64), f"{where} {f}")


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_store_op_sequence_exact(preset):
    """Appends at ragged positions, fused-path read accounting, scheduler
    passes, a direct migrate and demote, and a lane release."""
    jcfg, tcfg = _cfgs(preset)
    js, ts = _filled(jcfg, tcfg, 0)
    rng = np.random.default_rng(1)
    seqs = np.arange(2, dtype=np.int32)
    pos = np.array([5, 17], np.int32)
    for step in range(14):
        k = rng.normal(size=(2, 2, 16)).astype(np.float32)
        v = rng.normal(size=(2, 2, 16)).astype(np.float32)
        p = pos if step != 3 else np.array([-1, 17], np.int32)
        js = J_APPEND(jcfg, js, jnp.asarray(seqs), jnp.asarray(k),
                      jnp.asarray(v), jnp.asarray(p))
        ts = tk.append_token(tcfg, ts, torch.from_numpy(seqs),
                             torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(p))
        ids = rng.integers(0, 24, (2, 4)) + seqs[:, None] * 64
        ids = ids.reshape(-1).astype(np.int32)
        lv = rng.random(8) < 0.8
        js = J_READS(jcfg, js, jnp.asarray(ids), jnp.asarray(lv))
        ts = tk.record_reads(tcfg, ts, torch.from_numpy(ids),
                             torch.from_numpy(lv))
        js = J_TOUCH(jcfg, js, jnp.asarray(ids), jnp.asarray(lv))
        ts = tk.record_touches(tcfg, ts, torch.from_numpy(ids),
                               torch.from_numpy(lv))
        js = J_SCHED(jcfg, js, max_moves=3)
        ts = tk.run_scheduler(tcfg, ts, max_moves=3)
        if step == 4:
            js = J_MIGRATE(jcfg, js, jnp.int32(70), jnp.bool_(True))
            ts = tk.migrate_one(tcfg, ts, torch.tensor(70, dtype=torch.int32),
                                torch.tensor(True))
        if step == 6:
            pid = int(np.asarray(js.slot_owner).max())
            js = J_DEMOTE(jcfg, js, jnp.int32(pid), jnp.bool_(True))
            ts = tk.demote_one(tcfg, ts, torch.tensor(pid, dtype=torch.int32),
                               torch.tensor(True))
        if step == 9:
            js = J_RELEASE(jcfg, js, 1)
            ts = tk.release_seq(tcfg, ts, 1)
            pos = np.array([pos[0], 0], np.int32)
        _assert_state_equal(js, ts, where=f"step {step}")
        pos = pos + 1
    assert int(ts.migrations) > 0


@pytest.mark.parametrize("preset", ["threshold", "write_aware", "recency"])
def test_stacked_maintenance_exact(preset):
    """The engine's layer-stacked ops: prefill ingest, planned + applied
    maintenance (copies replayed over two layers through the migration
    gather), release — against the reference's stacked store."""
    jcfg, tcfg = _cfgs(preset)
    L = 2
    js, ts = _filled(jcfg, tcfg, 2, n_layers=L)
    rng = np.random.default_rng(3)
    for step in range(8):
        if step in (0, 5):
            lane = step % 2
            S = 21 + step
            kp = rng.normal(size=(L, S, 2, 16)).astype(np.float32)
            vp = rng.normal(size=(L, S, 2, 16)).astype(np.float32)
            if step == 5:
                js = J_RELEASE_ST(jcfg, js, lane)
                ts = tk.release_seq_stacked(tcfg, ts, lane)
            js = J_PREFILL_ST(jcfg, js, lane, jnp.asarray(kp),
                              jnp.asarray(vp), S - 3)
            ts = tk.prefill_tokens_stacked(tcfg, ts, lane,
                                           torch.from_numpy(kp),
                                           torch.from_numpy(vp),
                                           length=S - 3)
        ids = (rng.integers(0, 6, 6) + 64 * rng.integers(0, 2, 6)) \
            .astype(np.int32)
        lv = np.ones(6, bool)
        j0 = J_TOUCH(jcfg, jax.tree.map(lambda x: x[0], js),
                     jnp.asarray(ids), jnp.asarray(lv))
        js = jk._restack(j0, jk._stacked_pools(js), L)
        ts = tk.record_touches(tcfg, ts, torch.from_numpy(ids),
                               torch.from_numpy(lv))
        jp = J_PLAN(jcfg, js, max_moves=3)
        tp = tk.plan_maintenance(tcfg, ts, max_moves=3)
        for a, b in zip(jp, tp):
            np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                          b.numpy().astype(np.int64))
        js, jd, jpd = J_APPLY(jcfg, js, jp)
        ts, td, tpd = tk.apply_maintenance_stacked_desc(tcfg, ts, tp)
        for jdesc, tdesc in ((jd, td), (jpd, tpd)):
            for key in jdesc:
                np.testing.assert_array_equal(
                    np.asarray(jdesc[key]).astype(np.int64),
                    tdesc[key].numpy().astype(np.int64), key)
        _assert_state_equal(js, ts, stacked=True, where=f"step {step}")
    assert int(ts.migrations) > 0


def test_unified_pools_concatenate_fast_then_slow():
    jcfg, tcfg = _cfgs("threshold")
    js, ts = _filled(jcfg, tcfg, 6)
    for a, b in zip(jk.unified_pools(js), tk.unified_pools(ts)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# chunked ingest, direct-to-fast admission, multi-tenant maintenance
# ---------------------------------------------------------------------------

J_PCHUNK = _jit(jk.prefill_chunk)
J_PCHUNK_ST = _jit(jk.prefill_chunk_stacked)
J_ADMIT = _jit(jk.admit_pages, static_argnames=("n_pages",))
J_ADMIT_ST = _jit(jk.admit_pages_stacked, static_argnames=("n_pages",))
J_TENANTS = _jit(jk.run_scheduler_tenants,
                 static_argnames=("pols", "quotas"))
J_TENANTS_ST = _jit(jk.run_scheduler_tenants_stacked,
                    static_argnames=("pols", "quotas"))
J_LOOKUP1 = _jit(jk.lookup)


def _tenant_pols(preset):
    """Tenant 0 the preset, tenant 1 the same tracker with a smaller move
    budget; quotas (3, 1) of the 4 fast data slots."""
    return ((j_get_policy(preset, epoch_len=2),
             j_get_policy(preset, epoch_len=2, max_moves=2)),
            (t_get_policy(preset, epoch_len=2),
             t_get_policy(preset, epoch_len=2, max_moves=2)), (3, 1))


def _chunks(rng, L, S, C):
    """(start, k, v) chunks of one prompt, the last one ragged."""
    lead = () if L is None else (L,)
    k = rng.normal(size=lead + (S, 2, 16)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    return [(st, k[..., st:st + C, :, :], v[..., st:st + C, :, :])
            for st in range(0, S, C)]


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_chunked_ingest_admission_tenants_exact(preset):
    """Direct-to-fast admission of lane 0's first pages, both lanes'
    prompts ingested chunk by chunk (routed to the admitted fast copies),
    then touches and multi-tenant maintenance passes with a mid-run
    re-admission: every field and pool byte exact after every op."""
    jcfg, tcfg = _cfgs(preset)
    js, ts = _filled(jcfg, tcfg, 7)
    jpols, tpols, quotas = _tenant_pols(preset)
    page_tenant = np.repeat(np.array([0, 1], np.int32), 64)
    rng = np.random.default_rng(8)

    def admit(js, ts, seq, length, n):
        js = J_ADMIT(jcfg, js, seq, length, n_pages=n)
        ts = tk.admit_pages(tcfg, ts, seq, length, n)
        _assert_state_equal(js, ts, where=f"admit seq {seq}")
        return js, ts

    js, ts = admit(js, ts, 0, 44, 2)
    for seq, S in ((0, 44), (1, 37)):
        for start, k, v in _chunks(rng, None, S, 16):
            js = J_PCHUNK(jcfg, js, seq, jnp.asarray(k), jnp.asarray(v),
                          start, S)
            ts = tk.prefill_chunk(tcfg, ts, seq, torch.from_numpy(k),
                                  torch.from_numpy(v), start, S)
            _assert_state_equal(js, ts, where=f"seq {seq} chunk {start}")
    for step in range(6):
        ids = rng.integers(0, 128, (1, 12)).astype(np.int32)
        _, js = J_LOOKUP1(jcfg, js, jnp.asarray(ids))
        _, ts = tk.lookup(tcfg, ts, torch.from_numpy(ids))
        js = J_TENANTS(jcfg, js, jnp.asarray(page_tenant), pols=jpols,
                       quotas=quotas)
        ts = tk.run_scheduler_tenants(tcfg, ts, torch.from_numpy(page_tenant),
                                      tpols, quotas)
        _assert_state_equal(js, ts, where=f"tenants step {step}")
        if step == 2:
            js, ts = J_RELEASE(jcfg, js, 1), tk.release_seq(tcfg, ts, 1)
            js, ts = admit(js, ts, 1, 20, 3)
    assert int(ts.migrations) > 2


@pytest.mark.parametrize("preset", ["threshold", "on_demand", "write_aware"])
def test_stacked_chunked_ingest_admission_tenants_exact(preset):
    """The engine's stacked forms over two layers: admission (copies
    replayed through the migration gather), routed chunk writes and the
    multi-tenant pass, against the reference's stacked store."""
    jcfg, tcfg = _cfgs(preset)
    L = 2
    js, ts = _filled(jcfg, tcfg, 9, n_layers=L)
    jpols, tpols, quotas = _tenant_pols(preset)
    page_tenant = np.repeat(np.array([1, 0], np.int32), 64)
    rng = np.random.default_rng(10)
    js = J_ADMIT_ST(jcfg, js, 1, 30, n_pages=3)
    ts = tk.admit_pages_stacked(tcfg, ts, 1, 30, 3)
    _assert_state_equal(js, ts, stacked=True, where="admit")
    for start, k, v in _chunks(rng, L, 30, 8):
        js = J_PCHUNK_ST(jcfg, js, 1, jnp.asarray(k), jnp.asarray(v), start,
                         30)
        ts = tk.prefill_chunk_stacked(tcfg, ts, 1, torch.from_numpy(k),
                                      torch.from_numpy(v), start, 30)
        _assert_state_equal(js, ts, stacked=True, where=f"chunk {start}")
    for step in range(4):
        ids = (rng.integers(0, 6, 8) + 64 * rng.integers(0, 2, 8)) \
            .astype(np.int32)
        lv = np.ones(8, bool)
        j0 = J_TOUCH(jcfg, jax.tree.map(lambda x: x[0], js),
                     jnp.asarray(ids), jnp.asarray(lv))
        js = jk._restack(j0, jk._stacked_pools(js), L)
        ts = tk.record_touches(tcfg, ts, torch.from_numpy(ids),
                               torch.from_numpy(lv))
        js = J_TENANTS_ST(jcfg, js, jnp.asarray(page_tenant), pols=jpols,
                          quotas=quotas)
        ts = tk.run_scheduler_tenants_stacked(
            tcfg, ts, torch.from_numpy(page_tenant), tpols, quotas)
        _assert_state_equal(js, ts, stacked=True, where=f"step {step}")
    assert int(ts.migrations) >= 3


def test_chunk_ingest_after_admission_routes_to_fast():
    """Admission, then chunked ingest (``tests/test_sched.py``'s case):
    the chunk writes land in the admitted pages' fast copies, reads equal
    those of the same prompt ingested with nothing resident, bit for bit,
    and the whole sequence equals the reference's exactly."""
    from repro_torch.serve import tiered as srv
    jcfg, tcfg = _cfgs("threshold")
    P = tcfg.page_tokens
    S = 4 * P
    rng = np.random.default_rng(2)
    k = rng.normal(size=(S, 2, 16)).astype(np.float32)
    v = rng.normal(size=(S, 2, 16)).astype(np.float32)
    tk_, tv_ = torch.from_numpy(k), torch.from_numpy(v)
    ref = tk.prefill_chunk(tcfg, tk.init_state(tcfg, "cpu"), 0, tk_, tv_, 0,
                           S)
    st = tk.admit_pages(tcfg, tk.init_state(tcfg, "cpu"), 0, S, 2)
    js = J_ADMIT(jcfg, jk.init_state(jcfg), 0, S, n_pages=2)
    assert int(st.migrations) == 2
    assert (st.leaf_table[:2] != tk.INVALID).all()
    assert (st.touch[:2] > 0).all(), "no install touch"
    for start in range(0, S, P):
        st = tk.prefill_chunk(tcfg, st, 0, tk_[start:start + P],
                              tv_[start:start + P], start, S)
        js = J_PCHUNK(jcfg, js, 0, jnp.asarray(k[start:start + P]),
                      jnp.asarray(v[start:start + P]), start, S)
    _assert_state_equal(js, st, where="admitted ingest")
    slot0 = int(st.leaf_table[0])
    assert torch.equal(st.fast_k[slot0], ref.slow_k[0])
    q = torch.from_numpy(rng.normal(size=(2, 2, 2, 16)).astype(np.float32))
    sl = torch.tensor([S, 0], dtype=torch.int32)
    out_ref, _ = srv.attend(tcfg, ref, q, sl)
    out_adm, _ = srv.attend(tcfg, st, q, sl)
    assert torch.equal(out_ref, out_adm)


def test_prefill_tokens_unstacked_exact():
    """The unstacked ``prefill_tokens`` against the reference's on the
    inputs of ``tests/test_tiered_kv.py``'s batched-ingest test: a
    21-token prompt over pages of 16 (a partial last page) padded by 7
    rows of ones past ``length``, into every sequence of a seeded store;
    every state leaf bit for bit after each sequence, and the same
    ``ValueError`` for a prompt of more pages than a sequence holds."""
    geom = dict(GEOM, page_tokens=16, head_dim=32, migrate_threshold=2)
    jcfg = jk.TieredConfig(**geom)
    tcfg = tk.TieredConfig(**geom)
    js, ts = _filled(jcfg, tcfg, 21)
    L, pad = 21, 7
    rng = np.random.default_rng(13)
    k = rng.normal(size=(L, geom["n_kv_heads"], geom["head_dim"])).astype(
        np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    kp = np.concatenate([k, np.ones((pad,) + k.shape[1:], np.float32)])
    vp = np.concatenate([v, np.ones((pad,) + v.shape[1:], np.float32)])
    for seq in range(geom["n_seqs"]):
        js = jk.prefill_tokens(jcfg, js, seq, jnp.asarray(kp),
                               jnp.asarray(vp), length=L)
        ts = tk.prefill_tokens(tcfg, ts, seq, torch.from_numpy(kp),
                               torch.from_numpy(vp), length=L)
        _assert_state_equal(js, ts, where=f"seq {seq}")
    big = np.zeros((geom["max_pages_per_seq"] * 16 + 1,) + k.shape[1:],
                   np.float32)
    with pytest.raises(ValueError) as jerr:
        jk.prefill_tokens(jcfg, js, 0, jnp.asarray(big), jnp.asarray(big))
    with pytest.raises(ValueError) as terr:
        tk.prefill_tokens(tcfg, ts, 0, torch.from_numpy(big),
                          torch.from_numpy(big))
    assert str(terr.value) == str(jerr.value)
