"""PyTorch port vs the JAX reference: the shared helpers, the metadata
engine (iRT + iRC) and the policy layer.  Every integer field must be
exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import PRESETS as J_PRESETS
from repro.core.policy import get_policy as j_get_policy
from repro.core.policy import scheduler as j_sched
from repro.core.policy import trackers as j_track
from repro.core.remap import irt as j_irt
from repro.core.remap import rcache as j_rc
from repro_torch import _scatter
from repro_torch.core.policy import get_policy
from repro_torch.core.policy import scheduler as t_sched
from repro_torch.core.policy import trackers as t_track
from repro_torch.core.remap import irt as t_irt
from repro_torch.core.remap import rcache as t_rc
from torch_threads import one_torch_thread  # noqa: F401


def _t(x, dtype=None):
    a = np.asarray(x)
    return torch.as_tensor(a if dtype is None else a.astype(dtype))


def _eq(jx, tx, what=""):
    np.testing.assert_array_equal(np.asarray(jx).astype(np.int64),
                                  tx.numpy().astype(np.int64), what)


# ---------------------------------------------------------------------------
# _scatter: JAX's drop-mode scatters, stable top-k, uint32 in int64
# ---------------------------------------------------------------------------

def test_drop_set_add_match_jax_1d():
    """Negatives in [-n, 0) wrap, anything else out of range drops,
    duplicate adds accumulate."""
    x = np.arange(8, dtype=np.int32) * 10
    idx = np.array([-1, 4, -5, 9, -9, 4, 0, 8], np.int32)
    val = np.arange(1, 9, dtype=np.int32)
    _eq(jnp.asarray(x).at[idx].set(val, mode="drop"),
        _scatter.drop_set(_t(x), _t(idx), _t(val)))
    _eq(jnp.asarray(x).at[idx].add(val, mode="drop"),
        _scatter.drop_add(_t(x), _t(idx), _t(val)))
    # the measured case: n=4, [-1, 4, -5] writes only index 3
    got = _scatter.drop_set(torch.zeros(4, dtype=torch.int32),
                            torch.tensor([-1, 4, -5]), 7)
    assert got.tolist() == [0, 0, 0, 7]


def test_drop_set_match_jax_multi_index():
    """Index tuples with a slice between advanced indices (the in-place
    pool writes) and adjacent 2-D indices (the iRC cells)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 3, 4, 2)).astype(np.float32)
    fi = np.array([1, 5, -1, 3], np.int32)         # 5 drops, -1 wraps
    off = np.array([0, 2, 3, 4], np.int32)         # 4 drops
    v = rng.normal(size=(4, 3, 2)).astype(np.float32)
    want = jnp.asarray(x).at[fi, :, off].set(v, mode="drop")
    got = _scatter.drop_set_(_t(x), (_t(fi), slice(None), _t(off)), _t(v))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    y = np.zeros((6, 4), np.int32)
    rows = np.array([[0, 6], [2, 2]], np.int32)
    cols = np.array([[1, 3], [0, 3]], np.int32)
    _eq(jnp.asarray(y).at[rows, cols].set(9, mode="drop"),
        _scatter.drop_set(_t(y), (_t(rows), _t(cols)), 9))
    lead = rng.normal(size=(2, 6, 3)).astype(np.float32)
    r = np.array([4, 6, 1], np.int32)
    pv = rng.normal(size=(2, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(lead).at[:, r].set(pv, mode="drop")),
        _scatter.drop_set_(_t(lead), (slice(None), _t(r)), _t(pv)).numpy())


def test_drop_scatters_match_jax_without_host_sync(monkeypatch):
    """Every lane dropped writes nothing; dropped lanes before, between
    and after kept ones (a kept duplicate included) leave JAX's result;
    and no ``nonzero`` runs (on a card it waits for the device)."""
    def sync(*a, **k):
        raise AssertionError("a drop-mode scatter called nonzero")
    monkeypatch.setattr(torch, "nonzero", sync)
    monkeypatch.setattr(torch.Tensor, "nonzero", sync)
    x = np.arange(6, dtype=np.int32) * 10
    for idx in ([6, 7, -7], [6, 2, 9, 2, 6, 5, 8]):
        idx = np.array(idx, np.int32)
        val = np.arange(1, idx.size + 1, dtype=np.int32) * 11
        _eq(jnp.asarray(x).at[idx].set(val, mode="drop"),
            _scatter.drop_set(_t(x), _t(idx), _t(val)))
        _eq(jnp.asarray(x).at[idx].add(val, mode="drop"),
            _scatter.drop_add(_t(x), _t(idx), _t(val)))
    pool = np.random.default_rng(1).normal(size=(3, 2, 4, 2)) \
        .astype(np.float32)
    fi, off = np.array([3, 1, 3], np.int32), np.array([0, 4, 2], np.int32)
    got = _scatter.drop_set_(_t(pool), (_t(fi), slice(None), _t(off)),
                             torch.ones(3, 2, 2))
    np.testing.assert_array_equal(got.numpy(), pool)


def test_top_k_breaks_ties_by_lowest_index():
    x = np.array([1, 3, 3, 0, 3], np.int32)
    import jax
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = _scatter.top_k(_t(x), 3)
    assert np.asarray(ji).tolist() == ti.tolist() == [1, 2, 4]
    _eq(jv, tv)


@pytest.mark.parametrize("hot_leaf", [0, 30, 31, 33, 63])
def test_pack_alloc_bits_bit31(hot_leaf):
    """Bit 31 of an int32 word round-trips (the word goes negative)."""
    cnt = np.zeros(70, np.int32)
    cnt[[hot_leaf, 31, 5, 69]] = [2, 1, 3, 1]
    want = j_irt.pack_alloc_bits(jnp.asarray(cnt))
    got = t_irt.pack_alloc_bits(_t(cnt))
    _eq(want, got)
    assert got.dtype == torch.int32 and int(got[0]) < 0


# ---------------------------------------------------------------------------
# iRT maintenance and the iRC, over random op sequences
# ---------------------------------------------------------------------------

def test_irt_fill_invalidate_sequence():
    rng = np.random.default_rng(1)
    n_ids = 700                                     # 11 leaves, 1 word
    jt, tt = j_irt.init_tables(n_ids), t_irt.init_tables(n_ids)
    resident = np.zeros(n_ids, bool)
    for step in range(20):
        ids = rng.choice(n_ids, 12, replace=False).astype(np.int32)
        if step % 3 == 2:
            en = resident[ids]
            jt = j_irt.invalidate(jt, jnp.asarray(ids), jnp.asarray(en))
            tt = t_irt.invalidate(tt, _t(ids), _t(en))
            resident[ids[en]] = False
        else:
            en = ~resident[ids] & (rng.random(12) < 0.7)
            slots = rng.integers(0, 40, 12).astype(np.int32)
            jt = j_irt.fill(jt, jnp.asarray(ids), jnp.asarray(slots),
                            jnp.asarray(en))
            tt = t_irt.fill(tt, _t(ids), _t(slots), _t(en))
            resident[ids[en]] = True
        for k in jt:
            _eq(jt[k], tt[k], f"step {step} {k}")


def test_rcache_sequence():
    """iRC probe / fill (collision-free lanes) / invalidate /
    invalidate_range, in the order the serving path issues them."""
    rng = np.random.default_rng(2)
    g_kw = dict(nid_sets=16, nid_ways=3, id_sets=8, id_ways=4)
    jg = j_rc.RemapCacheGeometry(kind="irc", **g_kw)
    tg = t_rc.RemapCacheGeometry(**g_kw)
    js, ts = j_rc.init_state(jg), t_rc.init_state(tg)
    n = 2048
    table = np.full(n, -1, np.int32)
    for step in range(24):
        sets = rng.choice(16, 6, replace=False)
        ids = (sets + 16 * rng.integers(0, n // 16, 6)).astype(np.int32)
        table[ids[:2]] = rng.integers(0, 50, 2)      # some non-identity
        dev = np.where(table[ids] >= 0, table[ids], -1).astype(np.int32)
        jh = j_rc.probe(jg, js, jnp.asarray(ids))
        th = t_rc.probe(tg, ts, _t(ids))
        for a, b in zip(jh, th):
            _eq(a, b, f"probe {step}")
        en = ~np.asarray(jh[0])
        _, first = np.unique(ids // 32, return_index=True)
        keep = np.zeros(6, bool)                     # one lane per id line
        keep[first] = True
        en &= keep
        js.update(j_rc.fill(jg, js, jnp.asarray(ids), jnp.asarray(dev),
                            jnp.asarray(table), jnp.asarray(en)))
        ts.update(t_rc.fill(tg, ts, _t(ids), _t(dev), _t(table), _t(en)))
        inv = ids[rng.random(6) < 0.5]
        ien = np.ones(inv.shape, bool)
        bi = bool(step % 2)
        js.update(j_rc.invalidate(jg, js, jnp.asarray(inv), jnp.asarray(ien),
                                  becomes_identity=bi))
        ts.update(t_rc.invalidate(tg, ts, _t(inv), _t(ien),
                                  becomes_identity=bi))
        if step % 5 == 4:
            lo = int(rng.integers(0, n - 200))
            js.update(j_rc.invalidate_range(jg, js, lo, lo + 130))
            ts.update(t_rc.invalidate_range(tg, ts, lo, lo + 130))
        for k in js:
            _eq(js[k], ts[k], f"step {step} {k}")


# ---------------------------------------------------------------------------
# policy: trackers and plan under all six presets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", sorted(J_PRESETS))
def test_trackers_sequence(preset):
    rng = np.random.default_rng(3)
    jp, tp = j_get_policy(preset, epoch_len=2), get_policy(preset,
                                                           epoch_len=2)
    n = 96
    jtr, ttr = j_track.init(jp, n), t_track.init(tp, n)
    for step in range(10):
        ids = rng.integers(0, n, 40).astype(np.int32)
        en = rng.random(40) < 0.8
        w = bool(step % 2)
        jtr = j_track.record(jp, jtr, jnp.asarray(ids), now=step // 2,
                             is_write=w, enable=jnp.asarray(en))
        ttr = t_track.record(tp, ttr, _t(ids), now=step // 2, is_write=w,
                             enable=_t(en))
        _eq(j_track.score(jp, jtr, now=step // 2),
            t_track.score(tp, ttr, now=step // 2))
        jtr = j_track.epoch_tick(jp, jtr, now=step // 2, enable=step % 2 == 1)
        ttr = t_track.epoch_tick(tp, ttr, now=step // 2, enable=step % 2 == 1)
        f = rng.integers(0, n, 5).astype(np.int32)
        fen = rng.random(5) < 0.5
        jtr = j_track.forget(jp, jtr, jnp.asarray(f), jnp.asarray(fen))
        ttr = t_track.forget(tp, ttr, _t(f), _t(fen))
        for k in jtr:
            _eq(jtr[k], ttr[k], f"step {step} {k}")


def _plans_equal(jp, tp):
    for a, b, name in zip(jp, tp, jp._fields):
        _eq(a, b, name)


@pytest.mark.parametrize("preset", sorted(J_PRESETS))
def test_plan_matches_reference(preset):
    rng = np.random.default_rng(4)
    for max_moves in (1, 3, 8):
        for _ in range(4):
            score = rng.integers(0, 6, 64).astype(np.int32)
            resident = rng.random(64) < 0.3
            dkey = rng.integers(0, 4, 64).astype(np.int32)
            jp = j_sched.plan(j_get_policy(preset), jnp.asarray(score),
                              jnp.asarray(resident), max_moves,
                              demote_key=jnp.asarray(dkey))
            tp = t_sched.plan(get_policy(preset), _t(score), _t(resident),
                              max_moves, demote_key=_t(dkey))
            _plans_equal(jp, tp)


def test_plan_tie_heavy_needs_stable_top_k():
    """Scores with many ties: the port's plan equals the reference's, and
    ``torch.topk`` on the same promotion keys would not."""
    score = np.array([2, 5, 5, 0, 5, 5, 1, 5, 5, 5, 3, 5] * 4, np.int32)
    resident = np.zeros(score.shape, bool)
    resident[[3, 6, 10]] = True
    pol = "on_demand"
    jp = j_sched.plan(j_get_policy(pol), jnp.asarray(score),
                      jnp.asarray(resident), 6)
    tp = t_sched.plan(get_policy(pol), _t(score), _t(resident), 6)
    _plans_equal(jp, tp)
    p_key = torch.where(~_t(resident), _t(score) + 1, 0)
    _, naive = torch.topk(p_key, 6)
    assert naive.tolist() != np.asarray(jp.promote_ids).tolist()


# ---------------------------------------------------------------------------
# the iRT walk (irt_lookup's plain version on the CPU)
# ---------------------------------------------------------------------------

def _walk_inputs(seed, n_ids, N):
    """Random fills over ``n_ids`` ids with leaf 31 always allocated (bit
    31 of word 0, the int32 sign bit), then N ids and homes to walk."""
    rng = np.random.default_rng(seed)
    jt = j_irt.init_tables(n_ids)
    nl = jt["leaf_cnt"].shape[0]
    ids = np.unique(np.concatenate([
        rng.choice(nl * j_irt.E, n_ids // 5, replace=False),
        [31 * j_irt.E + 7]])).astype(np.int32)
    slots = rng.integers(0, 300, ids.size).astype(np.int32)
    jt = j_irt.fill(jt, jnp.asarray(ids), jnp.asarray(slots),
                    jnp.ones(ids.size, bool))
    q = np.concatenate([rng.integers(0, nl * j_irt.E, N - 2),
                        [31 * j_irt.E + 7, 31 * j_irt.E + 8]]) \
        .astype(np.int32)
    home = rng.integers(1000, 2000, N).astype(np.int32)
    return jt, q, home


@pytest.mark.parametrize("n_ids,N", [(2048, 7), (2048, 1024), (4096, 4096)])
@pytest.mark.parametrize("levels", [1, 2])
def test_walk_matches_reference(n_ids, N, levels):
    """Random tables, a leaf at bit 31, one- and two-level walks: exact
    against the reference walk and (two levels) against the plain
    ``irt_lookup_ref``."""
    from repro.kernels.irt_lookup.ref import irt_lookup_ref as j_lookup_ref
    from repro_torch.kernels.irt_lookup.ref import irt_lookup_ref
    jt, q, home = _walk_inputs(n_ids + N, n_ids, N)
    assert int(np.asarray(jt["l1_bits"])[0]) < 0     # bit 31 is set
    want = j_irt.walk(jnp.asarray(q), jnp.asarray(home), jt["l1_bits"],
                      jt["entries"], levels=levels, impl="ref")
    tt = {k: _t(np.array(v)) for k, v in jt.items()}
    got = t_irt.walk(_t(q), _t(home), tt["l1_bits"], tt["entries"],
                     levels=levels)
    assert got.dtype == torch.int32
    _eq(want, got, "walk")
    if levels == 2:
        _eq(j_lookup_ref(jnp.asarray(q), jnp.asarray(home), jt["l1_bits"],
                         jt["entries"]),
            irt_lookup_ref(_t(q), _t(home), tt["l1_bits"], tt["entries"]),
            "irt_lookup_ref")


@pytest.mark.parametrize("n_ids,N", [(2048, 7), (2048, 1024), (4096, 4096)])
def test_walk2_matches_two_reference_walks(n_ids, N):
    """The walk to both homes in one pass against two reference walks,
    one to INVALID and one to ``fast_slots + ids``: exact, with a leaf at
    bit 31."""
    from repro_torch.kernels.irt_lookup.ops import irt_walk2_op
    from repro_torch.kernels.irt_lookup.ref import irt_walk2_ref
    jt, q, _ = _walk_inputs(n_ids + N, n_ids, N)
    assert int(np.asarray(jt["l1_bits"])[0]) < 0     # bit 31 is set
    base = 576
    want_walked = j_irt.walk(jnp.asarray(q),
                             jnp.full(q.shape, j_irt.INVALID, jnp.int32),
                             jt["l1_bits"], jt["entries"], impl="ref")
    want_dev = j_irt.walk(jnp.asarray(q), jnp.asarray(base + q),
                          jt["l1_bits"], jt["entries"], impl="ref")
    tt = {k: _t(np.array(v)) for k, v in jt.items()}
    walked, dev = irt_walk2_op(_t(q), base, tt["l1_bits"], tt["entries"])
    assert walked.dtype == dev.dtype == torch.int32
    _eq(want_walked, walked, "walked")
    _eq(want_dev, dev, "dev")
    for got in zip(irt_walk2_ref(_t(q), base, tt["l1_bits"], tt["entries"]),
                   (walked, dev)):
        assert torch.equal(*got)


def test_walk2_folds_the_irc_probe_as_the_reference_translates():
    """With the iRC probe's (hit, val, id_hit) the walk's ``dev`` is the
    reference translation's select chain (``_translate``): a hit takes the
    cached value, an identity hit the home, a miss the walk."""
    from repro_torch.kernels.irt_lookup.ops import irt_walk2_op
    jt, q, _ = _walk_inputs(4096 + 512, 4096, 512)
    rng = np.random.default_rng(9)
    hit = rng.random(q.size) < 0.5
    id_hit = hit & (rng.random(q.size) < 0.5)
    val = rng.integers(0, 300, q.size).astype(np.int32)
    base = 600
    walked = np.asarray(j_irt.walk(
        jnp.asarray(q), jnp.full(q.shape, j_irt.INVALID, jnp.int32),
        jt["l1_bits"], jt["entries"], impl="ref"))
    home = base + q
    want = np.where(hit, np.where(id_hit, home, val),
                    np.where(walked == j_irt.INVALID, home, walked))
    tt = {k: _t(np.array(v)) for k, v in jt.items()}
    got_walked, dev = irt_walk2_op(_t(q), base, tt["l1_bits"],
                                   tt["entries"],
                                   probe=(_t(hit), _t(val), _t(id_hit)))
    _eq(walked, got_walked, "walked")
    _eq(want, dev, "dev")
    assert ((walked != j_irt.INVALID) & ~hit).any()      # walks that hit


def test_walk_unallocated_leaf_ignores_stale_entries():
    """A leaf whose l1 bit is clear resolves to home even where its entry
    holds a slot: the walk trusts the bit vector."""
    tt = t_irt.init_tables(256)
    tt["entries"][70] = 5                       # leaf 1, bit clear
    ids = torch.tensor([70, 3], dtype=torch.int32)
    home = torch.tensor([900, 901], dtype=torch.int32)
    got = t_irt.walk(ids, home, tt["l1_bits"], tt["entries"])
    assert got.tolist() == [900, 901]
    tt["l1_bits"][0] = 2
    got = t_irt.walk(ids, home, tt["l1_bits"], tt["entries"])
    assert got.tolist() == [5, 901]


def test_drop_set_duplicate_lanes_last_writer_wins():
    """Lanes of one batch that hit the same cell: the last lane's value
    lands in every scatter of the batch (a tag and its value stay one
    lane's), as in JAX."""
    x = np.zeros((4, 3), np.int32)
    rows = np.array([1, 1, 2, 1, 9], np.int32)
    cols = np.array([0, 0, 2, 0, 0], np.int32)
    vals = np.array([10, 20, 30, 40, 50], np.int32)
    want = jnp.asarray(x).at[jnp.asarray(rows), jnp.asarray(cols)].set(
        jnp.asarray(vals), mode="drop")
    got = _scatter.drop_set(_t(x), (_t(rows), _t(cols)), _t(vals))
    _eq(want, got)
    assert int(got[1, 0]) == 40
