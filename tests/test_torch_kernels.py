"""The port's kernels on the CPU through their plain versions: held
against the JAX reference oracles (and, for flash attention, the Pallas
kernel in interpret mode; for the pass replay, the reference's
``_replay_descs``), and the port's own contracts (the live-page bucket,
split == unified bit for bit).  The CUDA kernels themselves run only on
a card (``tests/test_torch_cuda.py``, and ``chip_smoke.py`` at the main
path's shapes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.kernels.paged_attention.ref import \
    paged_attention_fused_ref as j_fused_ref
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as j_paged_ref
from repro.kernels.paged_attention.ref import \
    paged_attention_split_ref as j_split_ref
from repro.kernels.remap_gather.ref import remap_gather_ref as j_gather_ref
from repro.models.attention import _sdpa as j_sdpa
from repro.tiered import kvcache as j_kvcache
from repro.models.attention import make_mask as j_make_mask
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import (
    bf16_tolerance, paged_attention_fused_ref, paged_attention_ref,
    paged_attention_split_ref)
from repro_torch.kernels.remap_gather import ops as rg_ops
from repro_torch.kernels.remap_gather.ref import (FAST_TO_SLOW, SLOW_TO_FAST,
                                                  remap_gather_ref,
                                                  remap_replay_ref)
from repro_torch.tiered import kvcache as t_kvcache
from torch_threads import one_torch_thread  # noqa: F401


def fused_inputs(B=3, K=2, KV=2, G=3, hd=16, P=8, NP=6, F=5, seed=0,
                 dtype=np.float32):
    """Ragged positions, one parked lane (the last), entries mixing fast
    slots and slow homes."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(dtype)  # noqa: E731
    pos = rng.integers(0, NP * P - K, B).astype(np.int32)
    pos[-1] = -1
    entries = np.where(rng.random((B, NP)) < 0.4,
                       rng.integers(0, F, (B, NP)), -1).astype(np.int32)
    return dict(q=f(B, K, KV, G, hd), fast_k=f(F, KV, P, hd),
                fast_v=f(F, KV, P, hd), slow_k=f(B * NP, KV, P, hd),
                slow_v=f(B * NP, KV, P, hd), entries=entries,
                k_new=f(B, K, KV, hd), v_new=f(B, K, KV, hd), pos=pos)


def _torch(d, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in d.items()}


def _live(d):
    return np.asarray(d["pos"]) >= 0


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("bucket", [None, 4])
def test_fused_plain_matches_reference(K, bucket):
    """fp32, atol 1e-5: the two sum the softmax in different orders (the
    port's plain version walks pages with an online softmax, as the
    kernel does).  Parked lanes average stale bytes by definition and are
    not compared."""
    d = fused_inputs(K=K, seed=K)
    if bucket is not None:
        d["pos"][:-1] = np.minimum(d["pos"][:-1], bucket * 8 - K)
        d["entries"] = d["entries"][:, :bucket]
    want = np.asarray(j_fused_ref(**{k: jnp.asarray(v)
                                     for k, v in d.items()}))
    got = paged_attention_fused_ref(**_torch(d)).numpy()
    live = _live(d)
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-5)


@pytest.mark.parametrize("K", [1, 2])
def test_fused_bucket_equals_full_width_bitwise(K):
    """The live-page bucket is bit-invisible on every live lane: the pages
    it drops are fully masked and add exact zeros in page order."""
    d = fused_inputs(K=K, seed=10 + K, NP=8)
    d["pos"][:-1] = np.minimum(d["pos"][:-1], 3 * 8 - K)
    full = paged_attention_fused_ref(**_torch(d)).numpy()
    d["entries"] = d["entries"][:, :3]
    bkt = paged_attention_fused_ref(**_torch(d)).numpy()
    live = _live(d)
    np.testing.assert_array_equal(full[live], bkt[live])


def test_fused_op_on_cpu_is_the_plain_version():
    d = _torch(fused_inputs(seed=3))
    before = pa_ops.launches
    out = pa_ops.paged_attention_fused_op(**d)
    assert pa_ops.launches == before              # no kernel on the CPU
    np.testing.assert_array_equal(out.numpy(),
                                  paged_attention_fused_ref(**d).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remap_gather_plain_matches_reference(dtype):
    """Byte-exact: ``out[i] = pool[idx[i]]``, the engine's layer-major
    [L*n, KV*P, hd] layout with one index per layer."""
    rng = np.random.default_rng(5)
    pool = torch.as_tensor(rng.normal(size=(4 * 7, 16, 8)), dtype=dtype)
    idx = (rng.integers(0, 7) + 7 * np.arange(4)).astype(np.int32)
    got = rg_ops.remap_gather_op(pool, torch.as_tensor(idx),
                                 rg_ops.new_flag(pool.device))
    want = j_gather_ref(jnp.asarray(pool.float().numpy()), jnp.asarray(idx))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))
    assert torch.equal(got, remap_gather_ref(pool, torch.as_tensor(idx)))


def test_remap_gather_plain_rejects_out_of_range():
    pool = torch.zeros(4, 2, 2)
    with pytest.raises(IndexError):
        rg_ops.remap_gather_op(pool, torch.tensor([1, 4], dtype=torch.int32),
                               rg_ops.new_flag(pool.device))


def replay_descs(case, seed, n_d=3, n_p=3, n_fast=6, n_slow=12):
    """A maintenance pass's copy descriptors (numpy, the reference's
    layout): random in-range copies, about a third disabled with garbage
    indices, and per ``case`` an aliasing chain:
    ``install_into_emptied_slot`` (promotion 0 installs into the fast slot
    the first demotion just copied back), ``cb2_reads_fresh_install``
    (promotion 1's cb2 copies back the slot it just installed), ``chain``
    (both, and promotion 2 re-installs a page promotion 0 just copied
    back)."""
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    garbage = lambda n: rng.choice([-7, 1 << 30, -(1 << 31), 99], n)  # noqa

    def copies(n, n_src, n_dst):
        en = rng.random(n) < 0.7
        return (i32(np.where(en, rng.integers(0, n_src, n), garbage(n))),
                i32(np.where(en, rng.integers(0, n_dst, n), garbage(n))), en)

    d = dict(zip(("cb1_src", "cb1_dst", "cb1_en"),
                 copies(n_d, n_fast, n_slow)))
    p = {}
    for kind, (n_src, n_dst) in (("cb1", (n_fast, n_slow)),
                                 ("in", (n_slow, n_fast)),
                                 ("cb2", (n_fast, n_slow))):
        p.update(zip((kind + "_src", kind + "_dst", kind + "_en"),
                     copies(n_p, n_src, n_dst)))
    def enable(desc, kind, i, src, dst):
        desc[kind + "_en"][i] = True
        desc[kind + "_src"][i], desc[kind + "_dst"][i] = src, dst

    if case in ("install_into_emptied_slot", "chain"):
        enable(d, "cb1", 0, 4, 10)
        enable(p, "in", 0, 11, 4)
    if case in ("cb2_reads_fresh_install", "chain"):
        enable(p, "in", 1, 3, 2)
        enable(p, "cb2", 1, 2, 7)
    if case == "chain":
        enable(p, "cb1", 0, 5, 9)
        enable(p, "in", 2, 9, 1)
    return d, p


def _replay_pools(seed, dtype=np.float32, L=2, n_fast=6, n_slow=12, KV=2,
                  P=8, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(L, n, KV, P, hd)).astype(dtype)
            for n in (n_fast, n_fast, n_slow, n_slow)]


@pytest.mark.parametrize("case", ["garbage", "install_into_emptied_slot",
                                  "cb2_reads_fresh_install", "chain"])
def test_remap_replay_plain_matches_reference_replay(case):
    """The pass replay (the record table built from the descriptors, then
    the plain replay) against the reference's ``_replay_descs`` on the
    same pools and descriptors: every pool byte-exact, disabled records
    with garbage indices skipped, aliasing chains in recorded order."""
    d, p = replay_descs(case, seed=len(case))
    pools = _replay_pools(seed=len(case) + 1)
    jcfg = j_kvcache.TieredConfig(n_seqs=2, max_pages_per_seq=6,
                                  page_tokens=8, n_kv_heads=2, head_dim=16,
                                  fast_data_slots=4, dtype="float32")
    want = j_kvcache._replay_descs(
        jcfg, tuple(jnp.asarray(x) for x in pools),
        {k: jnp.asarray(v) for k, v in d.items()},
        {k: jnp.asarray(v) for k, v in p.items()})
    got = [torch.from_numpy(x.copy()) for x in pools]
    t_kvcache._replay_descs(got, {k: torch.as_tensor(v) for k, v in d.items()},
                            {k: torch.as_tensor(v) for k, v in p.items()})
    for w, g, x in zip(want, got, pools):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert any(not np.array_equal(np.asarray(w), x)
               for w, x in zip(want, pools))            # something moved


def test_remap_replay_records_in_recorded_order():
    """The record table: demote copy-backs first, then per promotion
    cb1 -> install -> cb2, with their directions."""
    d, p = replay_descs("garbage", seed=3, n_d=2, n_p=2)
    recs = t_kvcache._pass_records(
        {k: torch.as_tensor(v) for k, v in d.items()},
        {k: torch.as_tensor(v) for k, v in p.items()})
    want = [(FAST_TO_SLOW, d["cb1_src"][i], d["cb1_dst"][i], d["cb1_en"][i])
            for i in range(2)]
    for i in range(2):
        for direction, kind in ((FAST_TO_SLOW, "cb1"), (SLOW_TO_FAST, "in"),
                                (FAST_TO_SLOW, "cb2")):
            want.append((direction, p[kind + "_src"][i],
                         p[kind + "_dst"][i], p[kind + "_en"][i]))
    assert recs.dtype == torch.int32
    assert recs.tolist() == [[int(x) for x in r] for r in want]


def test_remap_replay_plain_rejects_out_of_range_before_writing():
    """An enabled record outside its pools raises ``IndexError`` and
    nothing is written; a disabled one is never checked."""
    pools = [torch.from_numpy(x) for x in _replay_pools(seed=4)]
    before = [x.clone() for x in pools]
    ok = [FAST_TO_SLOW, 1, 2, 1]
    for bad in ([FAST_TO_SLOW, 6, 0, 1], [SLOW_TO_FAST, 0, 6, 1],
                [2, 0, 0, 1], [FAST_TO_SLOW, -1, 0, 1]):
        with pytest.raises(IndexError):
            rg_ops.remap_replay_op(pools, torch.tensor([ok, bad],
                                                       dtype=torch.int32),
                                   rg_ops.new_flag("cpu"))
        for x, y in zip(pools, before):
            assert torch.equal(x, y)
    rg_ops.remap_replay_op(
        pools, torch.tensor([[7, -1, 1 << 30, 0], ok], dtype=torch.int32),
        rg_ops.new_flag("cpu"))
    assert torch.equal(pools[2][:, 2], before[0][:, 1])
    assert torch.equal(pools[3][:, 2], before[1][:, 1])
    assert rg_ops.replay_launches == 0              # no kernel on the CPU


def test_remap_replay_plain_version_is_in_record_order():
    """``remap_replay_ref`` directly: a copy-back, then an install into
    the slot it emptied, then a copy-back of the fresh install."""
    pools = [torch.from_numpy(x) for x in _replay_pools(seed=5)]
    fk0, sk0 = pools[0].clone(), pools[2].clone()
    remap_replay_ref(pools, torch.tensor([[FAST_TO_SLOW, 3, 5, 1],
                                          [SLOW_TO_FAST, 7, 3, 1],
                                          [FAST_TO_SLOW, 3, 8, 1]],
                                         dtype=torch.int32))
    assert torch.equal(pools[2][:, 5], fk0[:, 3])
    assert torch.equal(pools[0][:, 3], sk0[:, 7])
    assert torch.equal(pools[2][:, 8], sk0[:, 7])


def read_inputs(B=4, KV=2, G=3, hd=16, P=8, NP=6, F=7, seed=0):
    """One-token read inputs: ragged seq_lens (the last lane idle), a
    unified-space page table mixing fast slots (< F) and slow homes."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    seq = rng.integers(1, NP * P + 1, B).astype(np.int32)
    seq[-1] = 0
    homes = F + np.arange(B * NP).reshape(B, NP)
    table = np.where(rng.random((B, NP)) < 0.4,
                     rng.integers(0, F, (B, NP)), homes).astype(np.int32)
    return dict(q=f(B, KV, G, hd), fast_k=f(F, KV, P, hd),
                fast_v=f(F, KV, P, hd), slow_k=f(B * NP, KV, P, hd),
                slow_v=f(B * NP, KV, P, hd), page_table=table,
                seq_lens=seq)


def _unified(d):
    return dict(q=d["q"],
                k_pool=np.concatenate([d["fast_k"], d["slow_k"]]),
                v_pool=np.concatenate([d["fast_v"], d["slow_v"]]),
                page_table=d["page_table"], seq_lens=d["seq_lens"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_and_unified_plain_match_reference(seed):
    """fp32, atol 1e-5 on live lanes against the JAX oracles (two softmax
    implementations); the idle lane averages stale bytes by definition
    and is not compared."""
    d = read_inputs(seed=seed, hd=16 * (seed + 1), P=8 << seed)
    live = d["seq_lens"] > 0
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    want = np.asarray(j_split_ref(**jd))
    got = paged_attention_split_ref(**_torch(d)).numpy()
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-5)
    u = _unified(d)
    want_u = np.asarray(j_paged_ref(**{k: jnp.asarray(v)
                                       for k, v in u.items()}))
    got_u = paged_attention_ref(**_torch(u)).numpy()
    np.testing.assert_allclose(got_u[live], want_u[live], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_equals_unified_bitwise(dtype):
    """One attention tail behind two gathers: the split read equals the
    unified read of the concatenated pools bit for bit, idle lane
    included."""
    d = read_inputs(seed=4)
    t = {k: (v.to(dtype) if v.is_floating_point() else v)
         for k, v in _torch(d).items()}
    split = paged_attention_split_ref(**t)
    uni = paged_attention_ref(t["q"], torch.cat([t["fast_k"], t["slow_k"]]),
                              torch.cat([t["fast_v"], t["slow_v"]]),
                              t["page_table"], t["seq_lens"])
    assert split.dtype == dtype
    assert torch.equal(split, uni)


def test_read_ops_on_cpu_are_the_plain_versions():
    d = _torch(read_inputs(seed=5))
    u = _torch(_unified(read_inputs(seed=5)))
    before = (pa_ops.split_launches, pa_ops.unified_launches)
    split = pa_ops.paged_attention_split_op(**d)
    uni = pa_ops.paged_attention_op(**u)
    assert (pa_ops.split_launches, pa_ops.unified_launches) == before
    assert torch.equal(split, paged_attention_split_ref(**d))
    assert torch.equal(uni, paged_attention_ref(**u))
    assert torch.equal(split, uni)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _flash_tol(dtype):
    """The reference's own tolerances (``tests/test_kernels.py::_tol``):
    fp32 sums in other orders; bf16 outputs round at another place."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


def _flash_inputs(B, H, KV, S, hd, seed, T=None):
    """Seeded fp32 q [B,H,S,hd], k/v [B,KV,T,hd] (the kernel layout)."""
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (rng.normal(size=(B, H, S, hd)).astype(np.float32),
            rng.normal(size=(B, KV, T, hd)).astype(np.float32),
            rng.normal(size=(B, KV, T, hd)).astype(np.float32))


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The Pallas flash kernel as the reference's tests run it on the CPU
    (``interpret=True``).  Newer jax names the compiler-params class
    ``CompilerParams``; where ``TPUCompilerParams`` is gone it is aliased
    for this test only, and the reference package is not touched."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 4, 2, 128, 64),
    (2, 8, 8, 256, 64),     # MHA
    (1, 8, 2, 128, 128),    # GQA group 4
    (2, 2, 1, 192, 64),     # MQA, non-pow2 seq blocks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_plain_matches_reference_and_pallas(pallas_interpret, B, H, KV,
                                                  S, hd, dtype, causal,
                                                  window):
    """The port's ``attention_ref`` against the reference's oracle and
    against the Pallas kernel in interpret mode, over the shapes of the
    reference's sweep (``tests/test_kernels.py``), inputs from one numpy
    seed cast to ``dtype`` on both sides."""
    q, k, v = _flash_inputs(B, H, KV, S, hd, seed=S + H + hd)
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    tdt = getattr(torch, dtype)
    got = attention_ref(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                        causal=causal, window=window)
    assert got.dtype == tdt
    got = got.float().numpy()
    want = j_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **_flash_tol(dtype))
    pallas = j_flash(jq, jk, jv, causal=causal, window=window, block_q=64,
                     block_k=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               **_flash_tol(dtype))


@pytest.mark.parametrize("q_offset,window", [(0, 0), (48, 0), (96, 40)])
def test_flash_op_q_offset_matches_reference_mask(q_offset, window):
    """``flash_attention_op`` rows at ``q_offset`` (model layout) against
    the reference model's chunk attention: ``make_mask(q_offset=)`` and
    ``_sdpa``, fp32 within 1e-5 (both sum fp32 in other orders)."""
    B, H, KV, S, T, hd = 2, 4, 2, 32, 160, 16
    q, k, v = _flash_inputs(B, H, KV, S, hd, seed=q_offset, T=T)
    q, k, v = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v))
    got = fa_ops.flash_attention_op(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        window=window, q_offset=q_offset)
    want = j_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  j_make_mask(S, T, causal=True, window=window,
                              q_offset=q_offset))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flash_op_on_cpu_is_the_plain_version():
    """A CPU tensor takes ``attention_ref`` (model layout in and out), and
    the launch counter stays put."""
    q, k, v = (torch.from_numpy(x.transpose(0, 2, 1, 3).copy())
               for x in _flash_inputs(1, 4, 2, 64, 16, seed=9))
    before = fa_ops.launches
    got = fa_ops.flash_attention_op(q, k, v, window=24, q_offset=0)
    assert fa_ops.launches == before
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), window=24).transpose(1, 2)
    assert got.shape == q.shape and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the numeric design of the tensor-core flash kernel, emulated on the CPU
# ---------------------------------------------------------------------------

_EMU_BK = 64          # the kernel's key block, aligned to absolute key 0


def _flash_emulate(q, k, v, q_offset, p_terms=2):
    """The bf16 flash kernel's rounding in plain torch (causal): fp32
    scores, fixed absolute 64-key blocks under an online softmax, l summed
    from the fp32 p, P entering P.V as ``p_terms`` bf16 terms (the kernel:
    hi = bf16(p), lo = bf16(p - hi)), fp32 accumulation, the output
    rounded to bf16.  q [H,S,hd], k/v [KV,T,hd] fp32 holding bf16 values.
    Every reduction is per row, so a row's result leans on nothing else."""
    H, S, hd = q.shape
    KV, T = k.shape[0], k.shape[1]
    pos = torch.arange(S) + q_offset
    n_blk = -(-min(T, q_offset + S) // _EMU_BK)
    out = torch.empty(H, S, hd)
    for h in range(H):
        kk, vv = k[h // (H // KV)], v[h // (H // KV)]
        m = torch.full((S,), -1e30)
        l = torch.zeros(S)
        acc = torch.zeros(S, hd)
        for blk in range(n_blk):
            k0 = blk * _EMU_BK
            n = min(_EMU_BK, T - k0)
            kb, vb = torch.zeros(_EMU_BK, hd), torch.zeros(_EMU_BK, hd)
            kb[:n], vb[:n] = kk[k0:k0 + n], vv[k0:k0 + n]
            s = (q[h][:, None, :] * kb[None]).sum(-1) / hd ** 0.5
            key = torch.arange(k0, k0 + _EMU_BK)[None]
            s = torch.where((key < T) & (key <= pos[:, None]), s, -1e30)
            m_new = torch.maximum(m, s.max(-1).values)
            p = torch.exp(s - m_new[:, None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[:, None]
            hi = p.to(torch.bfloat16).float()
            for term in (hi, (p - hi).to(torch.bfloat16).float())[:p_terms]:
                acc = acc + (term[:, :, None] * vb[None]).sum(1)
            m = m_new
        out[h] = acc / l.clamp_min(1e-30)[:, None]
    return out.to(torch.bfloat16)


def _emu_inputs(S, T, seed, H=8, KV=2, hd=128):
    """GQA group 4 at hd 128, bf16 values from a numpy seed."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(torch.bfloat16).float()
    return f(H, S, hd), f(KV, T, hd), f(KV, T, hd)


def _emu_ratio(q, k, v, q_offset, p_terms):
    """The emulation's worst error against ``attention_ref`` (fp32, cast
    to bf16), as a share of the two-ulp bf16 limit."""
    ref = attention_ref(q[None], k[None], v[None], q_offset=q_offset)[0]
    ref = ref.to(torch.bfloat16).float()
    got = _flash_emulate(q, k, v, q_offset, p_terms).float()
    return ((got - ref).abs() / bf16_tolerance(ref)).max().item()


@pytest.mark.parametrize("S,q_offset", [(256, 0), (64, 16), (64, 192)])
def test_flash_emulated_rounding_within_bf16_limit(S, q_offset):
    """The kernel's numeric design (P as two bf16 terms) holds the
    two-ulp limit at S = T = 256 and for 64-row chunks at q_offset 16 and
    192 over T = 256."""
    q, k, v = _emu_inputs(256, 256, seed=S + q_offset)
    q = q[:, q_offset:q_offset + S]
    assert _emu_ratio(q, k, v, q_offset, p_terms=2) <= 1.0


def test_flash_emulated_single_rounding_of_p_breaks_the_limit():
    """Why P takes two bf16 terms: rounded once, the rows that see few
    keys carry weights near 1/8 whose rounding is far over the limit on
    outputs near zero."""
    q, k, v = _emu_inputs(256, 256, seed=256)
    assert _emu_ratio(q, k, v, 0, p_terms=1) > 10.0


@pytest.mark.parametrize("q_offset", [16, 192])
def test_flash_emulated_chunk_rows_equal_one_shot_bitwise(q_offset):
    """The design's rows are a function of the row and the keys alone: a
    64-row chunk at a page-aligned q_offset equals the one-shot rows bit
    for bit."""
    q, k, v = _emu_inputs(256, 256, seed=7)
    full = _flash_emulate(q, k, v, 0)
    part = _flash_emulate(q[:, q_offset:q_offset + 64].contiguous(), k, v,
                          q_offset)
    assert torch.equal(part, full[:, q_offset:q_offset + 64])


# ---------------------------------------------------------------------------
# the numeric design of the tensor-core flash backward, emulated on the CPU
# ---------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _terms(x, n):
    """x as it enters a product: one bf16 term, or two (hi = bf16(x), lo
    = bf16(x - hi), the kernels' split)."""
    hi = _bf16(x)
    return hi if n == 1 else hi + _bf16(x - hi)


def _bwd_emu_inputs(S, T, H, KV, hd, seed):
    """bf16 values (as fp32) of q, do [H,S,hd] and k, v [KV,T,hd] from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    f = lambda *s: _bf16(torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)))
    return f(H, S, hd), f(KV, T, hd), f(KV, T, hd), f(H, S, hd)


def _flash_bwd_emulate(q, k, v, do, mask, p_terms=2, ds_terms=2):
    """The bf16 backward kernels' rounding in plain torch: the forward's
    o (bf16) and lse, fp32 S and dP from the bf16 inputs, P = exp(s -
    lse) and 0 on masked pairs, dS = P (dP - D) with D from the bf16 o;
    P enters dV = P^T dO, and dS enters dK = dS^T Q and dQ = dS K, as
    ``p_terms`` and ``ds_terms`` bf16 terms; fp32 sums (dK and dV over
    the G heads), the scale applied to the fp32 sums, outputs rounded to
    bf16.  Returns the emulation's and ``attention_bwd_ref``'s (dq, dk,
    dv) from the same o and lse, in the reference's layouts."""
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref)
    H, S, hd = q.shape
    KV = k.shape[0]
    G, scale = H // KV, hd ** -0.5
    kw = dict(causal=mask["causal"], window=mask["window"],
              q_offset=mask["q_offset"])
    o = _bf16(attention_ref(q[None], k[None], v[None], **kw))
    lse = attention_lse_ref(q[None], k[None], **kw)
    want = attention_bwd_ref(q[None], k[None], v[None], o, do[None], lse,
                             **kw)
    pos = torch.arange(S)[:, None] + kw["q_offset"]
    key = torch.arange(k.shape[1])[None]
    ok = torch.ones(S, k.shape[1], dtype=torch.bool)
    if kw["causal"]:
        ok &= key <= pos
    if kw["window"]:
        ok &= key > pos - kw["window"]
    dq = torch.empty(H, S, hd)
    dk, dv = torch.zeros(KV, k.shape[1], hd), torch.zeros(KV, k.shape[1], hd)
    for h in range(H):
        kk, vv = k[h // G], v[h // G]
        p = torch.where(ok, torch.exp(q[h] @ kk.T * scale - lse[0, h, :, None]),
                        0.0)
        dd = (do[h] * o[0, h]).sum(-1, keepdim=True)
        ds = p * (do[h] @ vv.T - dd)
        dv[h // G] += _terms(p, p_terms).T @ do[h]
        dk[h // G] += _terms(ds, ds_terms).T @ q[h]
        dq[h] = _terms(ds, ds_terms) @ kk
    got = (_bf16(dq * scale), _bf16(dk * scale), _bf16(dv))
    return got, tuple(w[0] for w in want)


def _bwd_emu_worst(p_terms, ds_terms, S, T, H, KV, hd, seed, **mask):
    """Each gradient's worst error as a share of its max |value|."""
    args = _bwd_emu_inputs(S, T, H, KV, hd, seed)
    got, want = _flash_bwd_emulate(*args, mask, p_terms, ds_terms)
    return [((a - w).abs().max() / w.abs().max()).item()
            for a, w in zip(got, want)]


_BWD_EMU_CASES = {
    "g4-causal": dict(S=128, T=128, H=8, KV=2, hd=128, causal=True,
                      window=0, q_offset=0),
    "offset": dict(S=64, T=192, H=4, KV=2, hd=64, causal=True, window=0,
                   q_offset=128),
    "window": dict(S=130, T=130, H=5, KV=1, hd=64, causal=True, window=24,
                   q_offset=0),
    "hd80-noncausal": dict(S=65, T=150, H=4, KV=2, hd=80, causal=False,
                           window=0, q_offset=0),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(_BWD_EMU_CASES))
def test_flash_bwd_emulated_rounding_within_gate(case, seed):
    """The backward kernels' numeric design (P and dS as two bf16 terms)
    holds the card's gate: each bf16 gradient within 5e-3 of its max
    |value| of ``attention_bwd_ref``."""
    worst = _bwd_emu_worst(2, 2, seed=seed, **_BWD_EMU_CASES[case])
    assert max(worst) <= 5e-3, worst


@pytest.mark.parametrize("operand,seed", [("ds", 33), ("p", 173)])
def test_flash_bwd_emulated_single_rounding_breaks_the_gate(operand, seed):
    """Why P and dS take two bf16 terms: rounded once, either breaks the
    5e-3 gate on some inputs (dS: dq and dk, P: dv), where the two-term
    design holds it."""
    case = _BWD_EMU_CASES["hd80-noncausal"]
    p_terms, ds_terms = (1, 2) if operand == "p" else (2, 1)
    once = _bwd_emu_worst(p_terms, ds_terms, seed=seed, **case)
    assert max(once) > 5e-3, once
    assert max(_bwd_emu_worst(2, 2, seed=seed, **case)) <= 5e-3
