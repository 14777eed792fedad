"""The port's CUDA kernels against their plain versions, on a card.

This file imports neither JAX nor the reference package, so it runs on
the card's machine:  PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py.  Without a card every test skips."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import _scatter
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import (
    bf16_tolerance, paged_attention_fused_ref, paged_attention_split_ref)
from repro_torch.kernels.remap_gather import ops as rg_ops
from repro_torch.kernels.remap_gather.ref import (FAST_TO_SLOW, SLOW_TO_FAST,
                                                  remap_gather_ref,
                                                  remap_replay_ref)
import sim_hazards as hz


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, B=3, K=2, KV=2, G=3, hd=16, P=8, NP=6, F=5, seed=0,
            dtype=torch.float32, live_pages=None):
    """Seeded inputs; every live lane's rows fit in the first
    ``live_pages`` pages (default: all ``NP``)."""
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g).to(device, dtype)  # noqa: E731
    pos = torch.randint(0, (live_pages or NP) * P - K, (B,), generator=g,
                        dtype=torch.int32)
    pos[-1] = -1                                          # a parked lane
    ent = torch.randint(0, F, (B, NP), generator=g, dtype=torch.int32)
    ent = torch.where(torch.rand((B, NP), generator=g) < 0.4, ent, -1)
    return dict(q=f(B, K, KV, G, hd), fast_k=f(F, KV, P, hd),
                fast_v=f(F, KV, P, hd), slow_k=f(B * NP, KV, P, hd),
                slow_v=f(B * NP, KV, P, hd), entries=ent.to(device),
                k_new=f(B, K, KV, hd), v_new=f(B, K, KV, hd),
                pos=pos.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2])
def test_fused_kernel_matches_plain(cuda, K):
    """fp32, atol 1e-4: online and plain softmax sum in other orders."""
    d = _inputs(cuda, K=K, seed=K)
    before = pa_ops.launches
    out = pa_ops.paged_attention_fused_op(**d)
    assert pa_ops.launches == before + 1
    ref = paged_attention_fused_ref(**d)
    live = d["pos"] >= 0
    torch.testing.assert_close(out[live], ref[live], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("P", [8, 16, 32, 64, 128])
def test_fused_kernel_every_head_dim_and_page(cuda, P, hd, dtype):
    """Every supported (hd, page) pair, K=2 (the largest pages need more
    than 48 KiB of shared memory); fp32 atol 1e-4, bf16 two ulps of each
    reference value (``bf16_tolerance``) against the plain version in fp32
    cast to bf16."""
    d = _inputs(cuda, B=3, K=2, KV=2, G=3, hd=hd, P=P, NP=3, F=4,
                seed=hd + P, dtype=dtype)
    out = pa_ops.paged_attention_fused_op(**d).float()
    ref = paged_attention_fused_ref(
        **{k: (v.float() if v.is_floating_point() else v)
           for k, v in d.items()}).to(dtype).float()
    live = d["pos"] >= 0
    tol = 1e-4 if dtype == torch.float32 else bf16_tolerance(ref[live])
    assert ((out[live] - ref[live]).abs() <= tol).all()


@pytest.mark.cuda
def test_fused_kernel_bf16_main_shapes(cuda):
    """bf16 at hd=128, page=16, G=4, K=1 against the plain version in fp32
    cast to bf16: within two bf16 ulps of each reference value."""
    d = _inputs(cuda, B=4, K=1, KV=2, G=4, hd=128, P=16, NP=8, F=6, seed=7,
                dtype=torch.bfloat16)
    out = pa_ops.paged_attention_fused_op(**d).float()
    ref = paged_attention_fused_ref(
        **{k: (v.float() if v.is_floating_point() else v)
           for k, v in d.items()}).to(torch.bfloat16).float()
    live = d["pos"] >= 0
    assert ((out[live] - ref[live]).abs()
            <= bf16_tolerance(ref[live])).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_bucket_equals_full_width_bitwise(cuda, dtype):
    """Attending the live-page bucket equals attending the full table bit
    for bit on the card: a split every row masks merges in as exact
    zeros."""
    d = _inputs(cuda, B=4, K=2, KV=2, G=4, hd=64, P=16, NP=24, F=6, seed=5,
                dtype=dtype, live_pages=8)
    full = pa_ops.paged_attention_fused_op(**d)
    bucket = pa_ops.paged_attention_fused_op(
        **{**d, "entries": d["entries"][:, :8]})
    live = d["pos"] >= 0
    assert torch.equal(bucket[live], full[live])


@pytest.mark.cuda
def test_remap_gather_kernel_exact_and_checked(cuda):
    """Byte-exact for 16-byte and 4-byte words; an index outside the pool
    is never read, zero-fills its slab and raises the batch's flag."""
    pool = torch.randn(12, 16, 128, device=cuda).to(torch.bfloat16)
    idx = torch.tensor([3, 0, 11, 3], dtype=torch.int32, device=cuda)
    err = rg_ops.new_flag(cuda)
    assert torch.equal(rg_ops.remap_gather_op(pool, idx, err),
                       remap_gather_ref(pool, idx))
    odd = torch.arange(5 * 3 * 3, dtype=torch.float32,
                       device=cuda).view(5, 3, 3)   # 36-byte slabs
    assert torch.equal(rg_ops.remap_gather_op(odd, idx[:2] % 5, err),
                       remap_gather_ref(odd, idx[:2] % 5))
    rg_ops.check_flag(err)                          # nothing out of range
    bad = rg_ops.remap_gather_op(
        pool, torch.tensor([12, 1], dtype=torch.int32, device=cuda), err)
    assert torch.equal(bad[0], torch.zeros_like(bad[0]))
    assert torch.equal(bad[1], pool[1])
    with pytest.raises(IndexError):
        rg_ops.check_flag(err)
    assert np.isfinite(pool.float().cpu().numpy()).all()


def _replay_pools(device, L, n_fast, n_slow, page, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((L, n) + page, generator=g, device=device).to(dtype)
            for n in (n_fast, n_fast, n_slow, n_slow)]


def _main_pass_records(device):
    """A recorded main-path pass, every record enabled: 4 demote
    copy-backs, then 4 promotions as cb1 -> install -> cb2, with aliasing
    chains: promotion 0 installs into the slot the first demotion emptied,
    promotion 1 re-installs the page promotion 0 copied back, promotion 2's
    cb2 copies back the slot it just installed (144 fast slots, 1024 slow
    homes)."""
    recs = [[FAST_TO_SLOW, s, h, 1] for s, h in
            ((3, 100), (17, 205), (40, 311), (77, 412))]
    for cb1, ins, cb2 in (((90, 500), (600, 3), (128, 700)),
                          ((91, 501), (500, 90), (129, 701)),
                          ((92, 502), (602, 92), (92, 702)),
                          ((93, 503), (603, 93), (130, 703))):
        recs += [[FAST_TO_SLOW, *cb1, 1], [SLOW_TO_FAST, *ins, 1],
                 [FAST_TO_SLOW, *cb2, 1]]
    return torch.tensor(recs, dtype=torch.int32, device=device)


def _random_records(device, n, n_fast, n_slow, seed):
    """``n`` records over small pools (aliasing everywhere), a fifth
    disabled with garbage indices."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    src = torch.where(d == FAST_TO_SLOW,
                      torch.randint(0, n_fast, (n,), generator=g),
                      torch.randint(0, n_slow, (n,), generator=g))
    dst = torch.where(d == FAST_TO_SLOW,
                      torch.randint(0, n_slow, (n,), generator=g),
                      torch.randint(0, n_fast, (n,), generator=g))
    en = torch.rand((n,), generator=g) < 0.8
    src = torch.where(en, src, -(1 << 30))
    dst = torch.where(en, dst, (1 << 30) + 5)
    return torch.stack([d, src.int(), dst.int(), en.int()], 1) \
        .contiguous().to(device)


def _replay_both(pools, recs):
    """(kernel result, plain result) from the same pools; the kernel's
    flag must stay clear."""
    kern = [x.clone() for x in pools]
    plain = [x.clone() for x in pools]
    err = rg_ops.new_flag(pools[0].device)
    before = rg_ops.replay_launches
    rg_ops.remap_replay_op(kern, recs, err)
    assert rg_ops.replay_launches == before + 1
    rg_ops.check_flag(err)
    remap_replay_ref(plain, recs)
    return kern, plain


@pytest.mark.cuda
def test_remap_replay_kernel_bitwise_at_main_shapes(cuda):
    """One launch replays a recorded main-path pass over llama3-8b's
    stacked bf16 pools (32 layers, 144 fast slots, 1024 slow homes, KV 8 x
    page 16 x hd 128): every pool equals the plain per-record replay bit
    for bit, aliasing chains included."""
    pools = _replay_pools(cuda, 32, 144, 1024, (8, 16, 128), torch.bfloat16,
                          seed=0)
    kern, plain = _replay_both(pools, _main_pass_records(cuda))
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)
    assert not torch.equal(kern[0], pools[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,page", [
    (torch.float32, (2, 8, 16)),            # 1024-byte slabs: 16-byte words
    (torch.float32, (1, 3, 5)),             # 60 bytes: 4-byte words
    (torch.bfloat16, (1, 3, 5)),            # 30 bytes: 1-byte words
    (torch.bfloat16, (8, 16, 128))])
def test_remap_replay_kernel_word_paths_and_chains(cuda, dtype, page):
    """Every word path at the smoke and odd slab sizes, over 600 records
    on 5 fast and 9 slow pages (aliasing chains within and across windows,
    and records in three shared-memory segments), on 3 layers: bit for bit
    against the plain replay."""
    pools = _replay_pools(cuda, 3, 5, 9, page, dtype, seed=1)
    kern, plain = _replay_both(pools, _random_records(cuda, 600, 5, 9, 2))
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_remap_replay_kernel_flags_out_of_range_and_skips_disabled(cuda):
    """An enabled record outside its pools writes nothing and sets the
    flag; the records around it still apply; a disabled record's indices
    are never read or checked."""
    pools = _replay_pools(cuda, 2, 4, 6, (2, 8, 16), torch.float32, seed=3)
    before = [x.clone() for x in pools]
    recs = torch.tensor([[FAST_TO_SLOW, 1, 2, 1],
                         [FAST_TO_SLOW, 0, 6, 1],        # dst outside
                         [SLOW_TO_FAST, 9, 0, 1],        # src outside
                         [5, 0, 0, 1],                   # no such direction
                         [SLOW_TO_FAST, 1 << 30, -(1 << 30), 0],
                         [SLOW_TO_FAST, 3, 3, 1]], dtype=torch.int32,
                        device=cuda)
    err = rg_ops.new_flag(cuda)
    rg_ops.remap_replay_op(pools, recs, err)
    with pytest.raises(IndexError):
        rg_ops.check_flag(err)
    want = [x.clone() for x in before]
    remap_replay_ref(want, recs[[0, 5]])
    for a, b in zip(pools, want):
        assert torch.equal(a, b)
    err = rg_ops.new_flag(cuda)
    rg_ops.remap_replay_op(pools, recs[[4]], err)
    rg_ops.check_flag(err)                        # a disabled one: clear
    for a, b in zip(pools, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_remap_replay_rejects_what_it_does_not_take(cuda):
    pools = _replay_pools(cuda, 2, 4, 6, (2, 8, 16), torch.float32, seed=4)
    recs = torch.tensor([[FAST_TO_SLOW, 1, 2, 1]], dtype=torch.int32,
                        device=cuda)
    err = rg_ops.new_flag(cuda)
    with pytest.raises(ValueError):
        rg_ops.remap_replay_op(pools, recs.long(), err)
    with pytest.raises(ValueError):
        rg_ops.remap_replay_op(pools, recs[:, :3].contiguous(), err)
    with pytest.raises(ValueError):
        rg_ops.remap_replay_op(pools, recs.view(-1)[1:].view(1, 3), err)
    with pytest.raises(ValueError):
        rg_ops.remap_replay_op(pools[:3] + [pools[3].half()], recs, err)
    with pytest.raises(ValueError):
        rg_ops.remap_replay_op(pools[:2] + [pools[2][:, :, :1]] * 2, recs,
                               err)
    with pytest.raises(ValueError):
        rg_ops.remap_replay_op(pools, recs.cpu(), err)


@pytest.mark.cuda
def test_drop_scatters_never_wait_for_the_card(cuda):
    """The drop-mode scatters of the decode step and the maintenance pass
    run with no host synchronisation (sync debug mode raises on one), and
    give the CPU's result."""
    g = torch.Generator().manual_seed(3)
    table = torch.randint(0, 50, (10,), generator=g, dtype=torch.int32)
    cells = torch.randint(0, 50, (6, 4), generator=g, dtype=torch.int32)
    pool = torch.randn(2, 5, 3, 4, 2, generator=g)
    idx = torch.tensor([10, 3, -1, 12, 3], dtype=torch.int32)
    rows = torch.tensor([6, 2, 5], dtype=torch.int32)
    cols = torch.tensor([1, 3, 4], dtype=torch.int32)
    fi = torch.tensor([[5, 1, 2]], dtype=torch.int32)
    off = torch.tensor([[0, 3, 2]], dtype=torch.int32)
    li = torch.arange(2)[:, None]
    val = torch.randn(2, 3, 3, 2, generator=g)

    def run(table, idx, cells, rows, cols, pool, li, fi, off, val):
        return (_scatter.drop_set(table, idx, 7),
                _scatter.drop_add(table, idx, idx),
                _scatter.drop_set(cells, (rows, cols), -1),
                _scatter.drop_set_(pool, (li, fi, slice(None), off), val))
    args = (table, idx, cells, rows, cols, pool, li, fi, off, val)
    want = run(*(a.clone() for a in args))
    on_card = [a.to(cuda) for a in args]     # the uploads themselves wait
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for w, o in zip(want, got):
        assert torch.equal(o.cpu(), w)


# ---------------------------------------------------------------------------
# the zero-copy serving path: irt_lookup, paged_attention_split and
# paged_attention
# ---------------------------------------------------------------------------

def _irt_inputs(device, n_ids, N, seed):
    """A seeded iRT over ``n_ids`` ids (leaf 31 allocated, so bit 31 of a
    word is set) and N ids to walk."""
    from repro_torch.core.remap import irt
    g = torch.Generator().manual_seed(seed)
    tab = irt.init_tables(n_ids)
    nl = tab["leaf_cnt"].shape[0]
    ids = torch.randint(0, nl * irt.E, (max(N // 2, 1),), generator=g,
                        dtype=torch.int32)
    ids = torch.cat([ids, torch.arange(31 * irt.E, 32 * irt.E,
                                       dtype=torch.int32)]) % (nl * irt.E)
    slots = torch.randint(0, 500, ids.shape, generator=g, dtype=torch.int32)
    tab = irt.fill(tab, ids.unique(), slots[:ids.unique().numel()],
                   torch.ones(ids.unique().numel(), dtype=torch.bool))
    q = torch.randint(0, nl * irt.E, (N,), generator=g, dtype=torch.int32)
    home = torch.randint(1000, 2000, (N,), generator=g, dtype=torch.int32)
    return [t.to(device) for t in (q, home, tab["l1_bits"],
                                   tab["entries"])]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 255, 4096, 5001])
def test_irt_lookup_kernel_exact(cuda, N):
    """Any N (nothing padded), random tables with leaf 31 allocated: the
    kernel equals the plain version exactly."""
    from repro_torch.kernels.irt_lookup import ops as irt_ops
    from repro_torch.kernels.irt_lookup.ref import irt_lookup_ref
    ids, home, l1, leaf = _irt_inputs(cuda, 4096, N, seed=N)
    before = irt_ops.launches
    out = irt_ops.irt_lookup_op(ids, home, l1, leaf)
    assert irt_ops.launches == before + 1
    assert torch.equal(out, irt_lookup_ref(ids, home, l1, leaf))
    assert (l1 < 0).any()                       # bit 31 is exercised


@pytest.mark.cuda
def test_irt_lookup_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.irt_lookup import ops as irt_ops
    ids, home, l1, leaf = _irt_inputs(cuda, 256, 64, seed=1)
    with pytest.raises(ValueError):
        irt_ops.irt_lookup_op(ids.long(), home, l1, leaf)
    with pytest.raises(ValueError):
        irt_ops.irt_lookup_op(ids, home[:-1], l1, leaf)
    with pytest.raises(ValueError):
        irt_ops.irt_lookup_op(ids, home.cpu(), l1, leaf)
    with pytest.raises(ValueError):
        irt_ops.irt_lookup_op(ids[::2], home[::2], l1, leaf)


@pytest.mark.cuda
@pytest.mark.parametrize("probe", [False, True])
@pytest.mark.parametrize("N", [1, 4096, 65536])
def test_irt_walk2_kernel_exact(cuda, N, probe):
    """The walk to both homes in one pass, with and without the iRC probe
    folded in, equals its plain version exactly at any N (leaf 31
    allocated)."""
    from repro_torch.kernels.irt_lookup import ops as irt_ops
    from repro_torch.kernels.irt_lookup.ref import irt_walk2_ref
    ids, _, l1, leaf = _irt_inputs(cuda, max(N, 4096), N, seed=N)
    pr = None
    if probe:
        g = torch.Generator().manual_seed(N)
        hit = torch.rand(N, generator=g) < 0.5
        pr = tuple(t.to(cuda) for t in (
            hit, torch.randint(0, 500, (N,), generator=g, dtype=torch.int32),
            hit & (torch.rand(N, generator=g) < 0.5)))
    before = (irt_ops.launches, irt_ops.walk2_launches)
    got = irt_ops.irt_walk2_op(ids, 576, l1, leaf, pr)
    assert (irt_ops.launches, irt_ops.walk2_launches) == \
        (before[0] + 1, before[1] + 1)
    for a, b in zip(got, irt_walk2_ref(ids, 576, l1, leaf, pr)):
        assert torch.equal(a, b)
    assert (l1 < 0).any()


@pytest.mark.cuda
def test_irt_walk2_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.irt_lookup import ops as irt_ops
    ids, _, l1, leaf = _irt_inputs(cuda, 256, 64, seed=1)
    hit = torch.zeros(64, dtype=torch.bool, device=cuda)
    val = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        irt_ops.irt_walk2_op(ids.long(), 7, l1, leaf)
    with pytest.raises(ValueError):
        irt_ops.irt_walk2_op(ids[::2], 7, l1, leaf)
    with pytest.raises(ValueError):
        irt_ops.irt_walk2_op(ids, 7, l1, leaf, (hit.int(), val, hit))
    with pytest.raises(ValueError):
        irt_ops.irt_walk2_op(ids, 7, l1, leaf, (hit[:-1], val[:-1],
                                                 hit[:-1]))
    with pytest.raises(ValueError):
        irt_ops.irt_walk2_op(ids, 1 << 31, l1, leaf)


def _read_inputs(device, B=4, KV=2, G=3, hd=16, P=8, NP=6, F=7, seed=0,
                 dtype=torch.float32, distinct=False):
    """Seeded split-pool read inputs: ragged seq_lens (the last lane
    idle), a unified-space page table mixing fast slots and slow homes
    (``distinct``: no two pages share a fast slot; needs F >= B*NP)."""
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g).to(device, dtype)  # noqa: E731
    seq = torch.randint(1, NP * P + 1, (B,), generator=g, dtype=torch.int32)
    seq[-1] = 0
    homes = F + torch.arange(B * NP, dtype=torch.int32).view(B, NP)
    if distinct:
        fast = torch.randperm(F, generator=g)[:B * NP].view(B, NP).to(
            torch.int32)
    else:
        fast = torch.randint(0, F, (B, NP), generator=g, dtype=torch.int32)
    table = torch.where(torch.rand((B, NP), generator=g) < 0.4, fast, homes)
    return dict(q=f(B, KV, G, hd), fast_k=f(F, KV, P, hd),
                fast_v=f(F, KV, P, hd), slow_k=f(B * NP, KV, P, hd),
                slow_v=f(B * NP, KV, P, hd), page_table=table.to(device),
                seq_lens=seq.to(device))


def _unified(d):
    return dict(q=d["q"], k_pool=torch.cat([d["fast_k"], d["slow_k"]]),
                v_pool=torch.cat([d["fast_v"], d["slow_v"]]),
                page_table=d["page_table"], seq_lens=d["seq_lens"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("P", [8, 16, 32, 64, 128])
def test_split_and_unified_kernels_match_plain(cuda, P, hd, dtype):
    """Every supported (hd, page) pair: fp32 atol 1e-4 (online and full
    softmax sum in other orders), bf16 two ulps of each reference value
    against the plain version in fp32 cast to bf16; split == unified over
    the concatenated pools bit for bit; idle lanes are zeros."""
    d = _read_inputs(cuda, hd=hd, P=P, NP=3, seed=hd + P, dtype=dtype)
    b0, u0 = pa_ops.split_launches, pa_ops.unified_launches
    out = pa_ops.paged_attention_split_op(**d)
    uni = pa_ops.paged_attention_op(**_unified(d))
    assert (pa_ops.split_launches, pa_ops.unified_launches) == (b0 + 1,
                                                                u0 + 1)
    assert torch.equal(out, uni)
    ref = paged_attention_split_ref(
        **{k: (v.float() if v.is_floating_point() else v)
           for k, v in d.items()}).to(dtype).float()
    live = d["seq_lens"] > 0
    tol = 1e-4 if dtype == torch.float32 else bf16_tolerance(ref[live])
    assert ((out.float()[live] - ref[live]).abs() <= tol).all()
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_read_equals_fused_step_bitwise(cuda, dtype):
    """A one-token fused step (new row overlaid) and the split read of the
    store the row was appended to run one body: equal bit for bit."""
    B, KV, G, hd, P, NP, F = 4, 2, 4, 64, 16, 8, 40
    d = _read_inputs(cuda, B=B, KV=KV, G=G, hd=hd, P=P, NP=NP, F=F, seed=9,
                     dtype=dtype, distinct=True)
    pos = (d["seq_lens"] - 1).to(torch.int32)        # idle lane: -1
    table = d["page_table"]
    entries = torch.where(table < F, table, -1).to(torch.int32)
    k_new = torch.randn(B, 1, KV, hd, device=cuda).to(dtype)
    v_new = torch.randn(B, 1, KV, hd, device=cuda).to(dtype)
    fused = pa_ops.paged_attention_fused_op(
        d["q"][:, None], d["fast_k"], d["fast_v"], d["slow_k"], d["slow_v"],
        entries, k_new, v_new, pos)[:, 0]
    for b in range(B - 1):                           # append, then read
        p = int(pos[b])
        j, r = p // P, p % P
        slot = int(table[b, j])
        for pool_f, pool_s, new in ((d["fast_k"], d["slow_k"], k_new),
                                    (d["fast_v"], d["slow_v"], v_new)):
            dst = pool_f[slot] if slot < F else pool_s[slot - F]
            dst[:, r] = new[b, 0]
    split = pa_ops.paged_attention_split_op(**d)
    assert torch.equal(split, fused)


@pytest.mark.cuda
def test_split_and_unified_reject_what_they_do_not_take(cuda):
    d = _read_inputs(cuda)
    bad = [dict(seq_lens=d["seq_lens"].long()),
           dict(seq_lens=d["seq_lens"][:-1]),
           dict(page_table=d["page_table"].long()),
           dict(page_table=d["page_table"][:-1]),
           dict(q=d["q"][:, :, :, :8].contiguous()),
           dict(q=d["q"].double()),
           dict(slow_k=d["slow_k"][:, :1].contiguous())]
    for kw in bad:
        with pytest.raises(ValueError):
            pa_ops.paged_attention_split_op(**{**d, **kw})
    u = _unified(d)
    with pytest.raises(ValueError):
        pa_ops.paged_attention_op(**{**u, "seq_lens": u["seq_lens"].cpu()})
    with pytest.raises(ValueError):
        pa_ops.paged_attention_op(**{**u, "k_pool": u["k_pool"][:, :, :4]})


def _server_cfg(**kw):
    from repro_torch.core.policy import get_policy
    from repro_torch.tiered import kvcache as tk
    base = dict(n_seqs=3, max_pages_per_seq=32, page_tokens=16,
                n_kv_heads=2, head_dim=64, fast_data_slots=6,
                policy=get_policy("threshold", epoch_len=2),
                dtype="bfloat16")
    base.update(kw)
    return tk.TieredConfig(**base)


def _server(cuda, cfg, path):
    from repro_torch.serve.engine import TieredServer
    srv = TieredServer(cfg, path=path, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    for pool in (srv.state.slow_k, srv.state.slow_v):
        pool.copy_(torch.randn(pool.shape, generator=g, device=cuda))
    return srv


@pytest.mark.cuda
def test_server_zero_copy_step_never_waits_for_the_card(cuda):
    """A zero-copy step (append, cached lookup with its iRC probe and iRT
    walk, split read) runs under sync debug mode "error": the host never
    waits for the card."""
    cfg = _server_cfg()
    srv = _server(cuda, cfg, "zero_copy")
    q = torch.randn(3, 2, 4, 64, device=cuda).to(torch.bfloat16)
    kv = torch.randn(3, 2, 64, device=cuda).to(torch.bfloat16)
    pos = torch.tensor([100, 7, -1], dtype=torch.int32, device=cuda)
    srv.step(q, kv, kv, pos)                         # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = srv.step(q, kv, kv, pos + 1)
        out = srv.step(q, kv, kv, 120)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
def test_server_zero_copy_equals_concat_and_fused(cuda):
    """The reference's golden equality on the card: zero-copy (cached)
    equals concat (uncached) bit for bit on live lanes at every step,
    with maintenance and a release between steps; the fused path runs
    the same body and equals them too."""
    import dataclasses
    cfg = _server_cfg()
    paths = {"zero_copy": _server(cuda, cfg, "zero_copy"),
             "concat": _server(cuda, dataclasses.replace(
                 cfg, cache_device_table=False), "concat"),
             "fused": _server(cuda, cfg, "fused")}
    g = torch.Generator(device=cuda).manual_seed(1)
    pos = torch.tensor([300, 40, -1], dtype=torch.int32, device=cuda)
    for step in range(12):
        q = torch.randn(3, 2, 4, 64, generator=g, device=cuda).to(
            torch.bfloat16)
        kv = torch.randn(3, 2, 64, generator=g, device=cuda).to(
            torch.bfloat16)
        outs = {k: s.step(q, kv, kv, pos) for k, s in paths.items()}
        live = pos >= 0
        assert torch.equal(outs["zero_copy"][live], outs["concat"][live])
        assert torch.equal(outs["zero_copy"][live],
                           outs["fused"][:, 0][live])
        pos = torch.where(live, pos + 1, pos)
        if step % 3 == 2:
            for s in paths.values():
                s.maintain()
        if step == 6:
            for s in paths.values():
                s.release(1)
            pos[1] = 0
    c = paths["zero_copy"].counters
    assert c["dev_hits"] > 0 and c["migrations"] > 0


@pytest.mark.cuda
def test_drop_set_duplicate_lanes_keep_the_last_lane_on_the_card(cuda):
    """Many lanes of one batch on one cell, as the iRC fill's lanes of one
    set are: the last lane's tag and its value land together, as on the
    CPU (a CUDA ``index_put_`` alone may keep any lane, and two scatters
    of one batch different lanes)."""
    g = torch.Generator().manual_seed(11)
    n = 4096
    sets = torch.randint(0, 8, (n,), generator=g, dtype=torch.int32)
    ways = torch.randint(0, 3, (n,), generator=g, dtype=torch.int32)
    ids = torch.randperm(n, generator=g).to(torch.int32)
    tag = torch.full((8, 3), -1, dtype=torch.int32)
    want_t = _scatter.drop_set(tag, (sets, ways), ids)
    want_v = _scatter.drop_set(tag, (sets, ways), ids * 2 + 1)
    dev = [t.to(cuda) for t in (tag, sets, ways, ids)]
    got_t = _scatter.drop_set(dev[0], (dev[1], dev[2]), dev[3])
    got_v = _scatter.drop_set(dev[0], (dev[1], dev[2]), dev[3] * 2 + 1)
    assert torch.equal(got_t.cpu(), want_t)
    assert torch.equal(got_v.cpu(), want_v)
    assert torch.equal(got_v, got_t * 2 + 1)


def _flash_inputs(device, B=2, S=96, T=None, H=4, KV=2, hd=16, seed=0,
                  dtype=torch.float32):
    """Seeded model-layout inputs: q [B,S,H,hd], k/v [B,T,KV,hd]."""
    g = torch.Generator().manual_seed(seed)
    T = S if T is None else T
    f = lambda *s: torch.randn(s, generator=g).to(device, dtype)  # noqa: E731
    return f(B, S, H, hd), f(B, T, KV, hd), f(B, T, KV, hd)


def _flash_plain(q, k, v, **kw):
    return attention_ref(q.transpose(1, 2).float(), k.transpose(1, 2).float(),
                         v.transpose(1, 2).float(), **kw).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (True, 24, 0), (False, 0, 0), (True, 0, 64),
    (True, 40, 32)])
def test_flash_kernel_matches_plain(cuda, causal, window, q_offset, hd,
                                    dtype):
    """The flash kernel against ``attention_ref`` on the card, GQA group 2,
    a ragged query tile and a ragged key block (S = 80 rows after
    ``q_offset`` over T = 150 keys): fp32 within 1e-4 (online and full
    softmax sum in other orders), bf16 within two bf16 ulps of each value
    of the plain version computed in fp32 and cast to bf16."""
    q, k, v = _flash_inputs(cuda, S=80, T=150, hd=hd, dtype=dtype,
                            seed=hd + q_offset)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = fa_ops.flash_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    want = _flash_plain(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-4
    else:
        want = want.to(torch.bfloat16).float()
        assert ((got.float() - want).abs() <= bf16_tolerance(want)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 48])
def test_flash_kernel_rows_are_independent_bitwise(cuda, dtype, window):
    """A query row's output is bit for bit the same whatever the call
    around it: rows [s, s+C) of the one-shot call equal the chunk call at
    ``q_offset = s`` for page-aligned (not tile-aligned) s, and a call
    over 2T keys whose extra keys are causally masked equals the call
    over T on every row (chunked prefill == one-shot prefill)."""
    S, C = 256, 48
    q, k, v = _flash_inputs(cuda, B=1, S=S, H=8, KV=2, hd=64, dtype=dtype,
                            seed=5)
    full = fa_ops.flash_attention_op(q, k, v, window=window)
    for s in (0, 16, 48, 112, 208):
        part = fa_ops.flash_attention_op(q[:, s:s + C], k, v, window=window,
                                         q_offset=s)
        assert torch.equal(part, full[:, s:s + C]), s
    k2, v2 = (torch.cat([t, torch.randn_like(t)], dim=1) for t in (k, v))
    wide = fa_ops.flash_attention_op(q, k2, v2, window=window)
    assert torch.equal(wide, full)


@pytest.mark.cuda
def test_flash_kernel_never_reaches_the_plain_version(cuda, monkeypatch):
    """A CUDA tensor launches the kernel (the counter moves) and never
    calls ``attention_ref``; the wrapper raises on what the kernel does
    not take."""
    def boom(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(fa_ops, "attention_ref", boom)
    q, k, v = _flash_inputs(cuda)
    before = fa_ops.launches
    fa_ops.flash_attention_op(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    with pytest.raises(ValueError, match="hd"):
        fa_ops.flash_attention_op(*_flash_inputs(cuda, hd=24))
    with pytest.raises(ValueError, match="dtype"):
        fa_ops.flash_attention_op(*(t.half() for t in (q, k, v)))


# ---------------------------------------------------------------------------
# the redesigned kernels: flash attention on the tensor cores, the paged
# core's page ring and folded merge
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_flash_kernel_gqa_groups(cuda, G, hd, dtype):
    """GQA groups 1, 4 and 8 (the bf16 kernel puts up to 4 heads of a
    group on one K/V tile, and 16-row tiles per head to fill 4 warps),
    causal at q_offset 16 over a ragged key block: bf16 within two ulps
    of each plain value, fp32 (the CUDA-core body) within 1e-4."""
    q, k, v = _flash_inputs(cuda, B=2, S=80, T=150, H=8, KV=8 // G, hd=hd,
                            dtype=dtype, seed=G * hd)
    got = fa_ops.flash_attention_op(q, k, v, q_offset=16)
    want = _flash_plain(q, k, v, q_offset=16)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-4
    else:
        want = want.to(torch.bfloat16).float()
        assert ((got.float() - want).abs() <= bf16_tolerance(want)).all()


@pytest.mark.cuda
def test_flash_kernel_rows_independent_at_main_width(cuda):
    """llama3-8b's attention widths (H 32/8, hd 128, bf16): 256-row chunks
    at q_offsets 16, 272 and 1008 equal the one-shot call's rows bit for
    bit, and causally masked extra keys change no row."""
    S, C = 1280, 256
    q, k, v = _flash_inputs(cuda, B=1, S=S, H=32, KV=8, hd=128,
                            dtype=torch.bfloat16, seed=14)
    full = fa_ops.flash_attention_op(q, k, v)
    for s in (16, 272, 1008):
        part = fa_ops.flash_attention_op(q[:, s:s + C].contiguous(), k, v,
                                         q_offset=s)
        assert torch.equal(part, full[:, s:s + C]), s
    k2, v2 = (torch.cat([t, torch.randn_like(t)], dim=1) for t in (k, v))
    assert torch.equal(fa_ops.flash_attention_op(q, k2, v2), full)


def _fused_from_read(d):
    """The one-token read's store as a fused step: entries from the page
    table (identity slow homes), pos the last stored row, the step's new
    rows the rows already stored there."""
    B, F, P = d["q"].shape[0], d["fast_k"].shape[0], d["fast_k"].shape[2]
    table = d["page_table"]
    pos = (d["seq_lens"] - 1).to(torch.int32)
    p = pos.clamp(min=0).long()
    j, r = p // P, p % P
    slot = table[torch.arange(B, device=p.device), j].long()
    fast = (slot < F)[:, None, None]
    new = [torch.where(fast, f[slot.clamp(max=F - 1), :, r],
                       s[(slot - F).clamp(min=0), :, r])[:, None]
           for f, s in ((d["fast_k"], d["slow_k"]),
                        (d["fast_v"], d["slow_v"]))]
    return dict(q=d["q"][:, None], fast_k=d["fast_k"], fast_v=d["fast_v"],
                slow_k=d["slow_k"], slow_v=d["slow_v"],
                entries=torch.where(table < F, table, -1).to(torch.int32),
                k_new=new[0], v_new=new[1], pos=pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_unified_fused_bitwise_at_main_widths(cuda, dtype):
    """KV 8, G 4, hd 128, page 16 over 40 pages a lane: the split read,
    the unified read of the concatenated pools and the one-token fused
    step run one body and agree bit for bit; the idle lane is zeros."""
    d = _read_inputs(cuda, B=4, KV=8, G=4, hd=128, P=16, NP=40, F=48,
                     seed=15, dtype=dtype)
    split = pa_ops.paged_attention_split_op(**d)
    uni = pa_ops.paged_attention_op(**_unified(d))
    fused = pa_ops.paged_attention_fused_op(**_fused_from_read(d))[:, 0]
    live = d["seq_lens"] > 0
    assert torch.equal(split, uni)
    assert torch.equal(fused[live], split[live])
    assert torch.equal(fused[~live], torch.zeros_like(fused[~live]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 2])
def test_fused_bucket_not_a_multiple_of_split_or_ring(cuda, K, dtype):
    """13 live pages (no multiple of the 8-page split or the 2-stage
    ring) against a 40-page table: the bucket equals the full width bit
    for bit; one lane ends on the ring's last stage (its last live page is
    page 7, the second page of the split's last warp); the parked lane
    is zeros; live lanes match the plain version."""
    P = 16
    d = _inputs(cuda, B=4, K=K, KV=2, G=4, hd=128, P=P, NP=40, F=6,
                seed=16 + K, dtype=dtype, live_pages=13)
    d["pos"][0] = 8 * P - K                # rows end at column 8P-1
    full = pa_ops.paged_attention_fused_op(**d)
    bucket = pa_ops.paged_attention_fused_op(
        **{**d, "entries": d["entries"][:, :13]})
    live = d["pos"] >= 0
    assert torch.equal(bucket[live], full[live])
    assert torch.equal(full[~live], torch.zeros_like(full[~live]))
    ref = paged_attention_fused_ref(
        **{k: (v.float() if v.is_floating_point() else v)
           for k, v in d.items()}).to(dtype).float()
    tol = 1e-4 if dtype == torch.float32 else bf16_tolerance(ref[live])
    assert ((full.float()[live] - ref[live]).abs() <= tol).all()


@pytest.mark.cuda
def test_split_read_bucket_equals_full_width(cuda):
    """The split read over the first 13 table columns (every lane's live
    pages fit) equals the read over all 40 bit for bit."""
    d = _read_inputs(cuda, B=4, KV=2, G=4, hd=128, P=16, NP=40, F=48,
                     seed=17, dtype=torch.bfloat16)
    d["seq_lens"] = d["seq_lens"].clamp(max=13 * 16)
    d["seq_lens"][1] = 8 * 16              # the ring's last stage
    full = pa_ops.paged_attention_split_op(**d)
    bucket = pa_ops.paged_attention_split_op(
        **{**d, "page_table": d["page_table"][:, :13]})
    assert torch.equal(bucket, full)


# ---------------------------------------------------------------------------
# telemetry on the card (the engine at the smoke size: 2 layers)
# ---------------------------------------------------------------------------

# tests/test_flight.py's trace, under a write_aware policy that demotes
# on it (every preset keeps demote_threshold 0)
TRACE = dict(batch=2, max_len=64, backend="tiered", page_tokens=8,
             fast_data_slots=4, maintain_every=2)


def _card_engine(cuda, **ec_kw):
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core.policy import get_policy
    from repro_torch.models import init_params
    from repro_torch.models.kv_backend import TieredBackend
    from repro_torch.serve.engine import Engine, EngineConfig, Request
    cfg = reduce_for_smoke(get_config("llama3-8b"))
    params = init_params(cfg, cuda, seed=2)
    ec = EngineConfig(**TRACE, **ec_kw)
    be = TieredBackend(cfg, ec.batch, ec.max_len, page_tokens=8,
                       fast_data_slots=4,
                       policy=get_policy("write_aware", demote_threshold=16),
                       device=cuda)
    eng = Engine(cfg, params, ec, backend=be, device=cuda)
    rng = np.random.default_rng(3)
    for rid in range(4):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, 4),
                           max_new=8))
    return eng


@pytest.mark.cuda
def test_sample_and_flight_record_never_wait_for_the_card(cuda):
    """A hub sample (the tap's device copies) and the flight record of a
    maintenance pass's descriptors run under sync debug mode "error"."""
    from repro_torch.obs import FlightConfig, ObsConfig
    from repro_torch.obs import flight as fl
    from repro_torch.serve.engine import Request
    eng = _card_engine(cuda, obs=ObsConfig(sample_every=2),
                       flight=FlightConfig(capacity=8))
    state = eng.backend.init_state(2, 64)
    req = Request(rid=0, prompt=np.arange(20) % 512, max_new=4)
    state, tok = eng.prefill_lane(state, 0, req)
    for lane, r in ((1, Request(rid=1, prompt=np.arange(9), max_new=4)),):
        state, _ = eng.prefill_lane(state, lane, r)
    for _ in range(6):                  # touches: the pages turn hot
        state = eng.backend.maintain(state)
        state = state._replace(caches=eng.backend.begin_step(
            state.caches, state.pos)[0])
    plan = eng.backend.plan_maintain(state)
    touch = state.caches.touch
    state, ddesc, pdesc = eng.backend.apply_maintain_desc(state, plan)
    batches = [(fl.K_DEMOTE, fl.C_PLAN_DEMOTE, ddesc["cb1_dst"],
                ddesc["cb1_en"]),
               (fl.K_PROMOTE, fl.C_PLAN_PROMOTE, pdesc["in_src"],
                pdesc["in_en"])]
    eng._lanes_ref = [req, None]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._sample(state, eng._lanes_ref, 0)
        eng._record(batches, 7, touch)
        eng._record(batches, 8, touch)  # the cached kind/cause columns
    finally:
        torch.cuda.set_sync_debug_mode("default")
    stats = eng.flight_stats()
    assert stats["total_events"] == 2 * int(
        pdesc["in_en"].sum() + ddesc["cb1_en"].sum())
    assert stats["total_events"] > 0
    eng._drain_samples()
    assert eng.hub.series[-1]["metrics"]["trimma_migrations_total"] > 0


@pytest.mark.cuda
def test_overlapped_flight_stream_equals_sync_on_the_card(cuda):
    """On the card at 2 layers: the overlapped maintenance records the
    synchronous pass's stream (``score`` aside), the trace demotes, and
    tokens equal a telemetry-off run's."""
    from repro_torch.obs import FlightConfig
    from repro_torch.obs import flight as fl
    streams, tokens = {}, {}
    for overlap in (False, True):
        eng = _card_engine(cuda, flight=FlightConfig(capacity=512),
                           overlap_maintain=overlap)
        tokens[overlap] = [r.tokens for r in eng.run()]
        ev = fl.drain(eng._fl)
        streams[overlap] = {k: ev[k].tolist() for k in fl.FIELDS[:-1]}
        if not overlap:
            assert eng.flight_stats()["by_kind"]["demote"] > 0
    off = _card_engine(cuda)
    assert tokens[True] == tokens[False] == [r.tokens for r in off.run()]
    assert streams[True] == streams[False]


@pytest.mark.cuda
def test_profiler_trace_names_the_fused_kernel(cuda, tmp_path):
    """``ObsConfig.profiler_dir`` wraps the run in ``torch.profiler``: the
    Chrome trace holds the hand-written fused decode kernel."""
    from repro_torch.obs import ObsConfig
    eng = _card_engine(cuda, obs=ObsConfig(profiler_dir=str(tmp_path)))
    eng.run()
    doc = json.loads((tmp_path / "trace.json").read_text())
    kernels = {e["name"] for e in doc["traceEvents"]
               if e.get("cat") == "kernel"}
    assert any("paged_kernel" in k for k in kernels), sorted(kernels)[:20]


class _ParentLoop:
    """The engine loop as it was before telemetry: ``run`` and the
    methods it reaches through the greedy scheduler, on an engine's
    backend and scheduler."""

    def __init__(self, eng):
        self.eng = eng

    @torch.inference_mode()
    def run(self):
        import time as _t

        from repro_torch.models import decode_step
        eng, ec = self.eng, self.eng.ec
        sched = eng.scheduler
        lanes = [None] * ec.batch
        state = eng.backend.init_state(ec.batch, ec.max_len)
        tokens = torch.zeros((ec.batch,), dtype=torch.int32,
                             device=eng.device)
        finished = []
        eng._pending_plan = None
        eng._flush_maintain = self.flush
        eng.release_lane = self.release_lane
        state, tokens = sched.refill(state, tokens, lanes, finished)
        while any(lane is not None for lane in lanes):
            state = self.flush(state)
            n_pages = eng._live_bucket(state.pos.cpu().numpy())
            logits, state = decode_step(eng.cfg, eng.params, state, tokens,
                                        backend=eng.backend, n_pages=n_pages)
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            eng.steps += 1
            if eng.steps % ec.maintain_every == 0:
                eng._pending_plan = eng.backend.plan_maintain(state)
            nxt = tokens.cpu().numpy()
            pos = state.pos.cpu().numpy()
            now = _t.time()
            for i, r in enumerate(lanes):
                if r is None or r.done:
                    continue
                if not r.tokens:
                    r.first_token_at = now
                r.tokens.append(int(nxt[i]))
                if len(r.tokens) >= r.max_new or pos[i] >= ec.max_len - 1:
                    r.done = True
            state, tokens = sched.refill(state, tokens, lanes, finished)
        self.flush(state)
        return finished

    def flush(self, state, **_):
        eng = self.eng
        if eng._pending_plan is None:
            return state
        state = eng.backend.apply_maintain(state, eng._pending_plan)
        eng._pending_plan = None
        L = eng.backend.n_layers
        eng._bw_log.append((int(state.caches.promo_pages) * L,
                            int(state.caches.demo_pages) * L))
        return state

    def release_lane(self, state, lane):
        state = self.flush(state)
        return self.eng.backend.release(state, lane)


@pytest.mark.cuda
def test_telemetry_off_launches_what_the_loop_without_telemetry_did(cuda):
    """With obs, flight and SLOs off the engine launches exactly the
    kernels of the loop without telemetry, over a whole run (greedy
    scheduler, overlapped maintenance, releases and prefills included),
    and decodes the same tokens."""
    from torch.profiler import ProfilerActivity, profile

    def launches(run):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            done = run()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if "LaunchKernel" in e.key)
        return n, [r.tokens for r in done]

    _card_engine(cuda).run()                         # builds and loads
    eng_n, eng_tokens = launches(_card_engine(cuda).run)
    loop_n, loop_tokens = launches(_ParentLoop(_card_engine(cuda)).run)
    assert eng_tokens == loop_tokens
    assert eng_n == loop_n > 0


# ---------------------------------------------------------------------------
# the simulator's scan (sim_scan): kernel against the plain loop, exact
# ---------------------------------------------------------------------------

SIM_GEOM = dict(fast_total_blocks=256, ratio=8, n_sets=4)


def _sim_cases():
    """(label, SimConfig keywords, policy preset or None, policy
    overrides, dealloc hints): both entries, every table scheme and
    remap-cache kind, every preset at short epochs, dealloc hints."""
    table = {
        "trimma_c": ("cache", "irt", "irc"), "trimma_f": ("flat", "irt", "irc"),
        "linear_c": ("cache", "linear", "conventional"),
        "mempod": ("flat", "linear", "conventional"),
        "irt_c_none": ("cache", "irt", "none"),
        "irt_f_ideal": ("flat", "irt", "ideal"),
        "ideal_c": ("cache", "ideal", "ideal"),
    }
    cases = [(name, dict(SIM_GEOM, mode=m, meta=me, remap_cache=rc), None,
              {}, False) for name, (m, me, rc) in table.items()]
    for preset in ("threshold", "mea", "on_demand", "write_aware", "topk",
                   "recency"):
        for name in ("trimma_c", "trimma_f"):
            m, me, rc = table[name]
            cases.append((f"{name}/{preset}",
                          dict(SIM_GEOM, mode=m, meta=me, remap_cache=rc),
                          preset, dict(decay_shift=5), False))
    for name in ("trimma_c", "trimma_f"):
        m, me, rc = table[name]
        cases.append((f"{name}/dealloc", dict(SIM_GEOM, mode=m, meta=me,
                                              remap_cache=rc,
                                              dealloc_hints=True),
                      "mea", dict(decay_shift=5), True))
    for meta, ways in (("alloy", 0), ("lohhill", 0), ("lohhill", 64)):
        cases.append((f"{meta}/{ways}", dict(SIM_GEOM, mode="cache",
                                             meta=meta, remap_cache="none",
                                             n_sets=1, tag_ways=ways),
                      None, {}, False))
    # remap caches wider than a warp, and a fast tier whose slot arrays
    # need more than 48 KB of shared memory
    wide = dict(rc_ways=40, nid_ways=40, id_ways=36)
    cases.append(("trimma_f/wide", dict(SIM_GEOM, mode="flat", meta="irt",
                                        remap_cache="irc", **wide),
                  "on_demand", {}, False))
    cases.append(("linear_c/wide", dict(SIM_GEOM, mode="cache",
                                        meta="linear",
                                        remap_cache="conventional", **wide),
                  None, {}, False))
    cases.append(("trimma_c/large", dict(fast_total_blocks=16384, ratio=2,
                                         n_sets=4, mode="cache", meta="irt",
                                         remap_cache="irc"),
                  None, {}, False))
    return cases


def _sim_inputs(cuda, label, kw, preset, over, dealloc, length=320):
    from repro_torch import core as P
    if preset is not None:
        kw = dict(kw, policy=P.get_policy(preset, **over))
    cfg = P.SimConfig(**kw).validate()
    bs, ws = [], []
    for wl in ("pr", "xz", "lbm"):
        b, w = P.generate_trace(P.WORKLOADS[wl], cfg.slow_blocks, length, 1)
        bs.append(P.relabel_first_touch(b) if cfg.mode == "flat" else b)
        ws.append(w)
    blocks = torch.as_tensor(np.stack(bs).astype(np.int32), device=cuda)
    writes = torch.as_tensor(np.stack(ws), device=cuda)
    deallocs = torch.as_tensor(
        np.stack([P.with_deallocs(b, 0.05, seed=i) for i, b in enumerate(bs)])
        if dealloc else np.zeros((3, length), bool), device=cuda)
    return cfg, blocks, writes, deallocs


def _sim_state(cfg, T, cuda):
    from repro_torch.core import simulator as sim
    g = None if cfg.meta in ("alloy", "lohhill") else sim.make_geometry(cfg)
    return sim.init_state(cfg, g, T, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _sim_cases(), ids=lambda c: c[0])
def test_sim_scan_kernel_matches_plain(cuda, case):
    """Every key of the end state (remap, slots, leaves, FIFO pointers,
    remap cache, trackers, counters) equal to the plain loop's on the
    card, three traces of 320 accesses in one launch."""
    from repro_torch.core import HBM3_DDR5
    from repro_torch.kernels.sim_scan import ops as ss_ops
    from repro_torch.kernels.sim_scan.ref import sim_scan_ref
    cfg, b, w, d = _sim_inputs(cuda, *case)
    kern = _sim_state(cfg, 3, cuda)
    plain = {k: v.clone() for k, v in kern.items()}
    before = ss_ops.launches
    ss_ops.sim_scan_op(cfg, HBM3_DDR5, kern, b, w, d)
    assert ss_ops.launches == before + 1
    sim_scan_ref(cfg, HBM3_DDR5, plain, b, w, d)
    torch.cuda.synchronize()
    for k in plain:
        assert torch.equal(kern[k], plain[k]), k
    assert int(kern["counters"][:, 0].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["trimma_c/topk", "trimma_f/mea",
                                   "lohhill/64"])
def test_sim_scan_ranges_equal_one_launch(cuda, label):
    """[0, 97) then [97, 320) in two launches == [0, 320) in one, an
    epoch edge inside each range."""
    from repro_torch.core import HBM3_DDR5
    from repro_torch.kernels.sim_scan import ops as ss_ops
    case = next(c for c in _sim_cases() if c[0] == label)
    cfg, b, w, d = _sim_inputs(cuda, *case)
    one = _sim_state(cfg, 3, cuda)
    two = {k: v.clone() for k, v in one.items()}
    ss_ops.sim_scan_op(cfg, HBM3_DDR5, one, b, w, d)
    ss_ops.sim_scan_op(cfg, HBM3_DDR5, two, b, w, d, 0, 97)
    ss_ops.sim_scan_op(cfg, HBM3_DDR5, two, b, w, d, 97, 320)
    for k in one:
        assert torch.equal(one[k], two[k]), k


@pytest.mark.cuda
def test_sim_scan_reproduces_golden_counters(cuda):
    """tests/golden/sim_counters.json through run on the card."""
    from repro_torch import core as P
    with open(Path(__file__).parent / "golden" / "sim_counters.json") as f:
        want = json.load(f)
    small = dict(fast_total_blocks=512, ratio=8, n_sets=4)
    schemes = {
        "trimma_c": P.trimma_cache(**small), "trimma_f": P.trimma_flat(**small),
        "linear_c": P.linear_cache(**small), "mempod": P.mempod(**small),
        "alloy": P.alloy(**{**small, "n_sets": 1}),
        "lohhill": P.lohhill(**{**small, "n_sets": 1}),
        "ideal_c": P.ideal("cache", **small)}
    for name, cfg in schemes.items():
        blocks, writes = P.generate_trace(P.WORKLOADS["pr"],
                                          cfg.slow_blocks, 4096, 0)
        if cfg.mode == "flat":
            blocks = P.relabel_first_touch(blocks)
        out = P.run(cfg, P.HBM3_DDR5, blocks, writes, device=cuda)
        got = {k: int(out[k]) for k in want[name]}
        assert got == want[name], name


@pytest.mark.cuda
def test_sim_scan_rejects_what_it_does_not_take(cuda):
    from repro_torch.core import HBM3_DDR5
    from repro_torch.kernels.sim_scan import ops as ss_ops
    case = next(c for c in _sim_cases() if c[0] == "trimma_c")
    cfg, b, w, d = _sim_inputs(cuda, *case)
    st = _sim_state(cfg, 3, cuda)
    with pytest.raises(ValueError, match="blocks"):
        ss_ops.sim_scan_op(cfg, HBM3_DDR5, st, b.long(), w, d)
    with pytest.raises(ValueError, match="writes"):
        ss_ops.sim_scan_op(cfg, HBM3_DDR5, st, b, w.int(), d)
    with pytest.raises(ValueError, match="remap"):
        ss_ops.sim_scan_op(cfg, HBM3_DDR5, {**st, "remap": st["remap"].cpu()},
                           b, w, d)
    with pytest.raises(ValueError, match="remap"):
        ss_ops.sim_scan_op(cfg, HBM3_DDR5, {**st, "remap": st["remap"][:2]},
                           b, w, d)
    with pytest.raises(ValueError, match="keys"):
        ss_ops.sim_scan_op(cfg, HBM3_DDR5,
                           {k: v for k, v in st.items() if k != "step"},
                           b, w, d)
    with pytest.raises(ValueError, match="range"):
        ss_ops.sim_scan_op(cfg, HBM3_DDR5, st, b, w, d, 10, 5)


# the hazard traces of tests/sim_hazards.py: the kernel keeps 32 accesses'
# state in registers, patched by every store and reloaded at every tick

def _hazard_run(cuda, case, ranges, **trace_kw):
    """The kernel over ``ranges`` (one launch each) and the plain loop over
    the whole trace, from the same fresh state: (kernel state, plain
    state, launches)."""
    from repro_torch.core import HBM3_DDR5
    from repro_torch.kernels.sim_scan import ops as ss_ops
    from repro_torch.kernels.sim_scan.ref import sim_scan_ref
    cfg = hz.config(case)
    blocks, writes, deallocs, _ = hz.trace(case, **trace_kw)
    b, w, d = (torch.as_tensor(x, device=cuda)
               for x in (blocks, writes, deallocs))
    kern = _sim_state(cfg, b.shape[0], cuda)
    plain = {k: v.clone() for k, v in kern.items()}
    before = ss_ops.launches
    for start, end in ranges:
        ss_ops.sim_scan_op(cfg, HBM3_DDR5, kern, b, w, d, start, end)
    sim_scan_ref(cfg, HBM3_DDR5, plain, b, w, d)
    torch.cuda.synchronize()
    return kern, plain, ss_ops.launches - before


def _assert_states_equal(kern, plain):
    for k in plain:
        assert torch.equal(kern[k], plain[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", hz.cases(), ids=lambda c: c[0])
def test_sim_hazard_kernel_matches_plain(cuda, case):
    """Every key of the end state equal to the plain loop's, two traces
    of 256 accesses in one launch."""
    kern, plain, n = _hazard_run(cuda, case, [(0, hz.LENGTH)])
    assert n == 1
    _assert_states_equal(kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["swap_fb_next/trimma_f",
                                   "sector_next/trimma_c", "tick0/topk",
                                   "dealloc/trimma_f"])
def test_sim_hazard_ranges_split_inside_a_batch(cuda, label):
    """[0, 1), [1, 33), [33, 250) in three launches (250 % 32 != 0; each
    split falls inside a batch of the launch before) == the plain loop
    over [0, 250)."""
    kern, plain, n = _hazard_run(cuda, hz.case(label),
                                 [(0, 1), (1, 33), (33, 250)], length=250)
    assert n == 3
    _assert_states_equal(kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("n_traces", [1, 133])
@pytest.mark.parametrize("label", ["repeat/trimma_c", "tick1/mea",
                                   "dealloc/trimma_c"])
def test_sim_hazard_trace_counts(cuda, label, n_traces):
    """One trace, and 133 (more blocks than the card has SMs)."""
    kern, plain, n = _hazard_run(cuda, hz.case(label), [(0, hz.LENGTH)],
                                 n_traces=n_traces, seed=n_traces)
    assert n == 1 and kern["counters"].shape[0] == n_traces
    _assert_states_equal(kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["sector_next/trimma_f", "tick2/recency",
                                   "repeat/linear_c"])
def test_sim_hazard_two_launches_equal(cuda, label):
    """Two launches from the same state give the same state bit for
    bit."""
    one, _, _ = _hazard_run(cuda, hz.case(label), [(0, hz.LENGTH)])
    two, _, _ = _hazard_run(cuda, hz.case(label), [(0, hz.LENGTH)])
    _assert_states_equal(one, two)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["on_demand", "threshold", "mea"])
@pytest.mark.parametrize("mode", ["cache", "flat"])
@pytest.mark.parametrize("rc", ["irc", "conventional", "none", "ideal"])
def test_sim_scan_every_kernel_variant(cuda, rc, mode, preset):
    """Each compiled variant of the remap-table kernel (remap-cache kind x
    mode x policy kind: untracked, the touch tracker with a threshold,
    any other tracker) equals the plain loop in every state key."""
    from repro_torch import core as P
    from repro_torch.core import HBM3_DDR5
    from repro_torch.kernels.sim_scan import ops as ss_ops
    from repro_torch.kernels.sim_scan.ref import sim_scan_ref
    # threshold 2 keeps the touch tracker in cache mode too
    over = dict(install_threshold=2) if preset == "threshold" else {}
    cfg = P.SimConfig(**SIM_GEOM, mode=mode, meta="irt", remap_cache=rc,
                      policy=P.get_policy(preset, decay_shift=3, **over)
                      ).validate()
    bs, ws = [], []
    for wl in ("pr", "xz"):
        b, w = P.generate_trace(P.WORKLOADS[wl], cfg.slow_blocks, 160, 2)
        bs.append(P.relabel_first_touch(b) if mode == "flat" else b)
        ws.append(w)
    b = torch.as_tensor(np.stack(bs).astype(np.int32), device=cuda)
    w = torch.as_tensor(np.stack(ws), device=cuda)
    d = torch.zeros_like(w)
    kern = _sim_state(cfg, 2, cuda)
    plain = {k: v.clone() for k, v in kern.items()}
    ss_ops.sim_scan_op(cfg, HBM3_DDR5, kern, b, w, d)
    sim_scan_ref(cfg, HBM3_DDR5, plain, b, w, d)
    torch.cuda.synchronize()
    _assert_states_equal(kern, plain)


@pytest.mark.cuda
def test_sim_scan_chase_orders_the_latencies(cuda):
    """The chain's yardstick: a dependent shared-memory load is faster
    than a dependent load through L2, and both take time."""
    from repro_torch.kernels.sim_scan import ops as ss_ops
    smem = ss_ops.sim_scan_chase_op("smem", cuda)
    l2 = ss_ops.sim_scan_chase_op("l2", cuda)
    assert 0 < smem["ns"] < l2["ns"]
    assert 0 < smem["cycles"] < l2["cycles"]


@pytest.mark.cuda
def test_sim_scan_builds_without_spills(cuda):
    """ptxas (``-Xptxas -v``) reports no spills for any entry of the
    library (one compiled body serves every case above)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.sim_scan import ops as ss_ops
    _build.load("sim_scan", ss_ops._bind)
    lines = [ln for ln in _build.build_log("sim_scan").splitlines()
             if "spill" in ln]
    assert len(lines) >= 3
    for ln in lines:
        assert "0 bytes spill stores, 0 bytes spill loads" in ln, ln


# ---------------------------------------------------------------------------
# the other decoder families (QKV-bias dense, MoE, the sliding window) on
# the card: their group sizes through the kernels, and the smoke configs
# with their real group sizes through the decoder and the engine
# ---------------------------------------------------------------------------

FAMILY_GROUPS = {"qwen2-7b": 7, "granite-moe-3b-a800m": 3,
                 "mixtral-8x22b": 6, "codeqwen1.5-7b": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd", [(8, 3, 64), (4, 7, 128), (32, 1, 128),
                                     (8, 6, 128)])
def test_fused_kernel_family_groups(cuda, KV, G, hd, dtype):
    """The fused read at the families' (KV, G, hd), K=1, page 16: fp32
    within 1e-4, bf16 within two ulps of each plain value."""
    d = _inputs(cuda, B=4, K=1, KV=KV, G=G, hd=hd, P=16, NP=4, F=6,
                seed=KV * G + hd, dtype=dtype)
    out = pa_ops.paged_attention_fused_op(**d).float()
    ref = paged_attention_fused_ref(
        **{k: (v.float() if v.is_floating_point() else v)
           for k, v in d.items()}).to(dtype).float()
    live = d["pos"] >= 0
    tol = 1e-4 if dtype == torch.float32 else bf16_tolerance(ref[live])
    assert ((out[live] - ref[live]).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd,window", [(24, 8, 64, 0), (28, 4, 128, 0),
                                             (48, 8, 128, 64)])
def test_flash_kernel_family_groups(cuda, H, KV, hd, window, dtype):
    """Flash at the families' head layouts (G 3, 7 and 6, mixtral's with
    a window shorter than the keys), causal at q_offset 16 over a ragged
    key block: fp32 within 1e-4, bf16 within two ulps."""
    q, k, v = _flash_inputs(cuda, B=1, S=80, T=150, H=H, KV=KV, hd=hd,
                            dtype=dtype, seed=H + hd)
    kw = dict(q_offset=16, window=window)
    got = fa_ops.flash_attention_op(q, k, v, **kw)
    want = _flash_plain(q, k, v, **kw)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-4
    else:
        want = want.to(torch.bfloat16).float()
        assert ((got.float() - want).abs() <= bf16_tolerance(want)).all()


def _family_models(arch, device):
    """The fp32 smoke config of ``arch`` with its real group size, seeded
    weights (random non-zero QKV biases where it has them) on ``device``."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import init_params
    cfg = reduce_for_smoke(get_config(arch))
    cfg = dataclasses.replace(
        cfg, n_heads=cfg.n_kv_heads * FAMILY_GROUPS[arch])
    params = init_params(cfg, "cpu", seed=5)
    if cfg.qkv_bias:
        g = torch.Generator().manual_seed(6)
        for name in ("bq", "bk", "bv"):
            b = params["blocks"]["attn"][name]
            b.copy_(torch.randn(b.shape, generator=g) * 0.5)
    return cfg, _to(params, device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(FAMILY_GROUPS))
def test_family_decode_card_equals_plain(cuda, arch):
    """Prefill two lanes, park a third, 12 teacher-forced decode steps
    (tiered with maintenance; mixtral, windowed, dense) on the card and on
    the CPU from the same weights: logits within 1e-4 (the kernels and
    the plain versions sum in other orders)."""
    from repro_torch.core.policy import get_policy
    from repro_torch.models import decode_step, forward
    from repro_torch.models.kv_backend import DenseBackend, TieredBackend
    out = []
    for dev in (cuda, torch.device("cpu")):
        cfg, params = _family_models(arch, dev)
        be = DenseBackend(cfg, dev) if cfg.sliding_window else TieredBackend(
            cfg, 3, 64, page_tokens=8, fast_data_slots=4,
            policy=get_policy("threshold", epoch_len=2), device=dev)
        st = be.init_state(3, 64)
        rng = np.random.default_rng(7)
        for lane, n in ((0, 13), (1, 21)):
            toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)),
                                   device=dev)
            _, _, (k, v) = forward(cfg, params, {"tokens": toks},
                                   collect_cache=True)
            st = be.write_prefill(st, lane, k[:, 0], v[:, 0], n)
        rows = []
        for i in range(12):
            st = st._replace(pos=torch.where(
                torch.arange(3, device=dev) == 2, -1, st.pos))
            tok = torch.as_tensor(rng.integers(0, cfg.vocab, 3),
                                  dtype=torch.int32, device=dev)
            lg, st = decode_step(cfg, params, st, tok, backend=be)
            rows.append(lg[:2].cpu())
            if i % 3 == 2 and not cfg.sliding_window:
                st = be.maintain(st)
        out.append(torch.stack(rows))
    assert (out[0] - out[1]).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-3b-a800m"])
def test_family_engine_serves_on_the_card(cuda, arch):
    """The tiered engine serves 4 requests of the family's smoke config on
    the card: every request finished, one fused launch per layer and
    decode step, the metadata back to identity."""
    from repro_torch.core.remap.irt import INVALID
    from repro_torch.serve.engine import Engine, EngineConfig, Request
    cfg, params = _family_models(arch, cuda)
    eng = Engine(cfg, params, EngineConfig(**TRACE), device=cuda)
    rng = np.random.default_rng(8)
    for rid in range(4):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, 9),
                           max_new=8))
    before = pa_ops.launches
    done = eng.run()
    assert len(done) == 4 and all(len(r.tokens) == 8 for r in done)
    assert pa_ops.launches - before == eng.steps * cfg.n_layers
    st = eng.final_state.caches
    assert bool((st.leaf_table == INVALID).all())


@pytest.mark.cuda
def test_moe_ffn_never_waits_for_the_card(cuda):
    """The MoE FFN (routing, dispatch, the scatter into the expert buffers
    with drops, the expert products, the combine) runs with no host
    synchronisation (sync debug mode raises on one) and equals the plain
    run on the CPU: routing exactly, y within 1e-5 (fp32)."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import init_params, moe
    cfg = dataclasses.replace(reduce_for_smoke(get_config(
        "granite-moe-3b-a800m")), n_experts=8, top_k=2)
    p = init_params(cfg, "cpu", seed=4)["blocks"]["moe"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn(3, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5))
    want, want_aux = moe.moe_ffn(p, x, cfg)
    pc, xc = _to(p, cuda), x.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, aux = moe.moe_ffn(pc, xc, cfg)
        _, eidx, _ = moe.route(pc, xc.reshape(-1, cfg.d_model), cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _, want_eidx, _ = moe.route(p, x.reshape(-1, cfg.d_model), cfg)
    assert torch.equal(eidx.cpu(), want_eidx)
    assert (got.cpu() - want).abs().max().item() <= 1e-5
    assert abs(aux.item() - want_aux.item()) <= 1e-6


RECURRENT = ("hymba-1.5b", "xlstm-125m")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_forward_and_decode_card_equals_plain(cuda, arch):
    """The fp32 smoke config (hymba: windowed and global layers, flash in
    prefill; xlstm: mLSTM and sLSTM) on the card and on the CPU from the
    same weights: ``forward`` over 2 lanes of 40 tokens, then 8 decode
    steps over the dense backend from the cold prefill state, lane 1
    parked; logits within 1e-4 (the kernel and the plain versions, cuBLAS
    and the CPU sum in other orders)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.kv_backend import DenseBackend
    cfg = reduce_for_smoke(get_config(arch))
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 40)), dtype=torch.int32)
    before = fa_ops.launches
    out = []
    for dev in (cuda, torch.device("cpu")):
        params = _to(init_params(cfg, "cpu", seed=4), dev)
        logits, st = prefill(cfg, params, {"tokens": toks.to(dev)},
                             max_len=48)
        be, rows = DenseBackend(cfg, dev), [logits.cpu()]
        for i in range(8):
            st = st._replace(pos=torch.where(
                torch.arange(2, device=dev) == 1, -1, st.pos))
            lg, st = decode_step(cfg, params, st, toks[:, i].to(dev),
                                 backend=be)
            rows.append(lg[:1].cpu())
        out.append(rows)
    if cfg.family == "hybrid":
        assert fa_ops.launches - before == cfg.n_layers
    for got, want in zip(*out):
        assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["ssm", "mlstm", "slstm"])
def test_recurrent_identities_on_the_card(cuda, form):
    """The recurrent form against the parallel one on the card at smoke
    size, fp32, 24 steps: ``ssm_step`` against ``ssm_scan`` and
    ``mlstm_step`` from m = -1e30 against ``mlstm_parallel`` within 2e-3
    (the reference's tolerances), ``slstm_step`` against ``slstm_scan``
    within 1e-4; and each parallel form on the card within 1e-4 of the
    CPU's."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import ssm, xlstm
    arch = "hymba-1.5b" if form == "ssm" else "xlstm-125m"
    cfg = reduce_for_smoke(get_config(arch))
    g = torch.Generator().manual_seed(9)
    init = ssm.ssm_init if form == "ssm" else xlstm.xlstm_init
    p = {k: v[0].to(cuda) for k, v in init(g, cfg, "cpu").items()}
    width = 2 * cfg.d_model if form == "ssm" else cfg.d_model
    x = (torch.randn((2, 24, width), generator=g) * 0.3).to(cuda)
    H = cfg.n_heads
    hd = cfg.d_model // H
    if form == "ssm":
        par, step = (lambda p, x: ssm.ssm_scan(p, x, cfg)), ssm.ssm_step
        st, extra, tol = ssm.ssm_state_init(cfg, 2, cuda), (cfg,), 2e-3
    elif form == "mlstm":
        par, step, extra, tol = xlstm.mlstm_parallel, xlstm.mlstm_step, (), \
            2e-3
        st = {"C": torch.zeros((2, H, hd, hd), device=cuda),
              "n": torch.zeros((2, H, hd), device=cuda),
              "m": torch.full((2, H), -1e30, device=cuda)}
    else:
        par, step, extra, tol = xlstm.slstm_scan, xlstm.slstm_step, (), 1e-4
        st = xlstm.slstm_state_init(2, H, hd, cuda)
    full = par(p, x)
    outs = []
    for t in range(x.shape[1]):
        o, st = step(p, x[:, t:t + 1], st, *extra)
        outs.append(o)
    assert (torch.cat(outs, 1) - full).abs().max().item() <= tol
    cpu = par({k: v.cpu() for k, v in p.items()}, x.cpu())
    assert (full.cpu() - cpu).abs().max().item() <= 1e-4


# ---------------------------------------------------------------------------
# the vlm and audio families: flash non-causal over image keys and at hd 80
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd,S,T", [
    (16, 2, 128, 37, 1601),      # the vlm's cross-attention, image keys
    (16, 2, 128, 1, 1601),       # ... one decode row
    (4, 4, 80, 150, 150),        # hubert's MHA at hd 80
    (4, 4, 80, 64, 1601)])
def test_flash_kernel_non_causal(cuda, H, KV, hd, S, T, dtype):
    """Non-causal calls with T != S and T not a multiple of the 64-key
    block (1601: one real key in the last block), and hubert's head dim
    80 with one head a GQA group: fp32 within 1e-4, bf16 within two ulps
    of each plain value."""
    q, k, v = _flash_inputs(cuda, B=2, S=S, T=T, H=H, KV=KV, hd=hd,
                            dtype=dtype, seed=S + T + hd)
    got = fa_ops.flash_attention_op(q, k, v, causal=False)
    want = _flash_plain(q, k, v, causal=False)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-4
    else:
        want = want.to(torch.bfloat16).float()
        assert ((got.float() - want).abs() <= bf16_tolerance(want)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cross_rows_independent_of_padded_keys(cuda, dtype):
    """Over 1601 image keys: one query row alone (at its own position)
    equals that row of the 40-row call, and a causal call at q_offset
    1600 over keys padded to 3202 (the extra ones garbage, masked)
    equals the non-causal call over the 1601, bit for bit."""
    T = 1601
    q, k, v = _flash_inputs(cuda, B=2, S=40, T=T, H=16, KV=2, hd=128,
                            dtype=dtype, seed=11)
    full = fa_ops.flash_attention_op(q, k, v, causal=False)
    for i in (0, 17, 39):
        row = fa_ops.flash_attention_op(q[:, i:i + 1].contiguous(), k, v,
                                        causal=False, q_offset=i)
        assert torch.equal(row, full[:, i:i + 1]), i
    k2, v2 = (torch.cat([t, torch.randn_like(t)], dim=1) for t in (k, v))
    one = fa_ops.flash_attention_op(q[:, :1].contiguous(), k, v, causal=False)
    padded = fa_ops.flash_attention_op(q[:, :1].contiguous(), k2, v2,
                                       causal=True, q_offset=T - 1)
    assert torch.equal(padded, one)


@pytest.mark.cuda
def test_cross_attention_takes_image_kv_in_the_query_dtype(cuda):
    """On a card the cross-attention core is the flash kernel, which takes
    K/V only in q's dtype: fp32 image K/V under a bf16 model raise (the
    CPU promotes, as the reference does)."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import attention, init_params
    cfg = dataclasses.replace(reduce_for_smoke(get_config(
        "llama-3.2-vision-90b")), dtype="bfloat16")
    p = {k: v[0] for k, v in _to(init_params(cfg, "cpu", seed=1)["blocks"]
                                 ["cross"]["attn"], cuda).items()}
    img = torch.randn(2, cfg.n_image_tokens, cfg.d_model, device=cuda)
    ikv = attention.image_kv(p, img, cfg)
    x = torch.randn(2, 3, cfg.d_model, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="flash_attention"):
        attention.cross_attention(p, x, ikv, cfg)
    ikv = attention.image_kv(p, img.bfloat16(), cfg)
    assert attention.cross_attention(p, x, ikv, cfg).dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "hubert-xlarge"])
def test_vlm_and_audio_card_equals_plain(cuda, arch):
    """The fp32 smoke config on the card and on the CPU from the same
    weights (vlm: the cross gates set to 0.5): vlm prefill of 2 lanes of
    20 tokens over 16 image tokens, then 6 decode steps over the dense
    backend, flash launched once a self and once a cross layer in
    prefill and once a cross layer a decode step; hubert's forward over
    2 lanes of 70 frames, flash once a layer.  Logits within 1e-4."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import decode_step, forward, init_params, prefill
    cfg = reduce_for_smoke(get_config(arch))
    rng = np.random.default_rng(12)
    params = init_params(cfg, "cpu", seed=13)
    if cfg.family == "vlm":
        params["blocks"]["cross"]["attn"]["gate"].fill_(0.5)
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 20)),
                                           dtype=torch.int32),
                 "image_embeds": torch.randn(
                     2, cfg.n_image_tokens, cfg.d_model,
                     generator=torch.Generator().manual_seed(14))}
    else:
        batch = {"embeds": torch.randn(
            2, 70, cfg.d_model, generator=torch.Generator().manual_seed(14))}
    out = []
    for dev in (cuda, torch.device("cpu")):
        p = _to(params, dev)
        b = {k: t.to(dev) for k, t in batch.items()}
        before = fa_ops.launches
        if cfg.family == "audio":
            out.append([forward(cfg, p, b)[0].cpu()])
            launched = cfg.n_layers
        else:
            logits, st = prefill(cfg, p, b, max_len=26)
            rows = [logits.cpu()]
            for i in range(6):
                lg, st = decode_step(cfg, p, st, b["tokens"][:, i])
                rows.append(lg.cpu())
            out.append(rows)
            launched = cfg.n_layers + 6 * (cfg.n_layers //
                                           cfg.cross_attn_every)
        if dev.type == "cuda":
            assert fa_ops.launches - before == launched
    for got, want in zip(*out):
        assert (got - want).abs().max().item() <= 1e-4


# --- flash attention's backward and training on the card ---------------------

def _bwd_inputs(device, B, S, T, H, KV, hd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g).to(device, dtype)  # noqa: E731
    return f(B, S, H, hd), f(B, T, KV, hd), f(B, T, KV, hd), f(B, S, H, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H,KV,S,T,causal,window,q_offset", [
    (64, 4, 4, 70, 70, True, 0, 0),          # G 1, a ragged row block
    (128, 8, 2, 40, 97, True, 0, 57),        # G 4, a q_offset, ragged T
    (64, 5, 1, 130, 130, True, 24, 0),       # G 5, a window
    (80, 4, 2, 65, 150, False, 0, 0),        # hd 80, non-causal
    (128, 8, 2, 33, 65, False, 0, 0),        # a 1-key last block
    (128, 8, 2, 200, 200, True, 0, 0),       # G 4, 4 key blocks, ragged
    (128, 8, 2, 150, 330, True, 0, 180),     # S < T, q_offset, 6 blocks
    (16, 4, 2, 100, 100, True, 0, 0),        # hd 16
    (32, 6, 3, 90, 90, True, 40, 0)],        # hd 32, a window
    ids=["g1", "g4-offset", "g5-window", "hd80-noncausal", "tail1",
         "g4-ragged-blocks", "offset-blocks", "hd16", "hd32-window"])
def test_flash_backward_matches_plain(cuda, dtype, hd, H, KV, S, T, causal,
                                      window, q_offset):
    """dq, dk, dv from the backward kernel against ``attention_bwd_ref``
    (fp32, from the same inputs, the forward kernel's o and lse): fp32
    within 1e-4 of each gradient's max |value|, bf16 within 5e-3 (rounding
    an output to bf16 moves it by up to 2^-8 of its value); lse within
    1e-5 of
    ``torch.logsumexp`` over the masked fp32 scores; the forward's out
    the same bits with and without the lse store."""
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref)
    q, k, v, do = _bwd_inputs(cuda, 2, S, T, H, KV, hd, dtype, seed=hd + S)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse, _ = fa_ops._forward(q, k, v, causal, window, q_offset,
                                with_lse=True)
    assert torch.equal(o, fa_ops.flash_attention_op(q, k, v, **kw))
    t = lambda x: x.transpose(1, 2).float()  # noqa: E731
    want_lse = attention_lse_ref(t(q), t(k), **kw)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    before = fa_ops.bwd_launches
    got = fa_ops.flash_attention_bwd_op(q, k, v, o, do, lse, **kw)
    assert fa_ops.bwd_launches == before + 1
    want = attention_bwd_ref(t(q), t(k), t(v), t(o), t(do), lse, **kw)
    rel = 1e-4 if dtype == torch.float32 else 5e-3
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = w.transpose(1, 2)
        assert a.dtype == dtype and a.shape == w.shape, name
        err = (a.float() - w).abs().max().item()
        assert err <= rel * w.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_gradients_and_determinism(cuda, dtype):
    """``flash_attention_op`` on inputs that require a gradient goes
    through ``FlashAttention``: one forward and one backward launch, the
    gradients the same bits on a second run (no atomics; in bf16 the
    tensor-core kernels), and fp32 within 1e-4 of autograd through
    ``attention_ref``, bf16 within 5e-3 of each gradient's max of
    ``attention_bwd_ref`` (fp32, from the forward kernel's o and lse)."""
    q, k, v, do = _bwd_inputs(cuda, 2, 96, 96, 8, 2, 64, dtype, 7)
    runs = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        f0, b0 = fa_ops.launches, fa_ops.bwd_launches
        out = fa_ops.flash_attention_op(*leaves, causal=True, window=32)
        out.backward(do)
        assert (fa_ops.launches - f0, fa_ops.bwd_launches - b0) == (1, 1)
        runs.append([x.grad for x in leaves])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    if dtype == torch.bfloat16:
        from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
        o, lse, _ = fa_ops._forward(q, k, v, True, 32, 0, with_lse=True)
        want = attention_bwd_ref(*(t(x).float() for x in (q, k, v, o, do)),
                                 lse, causal=True, window=32)
        for a, w in zip(runs[0], want):
            w = t(w)
            assert a.dtype == dtype and a.shape == w.shape
            err = (a.float() - w).abs().max().item()
            assert err <= 5e-3 * w.abs().max().item(), err
        return
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    t(attention_ref(*(t(x) for x in leaves), causal=True,
                    window=32)).backward(do)
    for a, x in zip(runs[0], leaves):
        torch.testing.assert_close(a, x.grad, rtol=0,
                                   atol=1e-4 * x.grad.abs().max().item())


@pytest.mark.cuda
def test_flash_backward_refuses_what_it_does_not_take(cuda):
    q, k, v, do = _bwd_inputs(cuda, 1, 16, 16, 2, 2, 64, torch.float32, 1)
    o, lse, _ = fa_ops._forward(q, k, v, True, 0, 0, with_lse=True)
    with pytest.raises(ValueError, match="do"):
        fa_ops.flash_attention_bwd_op(q, k, v, o, do.bfloat16(), lse)
    with pytest.raises(ValueError, match="lse"):
        fa_ops.flash_attention_bwd_op(q, k, v, o, do, lse[:, :1])
    do8 = torch.empty(do.numel() + 2, device=cuda)[2:].view(do.shape)
    with pytest.raises(ValueError, match="q and do must be 16-byte"):
        fa_ops.flash_attention_bwd_op(q, k, v, o, do8.copy_(do), lse)
    q2, k2, v2, do2 = _bwd_inputs(cuda, 1, 16, 16, 2, 2, 48, torch.float32, 1)
    with pytest.raises(ValueError, match="hd"):
        fa_ops.flash_attention_bwd_op(q2, k2, v2, q2, do2, lse)


@pytest.mark.cuda
def test_fit_step_on_the_card(cuda, tmp_path):
    """One ``fit`` step of the tiny llama on the card: finite loss and
    gnorm, one flash forward and one backward launch per layer, a
    checkpoint written; the first loss near ln(V) (random weights)."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.loop import TrainConfig, fit
    from repro_torch.train.optimizer import OptConfig

    cfg = dataclasses.replace(reduce_for_smoke(get_config("llama3-8b")),
                              n_layers=2, d_model=64, vocab=256)
    dc = DataConfig(vocab=256, seq_len=32, global_batch=4, seed=7)
    oc = OptConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    tc = TrainConfig(steps=1, ckpt_dir=str(tmp_path), log_every=1)
    f0, b0 = fa_ops.launches, fa_ops.bwd_launches
    m = fit(cfg, dc, oc, tc, log=lambda s: None, device=cuda)
    assert (fa_ops.launches - f0, fa_ops.bwd_launches - b0) == (2, 2)
    assert np.isfinite(m["loss"]) and np.isfinite(m["gnorm"])
    assert abs(m["loss"] - np.log(256)) < 0.5, m
    from repro_torch.ckpt.manager import CheckpointManager
    assert CheckpointManager(str(tmp_path)).latest_step() == 1
