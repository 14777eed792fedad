"""The port's CUDA kernels against their plain versions, on a card.

This file imports neither JAX nor the reference package, so it runs on
the card's machine:  PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py.  Without a card every test skips."""

import numpy as np
import pytest
import torch

from repro_torch import _scatter
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import (
    bf16_tolerance, paged_attention_fused_ref)
from repro_torch.kernels.remap_gather import ops as rg_ops
from repro_torch.kernels.remap_gather.ref import remap_gather_ref


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
