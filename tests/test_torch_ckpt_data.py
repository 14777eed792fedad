"""The port's training substrate against the JAX reference: the data
pipeline (bit for bit), checkpoints (the same on-disk format, manifests
and hashes; round trip, async saves with retention, corruption, atomic
publish; bfloat16 leaves as raw words), AdamW (``apply_updates``,
``schedule``, ``global_norm`` over 5 steps), int8 error-feedback
compression, and flash attention's plain backward against autograd.

Tolerances: the optimizer's fp32 leaves (parameters and moments) within
1e-6 of each leaf's max |value| (the two frameworks sum the global norm
in other orders and may fuse a multiply-add where the other rounds
twice; a moment that passes near zero keeps that absolute error, not its
relative size), bf16 leaves
within one bf16 ulp (the fp32 update rounds to the nearest bf16 on both
sides); the plain backward within 1e-5 of each gradient's max |value|
(fp32, the same formulas in another association)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as JManager
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as j_make_batch
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, device_batch, make_batch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)
from repro_torch.train import compression
from repro_torch.train.optimizer import (OptConfig, OptState, apply_updates,
                                         global_norm, init_opt_state,
                                         schedule)
from torch_threads import one_torch_thread  # noqa: F401

DATA = (dict(vocab=512, seq_len=64, global_batch=8, seed=11),
        dict(vocab=128256, seq_len=33, global_batch=4, seed=3,
             motif_frac=0.6),
        dict(vocab=504, seq_len=32, global_batch=2, embed_dim=80))


# --- data pipeline ----------------------------------------------------------

@pytest.mark.parametrize("kw", DATA, ids=["tokens", "wide-vocab", "embeds"])
@pytest.mark.parametrize("step", [0, 5])
def test_make_batch_bit_for_bit(kw, step):
    """Every array of every shard equals the reference's, bit for bit,
    and ``device_batch`` returns the same values as tensors."""
    dc, jdc = DataConfig(**kw), JDataConfig(**kw)
    for shard, n in ((0, 1), (1, 2)):
        got = make_batch(dc, step, shard=shard, n_shards=n)
        want = j_make_batch(jdc, step, shard=shard, n_shards=n)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    dev = device_batch(dc, step, device="cpu")
    for k, v in make_batch(dc, step).items():
        np.testing.assert_array_equal(dev[k].numpy(), v)


def test_data_deterministic_and_shards_tile():
    dc = DataConfig(**DATA[0])
    a, b, c = make_batch(dc, 5), make_batch(dc, 5), make_batch(dc, 6)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    parts = [make_batch(dc, 3, shard=s, n_shards=4) for s in range(4)]
    np.testing.assert_array_equal(
        make_batch(dc, 3)["tokens"],
        np.concatenate([p["tokens"] for p in parts]))


def test_device_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        device_batch(DataConfig(**DATA[0]), 0)


# --- checkpoints ------------------------------------------------------------

def _tree(dtype=torch.float32):
    return {"a": torch.arange(12.0).reshape(3, 4).to(dtype),
            "b": {"c": torch.ones(5, dtype=torch.int32),
                  "d": (torch.zeros(2, 2, dtype=dtype),
                        torch.full((1,), 7.0, dtype=dtype))},
            "opt": OptState(torch.tensor(3, dtype=torch.int32),
                            {"w": torch.linspace(-1, 1, 6)},
                            {"w": torch.linspace(0, 2, 6)})}


def _jtree(tree):
    """The same tree as JAX arrays (bfloat16 through float32)."""
    if isinstance(tree, dict):
        return {k: _jtree(v) for k, v in tree.items()}
    if isinstance(tree, OptState):
        return jopt.OptState(*(_jtree(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_jtree(v) for v in tree)
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(tree.numpy())


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _flat(v)]
    return [tree]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roundtrip(tmp_path, dtype):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(dtype)
    mgr.save(3, t, extra={"loss": 1.5})
    out, extra, step = mgr.restore(None, t, device="cpu")
    assert step == 3 and extra["loss"] == 1.5
    assert isinstance(out["opt"], OptState)
    for a, b in zip(_flat(t), _flat(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_manifest_equals_reference(tmp_path, dtype):
    """The same tree saved by both managers: the same step directory, the
    same leaf names, files, shapes, dtypes and 16-hex sha256 of the bytes
    (bfloat16 leaves: the port's raw words hash like the reference's
    ml_dtypes array); each package restores the other's checkpoint."""
    t = _tree(dtype)
    jd, pd = tmp_path / "ref", tmp_path / "port"
    JManager(str(jd)).save(7, _jtree(t), extra={"loss": 2.0})
    CheckpointManager(str(pd)).save(7, t, extra={"loss": 2.0})
    man = [json.load(open(d / "step_00000007" / "manifest.json"))
           for d in (jd, pd)]
    assert man[0]["leaves"] == man[1]["leaves"]
    assert man[0]["extra"] == man[1]["extra"] and man[1]["step"] == 7
    assert sorted(os.listdir(jd / "step_00000007")) == \
        sorted(os.listdir(pd / "step_00000007"))
    if dtype == torch.float32:
        out, _, _ = CheckpointManager(str(jd)).restore(7, t, device="cpu")
        for a, b in zip(_flat(t), _flat(out)):
            assert torch.equal(a, b)
        jout, _, _ = JManager(str(pd)).restore(7, _jtree(t))
        for a, b in zip(_flat(t), jax.tree.leaves(jout)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_async_save_retention_and_snapshot(tmp_path):
    """Four async saves keep the last two; each writes the tree as it was
    when ``save_async`` returned, though the caller then changes it in
    place."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save_async(s, t)
        t["a"].add_(1.0)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    out, _, _ = mgr.restore(4, t, device="cpu")
    assert torch.equal(out["a"], torch.arange(12.0).reshape(3, 4) + 3)


def test_async_writer_error_raised_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"x": torch.ones(2)}, extra={"bad": object()})
    with pytest.raises(TypeError):
        mgr.wait()
    mgr.wait()                        # the error is raised once


def test_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    path = mgr.save(1, t)
    victim = sorted(f for f in os.listdir(path) if f.endswith(".npy"))[0]
    fp = os.path.join(path, victim)
    raw = bytearray(open(fp, "rb").read())
    raw[-1] ^= 0xFF
    open(fp, "wb").write(raw)
    with pytest.raises(IOError):
        mgr.restore(1, t, device="cpu")


def test_atomic_publish(tmp_path):
    """A .tmp directory from a crashed save is never listed, and a save
    over it publishes."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert mgr.all_steps() == [] and mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(None, _tree(), device="cpu")
    mgr.save(9, _tree())
    assert mgr.all_steps() == [9]
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "step_00000009.tmp"))


# --- AdamW -------------------------------------------------------------------

def _opt_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"emb": (16, 8), "blocks": {"w": (2, 8, 4), "norm": (2, 8)},
              "bias": (8,)}

    def make(s, scale):
        if isinstance(s, dict):
            return {k: make(v, scale) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)
    params = make(shapes, 0.5)
    grads = [make(shapes, 2.0 if i % 2 else 0.05) for i in range(5)]
    return params, grads


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _assert_tree(got, want, bf16):
    if isinstance(want, dict):
        for k in want:
            _assert_tree(got[k], want[k], bf16)
        return
    if bf16:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(dtype):
    """Five AdamW steps from the same params and grads (the clip active on
    the large steps, weight decay on the 2-D and 3-D leaves only, three
    warmup steps then cosine): params within the stated tolerance for
    the dtype, the fp32 moments within 1e-6, gnorm and lr within 1e-6
    relative, the step count exact."""
    oc = OptConfig(lr=1e-2, warmup_steps=3, total_steps=8, clip_norm=5.0)
    params, grads = _opt_inputs(dtype)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a.copy()).astype(jdt), params)
    # each side gets its own copy: an aligned fp32 array can back both a
    # jax array and a tensor, and the port writes its params in place
    # while the reference's dispatched step may not yet have read them
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()).to(tdt),
                      params)
    js, ts = jopt.init_opt_state(jp), init_opt_state(tp)
    jupd = jax.jit(lambda p, g, s: jopt.apply_updates(oc, p, g, s))
    for g in grads:
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), g)
        tg = jax.tree.map(lambda a: torch.from_numpy(a.copy()).to(tdt), g)
        jp, js, jstats = jupd(jp, jg, js)
        tp, ts, tstats = apply_updates(oc, tp, tg, ts)
        _assert_tree(_np(tp), _np(jp), dtype == "bfloat16")
        _assert_tree(_np(ts.mu), _np(js.mu), False)
        _assert_tree(_np(ts.nu), _np(js.nu), False)
        assert int(ts.step) == int(js.step)
        for k in ("gnorm", "lr"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=1e-6)
        np.testing.assert_allclose(float(global_norm(tg)),
                                   float(jopt.global_norm(jg)), rtol=1e-6)


def test_schedule_matches_reference():
    oc = OptConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(schedule(oc, torch.tensor(s, dtype=torch.int32))),
            float(jopt.schedule(oc, jnp.int32(s))), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adamw_descends(seed):
    """The counterpart of ``test_properties.py::test_adamw_descends``: a
    quadratic bowl, 60 steps, the loss below a quarter of its start."""
    target = torch.from_numpy(
        np.random.default_rng(seed).standard_normal(16).astype(np.float32))
    params = {"w": torch.zeros(16)}
    opt = init_opt_state(params)
    oc = OptConfig(lr=0.05, warmup_steps=1, total_steps=100,
                   weight_decay=0.0)
    loss0 = float(((params["w"] - target) ** 2).sum())
    for _ in range(60):
        params, opt, _ = apply_updates(oc, params,
                                       {"w": 2 * (params["w"] - target)}, opt)
    assert float(((params["w"] - target) ** 2).sum()) < 0.25 * loss0


# --- int8 error feedback --------------------------------------------------

def test_quantize_matches_reference():
    """Payloads, scales and errors equal the reference's, error carried
    over 3 steps; values on exact .5 boundaries round half to even."""
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((64, 33)) * 0.1).astype(np.float32)
    g[0, :4] = [1.27, -1.27, 0.05, -0.15]     # amax 1.27: scale 0.01
    je, te = None, None
    for i in range(3):
        jq, js, je = jcomp.quantize(jnp.asarray(g * (i + 1)), je)
        tq, ts, te = compression.quantize(torch.from_numpy(g * (i + 1)), te)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0,
                                   atol=1e-7)
        np.testing.assert_array_equal(
            compression.dequantize(tq, ts).numpy(),
            np.asarray(jcomp.dequantize(jq, js)))
    half = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])
    q, s, _ = compression.quantize(half)
    assert float(s) == 1.0
    assert q.tolist() == [0, 2, 2, 0, -2, 127]


def test_compress_tree_matches_reference():
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((8, 4)).astype(np.float32),
         "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    jq, js, je = jcomp.compress_tree(jax.tree.map(jnp.asarray, g), None)
    tq, ts, te = compression.compress_tree(
        jax.tree.map(torch.from_numpy, g), None)
    for t, j in ((tq, jq), (ts, js), (te, je)):
        for k in ("a", ("b", "c")):
            tt = t[k[0]][k[1]] if isinstance(k, tuple) else t[k]
            jj = j[k[0]][k[1]] if isinstance(k, tuple) else j[k]
            np.testing.assert_allclose(tt.float().numpy(), np.asarray(jj),
                                       rtol=0, atol=1e-7)
    d = compression.decompress_tree(tq, ts)
    np.testing.assert_array_equal(
        d["a"].numpy(), np.asarray(jcomp.decompress_tree(jq, js)["a"]))
    z = compression.init_error_state(jax.tree.map(torch.from_numpy, g))
    assert z["b"]["c"].dtype == torch.float32 and not z["a"].any()


def test_quantize_error_feedback_unbiased():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(256)
                         .astype(np.float32)) * 0.1
    err = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(50):
        q, s, err = compression.quantize(g, err)
        acc = acc + compression.dequantize(q, s)
    np.testing.assert_allclose((acc / 50).numpy(), g.numpy(), atol=2e-3)


# --- flash attention's plain backward ---------------------------------------

@pytest.mark.parametrize("causal,window,q_offset,S,T,H,KV", [
    (True, 0, 0, 24, 24, 4, 2), (True, 8, 0, 40, 40, 5, 1),
    (False, 0, 0, 17, 31, 4, 4), (True, 0, 9, 12, 30, 8, 2)],
    ids=["causal", "window", "non-causal", "offset"])
def test_plain_backward_matches_autograd(causal, window, q_offset, S, T, H,
                                         KV):
    """``attention_bwd_ref`` from (q, k, v, o, do, lse) against autograd
    through ``attention_ref``, and ``FlashAttention`` on the CPU (the
    plain forward and backward) against the same; ``lse`` against
    ``torch.logsumexp`` of the masked scores."""
    g = torch.Generator().manual_seed(S + T + H)
    B, hd = 2, 16
    q = torch.randn(B, S, H, hd, generator=g)
    k = torch.randn(B, T, KV, hd, generator=g)
    v = torch.randn(B, T, KV, hd, generator=g)
    do = torch.randn(B, S, H, hd, generator=g)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = t(attention_ref(*(t(x) for x in leaves), **kw))
    want = torch.autograd.grad(o, leaves, do)
    lse = attention_lse_ref(t(q), t(k), **kw)
    got = attention_bwd_ref(t(q), t(k), t(v), t(o.detach()), t(do), lse,
                            **kw)
    leaves2 = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o2 = fa_ops.flash_attention_op(*leaves2, **kw)
    torch.testing.assert_close(o2, o.detach(), rtol=0, atol=0)
    via_fn = torch.autograd.grad(o2, leaves2, do)
    for a, b, w in zip((t(x) for x in got), via_fn, want):
        tol = 1e-5 * w.abs().max().item()
        torch.testing.assert_close(a, w, rtol=0, atol=tol)
        torch.testing.assert_close(b, w, rtol=0, atol=tol)
