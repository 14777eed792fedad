"""The port's training path against the JAX reference: the init scale of
every family, ``lm_loss`` and its gradients per family, the remat
policies, ``make_train_step`` (microbatches, int8 compression), ``fit``
(loss falls, resume bit for bit, preemption) and a resume across the
packages (the reference writes the checkpoint, the port continues).

Weights: the port's ``init_params`` (at the reference's scale, the
parity tests' shared weights) through numpy and ``from_jax_params``
into both packages; gradient trees of the reference convert through
the same function.  Tolerances, all fp32 on the CPU: losses within 1e-5
(sums over the vocabulary in another order); each gradient leaf within
1e-4 of its own max |value| (matmuls and softmaxes reduce in other
orders; near-one-hot attention at the reference's scale turns a 1e-7
relative difference in a score into ~1e-5 in its weight); parameters
after a train step within 1e-6 of each leaf's max |value| (with
``OC_STEP``); the cross-package resume's final loss within 1e-4 (with
``OC_RESUME``)."""

import dataclasses
import functools
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import init_params, loss_fn
from repro_torch.train.loop import (TrainConfig, fit, grads_of,
                                    make_train_step)
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.weights import from_jax_params, unit_fan_in
from torch_threads import one_torch_thread  # noqa: F401

FAMILIES = ("llama3-8b", "granite-moe-3b-a800m", "hymba-1.5b", "xlstm-125m",
            "llama-3.2-vision-90b", "hubert-xlarge")
LOSS_ATOL, GRAD_REL, STEP_REL = 1e-5, 1e-4, 1e-6
CFG_KW = dict(n_layers=2, d_model=64, vocab=256)    # the reference's _tiny
DC_KW = dict(vocab=256, seq_len=32, global_batch=4, seed=7)
OC = OptConfig(lr=3e-3, warmup_steps=5, total_steps=60)
# the train step's parity: with eps 1 AdamW's first step is nearly linear
# in the gradient (at 1e-8 it is sign(g), which flips on gradients below
# the packages' rounding and moves such a parameter by 2 lr)
OC_STEP = dataclasses.replace(OC, eps=1.0)
# the resume across packages: at lr 3e-3 this model's trajectory turns the
# packages' fp32 differences into ~1e-3 of loss within 15 steps (2.5e-4 to
# 2.1e-3 measured over four reference inits); at 3e-4, ~1e-6
OC_RESUME = dataclasses.replace(OC, lr=3e-4)
QUIET = lambda s: None  # noqa: E731


def _leaves(tree, path=""):
    """path -> leaf of a nested dict (NamedTuples by field)."""
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


def _np(tree):
    return jax.tree.map(lambda t: t.float().numpy()
                        if isinstance(t, torch.Tensor) else np.asarray(t),
                        tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# --- the init scale ----------------------------------------------------------

def _wide(cfg):
    return dataclasses.replace(cfg, d_model=256)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_scale_matches_reference(arch):
    """Every leaf of ``init_params`` against the reference's at d 256:
    random leaves (each of 1,024 or more values) have their standard
    deviation within 10 % and their mean within 0.2 standard deviations
    of the reference's (a sampling tolerance: 4.5 sigma of a 1,024-value
    estimate); the rest (norms, biases, gates, the Mamba and xLSTM
    constants) equal.  The port's earlier init scaled wq by 1/sqrt(d)
    where the reference takes 1/sqrt(H): 8x too small here."""
    jcfg, cfg = _wide(j_reduce(j_get_config(arch))), _wide(
        reduce_for_smoke(get_config(arch)))
    want = _leaves(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                j_init_params(jcfg, jax.random.key(0))))
    got = _leaves(_np(init_params(cfg, "cpu", seed=0)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if np.array_equal(g, w):
            continue
        assert w.size >= 1024, f"{k}: random but only {w.size} values"
        ratio = g.std() / w.std()
        assert abs(ratio - 1) < 0.1, f"{k}: std ratio {ratio:.3f}"
        assert abs(g.mean() - w.mean()) < 0.2 * w.std(), k


# --- lm_loss and its gradients -----------------------------------------------

def _family_inputs(arch):
    """(reference cfg, port cfg, numpy params, numpy batch): the port's
    init (vlm gates 0.5, audio MLP biases random, so every branch
    carries a gradient; xlstm's projections at ``unit_fan_in``), 2 rows
    of 16 positions."""
    jcfg, cfg = j_reduce(j_get_config(arch)), reduce_for_smoke(
        get_config(arch))
    tree = _np(init_params(cfg, "cpu", seed=1))
    if cfg.family == "ssm":
        # the mLSTM's exponential gates at the reference's m_qkv scale
        # part the packages' gradients by ~2e-4 (as in the recurrent
        # parity tests, which take these weights too)
        unit_fan_in(tree, cfg)
    rng = np.random.default_rng(2)
    if cfg.family == "vlm":
        tree["blocks"]["cross"]["attn"]["gate"][:] = 0.5
    if cfg.family == "audio":
        for k in ("b_in", "b_out"):
            b = tree["blocks"]["mlp"][k]
            tree["blocks"]["mlp"][k] = rng.normal(0, 0.5, b.shape).astype(
                np.float32)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2,
                                  seed=3, embed_dim=cfg.d_model
                                  if cfg.embed_inputs else 0), 0)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, tree, batch


def _port_grads(cfg, params, batch, remat="none"):
    return grads_of(cfg, TrainConfig(remat=remat), params, batch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss_and_grads_match_reference(arch):
    """Loss, ce, aux and z within 1e-5; every gradient leaf within 1e-4
    of its max |value| (the reference's ``jax.value_and_grad`` of
    ``loss_fn``, converted through ``from_jax_params``)."""
    jcfg, cfg, tree, batch = _family_inputs(arch)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(jcfg, p, b), has_aux=True))(
            _jax(tree), _jax(batch))
    params = from_jax_params(tree, cfg, "cpu")
    loss, m, g = _port_grads(cfg, params, jax.tree.map(torch.from_numpy,
                                                       batch))
    assert abs(float(loss) - float(jl)) <= LOSS_ATOL
    for k in ("ce", "aux", "z"):
        assert abs(float(m[k]) - float(jm[k])) <= LOSS_ATOL * max(
            1.0, abs(float(jm[k]))), k
    want = _leaves(_np(from_jax_params(jax.tree.map(np.asarray, jg), cfg,
                                       "cpu")))
    got = _leaves(_np(g))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max() + 1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["llama3-8b", "llama-3.2-vision-90b"])
def test_remat_policies_agree(arch):
    """``remat`` "dots" and "full" (each layer, or each vlm super-block,
    under ``torch.utils.checkpoint``) recompute the same operations on
    the same inputs: the loss and every gradient equal "none"'s, bit for
    bit."""
    _, cfg, tree, batch = _family_inputs(arch)
    params = from_jax_params(tree, cfg, "cpu")
    b = jax.tree.map(torch.from_numpy, batch)
    base_l, _, base_g = _port_grads(cfg, params, b)
    for remat in ("dots", "full"):
        loss, _, g = _port_grads(cfg, params, b, remat)
        assert torch.equal(loss, base_l), remat
        for k, w in _leaves(base_g).items():
            assert torch.equal(_leaves(g)[k], w), (remat, k)
    with pytest.raises(ValueError, match="remat"):
        loss_fn(cfg, params, b, remat="some")


# --- the train step ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tiny():
    jcfg = dataclasses.replace(j_reduce(j_get_config("llama3-8b")), **CFG_KW)
    cfg = dataclasses.replace(reduce_for_smoke(get_config("llama3-8b")),
                              **CFG_KW)
    return jcfg, cfg, _np(init_params(cfg, "cpu", seed=0))


@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, False),
                                                   (1, True), (2, True)])
def test_train_step_matches_reference(microbatches, compress):
    """One step from the same params, batch and (zero) error state
    (``OC_STEP``): the loss within 1e-5, gnorm within 1e-4 relative (the
    gradients' tolerance), lr within 1e-6, every new parameter within
    1e-6 of its leaf's max |value|; with compression plus the first
    step's lr times one int8 quantum of the leaf, and the error feedback
    state within one quantum (payloads on a half-step flip)."""
    jcfg, cfg, tree = _tiny()
    batch = make_batch(DataConfig(**DC_KW), 0)
    tc = TrainConfig(microbatches=microbatches, compress_grads=compress)
    jtc = jloop.TrainConfig(microbatches=microbatches,
                            compress_grads=compress)
    jp = _jax(tree)
    jerr = jax.tree.map(jnp.zeros_like, jp) if compress else None
    jp, _, jerr, jm = jax.jit(jloop.make_train_step(jcfg, OC_STEP, jtc))(
        jp, jopt.init_opt_state(jp), jerr, _jax(batch))
    params = from_jax_params(tree, cfg, "cpu")
    err = jax.tree.map(torch.zeros_like, params) if compress else None
    params, opt, err, m = make_train_step(cfg, OC_STEP, tc)(
        params, init_opt_state(params), err,
        jax.tree.map(torch.from_numpy, batch))
    assert int(opt.step) == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]),
                               rtol=GRAD_REL)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    # with compression a gradient value within rounding of a half-step
    # of its int8 grid rounds to neighbouring payloads in the two
    # packages: one quantum of the leaf (its microbatch gradient's
    # max |value| / 127, half again for the carried error), times the
    # first step's learning rate
    quantum = {}
    for i in range(microbatches if compress else 0):
        rows = slice(i * 4 // microbatches, (i + 1) * 4 // microbatches)
        mb = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        g = _leaves(_port_grads(cfg, from_jax_params(tree, cfg, "cpu"),
                                mb)[2])
        for k, t in g.items():
            quantum[k] = max(quantum.get(k, 0.0),
                             1.5 * t.abs().max().item() / 127)
    lr1 = float(jm["lr"])
    for got, want, slack in ((params, jp, lr1), (err, jerr, 1.0)):
        if got is None:
            continue
        want = _leaves(jax.tree.map(np.asarray, want))
        for k, g in _leaves(_np(got)).items():
            np.testing.assert_allclose(
                g, want[k], rtol=0, atol=STEP_REL * np.abs(want[k]).max()
                + slack * quantum.get(k, 0.0) + 1e-12, err_msg=k)


# --- fit ---------------------------------------------------------------------

def _fit(steps, **kw):
    _, cfg, _ = _tiny()
    tc = TrainConfig(steps=steps, log_every=1000, **kw)
    return fit(cfg, DataConfig(**DC_KW), OC, tc, log=QUIET, device="cpu")


def _manifest_hashes(d, step):
    import json
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return {k: v["sha256"] for k, v in json.load(f)["leaves"].items()}


def test_fit_loss_decreases():
    m = _fit(40)
    assert m["loss"] < np.log(DC_KW["vocab"]), m
    assert set(m) == {"loss", "gnorm", "lr", "ce", "aux", "z"}
    assert all(isinstance(v, float) for v in m.values())


def test_fit_resume_is_bitwise(tmp_path):
    """30 steps straight against 15, a stop, and a resume to 30: the same
    final loss, and every parameter and moment of the step-30
    checkpoints the same bits (their sha256)."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    m_full = _fit(30, ckpt_dir=d1, ckpt_every=100)
    _fit(15, ckpt_dir=d2, ckpt_every=15)
    assert CheckpointManager(d2).latest_step() == 15
    m_res = _fit(30, ckpt_dir=d2, ckpt_every=100)
    assert m_full["loss"] == m_res["loss"]
    assert _manifest_hashes(d1, 30) == _manifest_hashes(d2, 30)


def test_preemption_checkpoint(tmp_path):
    """SIGTERM -> the step finishes, a checkpoint is written, fit returns
    early, and a later fit resumes from that step."""
    d = str(tmp_path / "pre")
    calls = {"n": 0}

    def log(s):
        calls["n"] += 1
        if calls["n"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    _, cfg, _ = _tiny()
    tc = TrainConfig(steps=100, ckpt_dir=d, ckpt_every=1000, log_every=1)
    old = signal.getsignal(signal.SIGTERM)
    try:
        fit(cfg, DataConfig(**DC_KW), OC, tc, log=log, device="cpu")
        lines = []
        fit(cfg, DataConfig(**DC_KW), OC,
            dataclasses.replace(tc, steps=5, log_every=1000),
            log=lines.append, device="cpu")
    finally:
        signal.signal(signal.SIGTERM, old)
    assert CheckpointManager(d).latest_step() == 5
    assert lines[0] == "[ckpt] resumed from step 3", lines


def test_resume_across_packages(tmp_path):
    """The reference's ``fit`` writes a 15-step checkpoint; the port's
    ``fit`` resumes it to 30 steps on the same data (``OC_RESUME``); its
    final loss is within 1e-4 of the reference's uninterrupted 30-step
    run."""
    jcfg, cfg, _ = _tiny()
    d = str(tmp_path / "x")
    jdc, dc = JDataConfig(**DC_KW), DataConfig(**DC_KW)
    jtc = jloop.TrainConfig(steps=15, ckpt_dir=d, ckpt_every=15,
                            log_every=1000)
    jloop.fit(jcfg, jdc, OC_RESUME, jtc, log=QUIET)
    want = jloop.fit(jcfg, jdc, OC_RESUME,
                     dataclasses.replace(jtc, steps=30, ckpt_dir=None),
                     log=QUIET)
    lines = []
    got = fit(cfg, dc, OC_RESUME,
              TrainConfig(steps=30, ckpt_dir=d, ckpt_every=100,
                          log_every=1000),
              log=lines.append, device="cpu")
    assert lines[0] == "[ckpt] resumed from step 15"
    assert abs(got["loss"] - want["loss"]) <= 1e-4, (got, want)


def test_launcher_trains_on_the_cpu_and_refuses_sharding(tmp_path, capsys):
    """``launch.train`` with ``--device cpu``: the reference's flags, a
    checkpoint, the final metrics printed, unsharded and with ``--mesh
    host`` (a one-rank gloo group of its own); ``--model-parallel 2``
    is refused without ``--mesh host``, and on one rank."""
    import torch.distributed as dist

    from repro_torch.launch import train
    argv = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--steps",
            "3", "--batch", "2", "--seq", "16", "--microbatches", "2",
            "--compress-grads", "--remat", "dots"]
    for name, extra in (("plain", []), ("mesh", ["--mesh", "host"])):
        ckpt = tmp_path / name
        m = train.main(argv + ["--ckpt-dir", str(ckpt)] + extra)
        assert np.isfinite(m["loss"]) and "final:" in capsys.readouterr().out
        assert CheckpointManager(str(ckpt)).latest_step() == 3
    assert not dist.is_initialized()
    with pytest.raises(SystemExit):
        train.main(argv + ["--model-parallel", "2"])
    with pytest.raises(ValueError, match="model_parallel 2"):
        train.main(argv + ["--mesh", "host", "--model-parallel", "2"])
    assert not dist.is_initialized()
