"""The port's sharding against the JAX reference's.

Specs: ``spec_for`` on fake (16, 16) and (2, 16, 16) meshes (fixed cases
and hypothesis), every config's parameter axes and ``tree_shardings``,
every decoder's ``decode_state_shardings`` and ``batch_shardings`` (the
reference through ``abstract_params_and_axes``, ``abstract_decode_state``
and ``input_specs``, nothing materialised): equal, entry for entry.

The multi-rank path runs in 4 spawned gloo processes on the CPU
(``tests/torch_dist_worker.py``, which imports no JAX), one spawn a test
file, each on its own xdist worker: this file's ("sharded") on a (2, 2)
("data", "model") mesh: the sharded train step of smoke llama3-8b and
granite-moe against the reference's ``make_sharded_train_step`` on a
one-device mesh (plain, and with 2 microbatches and int8 error
feedback), a checkpoint saved on (2, 2) and restored on (4, 1), sharded
prefill and decode against the unsharded port, and the int8 data mean
against the reference's under ``jax.vmap(..., axis_name="data")``, and
a sharded ``fit`` that one rank alone is told to stop.  The
tensor-parallel compute over "model" is held by
``test_torch_split_dense.py``, ``_vlm.py``, ``_moe.py`` and
``_recurrent.py``, with the helpers here (``spawn_fixture``,
``_reference_run``, ``check_split_train``, ``check_split_serve``); the
fake-group runs of ``chip_smoke.py`` phases 17-19 and the launcher's
mesh stay here.

Tolerances, fp32 on the CPU, those of ``test_torch_train.py``'s train
step (the ranks sum the data mean in another order than one device):
losses within 1e-5, gnorms and each gradient leaf within 1e-4 of its
max |value|; parameters after the steps within 1e-6 of each leaf's max
|value| per step (AdamW with eps 1), with compression plus the first
step's lr times one int8 quantum of the leaf per microbatch, and the
error state within one quantum per microbatch.  The int8 mean, the
checkpoint's values and the served token streams exactly; the served
logits within 1e-5.  ``REPRO_SHARDED_CE=1`` and ``REPRO_MOE_GROUPS=2``:
the loss within 1e-5 and gradients within 1e-4 of their max, as the
loss parity tests.  The split steps: the same tolerances as the sharded
ones; the gathered caches after the split decode within 1e-4 of the
unsharded ones; ``init_sharded_params`` exactly.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec

import torch_dist_worker as W
from repro.ckpt.manager import CheckpointManager as JManager
from repro.configs import ALL_ARCHS as J_ALL_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as j_make_batch
from repro.models import abstract_decode_state as j_abstract_decode_state
from repro.models import abstract_params_and_axes as j_abstract_params
from repro.models import input_specs as j_input_specs
from repro.models import loss_fn as j_loss_fn
from repro.serve import decode as j_decode
from repro.sharding import specs as jspecs
from repro.train import compression as jcomp
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import (abstract_decode_state,
                                abstract_params_and_axes, init_params,
                                input_specs, loss_fn)
from repro_torch.serve.decode import batch_shardings, decode_state_shardings
from repro_torch.sharding import specs
from repro_torch.sharding.tensor_parallel import CollectiveLog
from repro_torch.train.loop import TrainConfig, grads_of
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

LOSS_ATOL, GRAD_REL, STEP_REL = 1e-5, 1e-4, 1e-6
LOGIT_ATOL = 1e-5

_DEVS = np.asarray(jax.devices() * 512)[:512]
# fake meshes: the reference's specs need only names and sizes
J_MESHES = {"16x16": Mesh(_DEVS[:256].reshape(16, 16), ("data", "model")),
            "2x16x16": Mesh(_DEVS.reshape(2, 16, 16),
                            ("pod", "data", "model"))}
MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}
LOGICAL = sorted(specs.DEFAULT_RULES) + [None]


def _flat(tree, prefix=""):
    """path -> leaf of nested dicts and named tuples, either package."""
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _jspec_leaves(tree):
    """path -> leaf of a reference tree (named-tuple fields by name)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): leaf for path, leaf in flat}


def _jspec_tree(tree):
    """path -> tuple(spec) of a tree of the reference's NamedShardings."""
    return {k: tuple(sh.spec) for k, sh in _jspec_leaves(tree).items()}


# --- spec_for --------------------------------------------------------------

FIXED = ((("batch", "seq", "embed"), (256, 4096, 8192)),
         (("batch", None), (64, 128)),
         (("layers", "embed", "kv_heads", None), (80, 8192, 8, 128)),
         (("layers", "expert", "embed", "mlp"), (40, 40, 1536, 512)),
         (("vocab", "embed"), (49155, 1536)),
         (("vocab", "embed"), (128256, 4096)),
         (("layers", "batch", "seq", None, None), (32, 128, 32768, 8, 128)),
         (("batch",), (1,)), (("batch",), (2,)), ((), ()),
         (("embed", "embed"), (32, 32)),
         (("heads", "mlp"), (25, 1600)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spec_for_fixed_cases(mesh):
    """Divisibility drops, the pod axis, an axis used once, with and
    without shapes: the reference's entries exactly."""
    for axes, shape in FIXED:
        for s in (shape, None):
            want = tuple(jspecs.spec_for(axes, mesh=J_MESHES[mesh],
                                         shape=s))
            assert specs.spec_for(axes, mesh=MESHES[mesh], shape=s) == want, \
                (axes, s)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(LOGICAL),
                          st.integers(1, 4096)), min_size=0, max_size=5),
       st.sampled_from(sorted(MESHES)))
def test_spec_for_matches_reference(dims, mesh):
    axes = tuple(a for a, _ in dims)
    shape = tuple(n for _, n in dims)
    want = tuple(jspecs.spec_for(axes, mesh=J_MESHES[mesh], shape=shape))
    assert specs.spec_for(axes, mesh=MESHES[mesh], shape=shape) == want


def test_placements_follow_the_spec():
    """A spec -> one placement per mesh dim; a dimension over (pod, data)
    shards on both, in mesh order; another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["2x16x16"]
    assert specs.placements_for((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert specs.placements_for((None, "data"), m) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        specs.placements_for((("data", "pod"),), m)
    with specs.use_mesh(m):
        assert specs.current_mesh() is m
        sh = specs.named_sharding(("batch", "embed"), (64, 4096))
        assert sh.spec == (("pod", "data"), None)
        x = torch.ones(2)
        assert specs.logical_constraint(x, ("batch",)) is x
    assert specs.current_mesh() is None
    assert specs.named_sharding(("batch",)) is None


# --- the abstract trees ----------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_axes_and_shardings_match_reference(arch):
    """Every leaf's logical axes, shape and dtype, and its spec on both
    production meshes, equal the reference's."""
    assert sorted(ALL_ARCHS) == sorted(J_ALL_ARCHS)
    jabs, jaxes = j_abstract_params(j_get_config(arch))
    abs_, axes = abstract_params_and_axes(get_config(arch))
    jflat = _flat(jax.tree.map(lambda a: a, jaxes,
                               is_leaf=lambda t: isinstance(t, tuple)))
    assert _flat(axes) == jflat
    for k, t in _flat(abs_).items():
        a = _flat(jabs)[k]
        assert t.device.type == "meta"
        assert tuple(t.shape) == a.shape and str(t.dtype).split(".")[1] \
            == str(a.dtype), k
    for m in MESHES:
        want = _jspec_tree(jspecs.tree_shardings(jaxes, J_MESHES[m], jabs))
        got = {k: s.spec for k, s in _flat(specs.tree_shardings(
            axes, MESHES[m], abs_)).items()}
        assert got == want, m


DECODERS = [a for a in ALL_ARCHS if not get_config(a).is_encoder]


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_state_and_batch_shardings_match_reference(arch):
    """The decode state's and the prefill inputs' specs per leaf, on both
    production meshes, at decode_32k and prefill_32k."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    dec, pre = "decode_32k", "prefill_32k"
    jstate = j_abstract_decode_state(jcfg, J_SHAPES[dec])
    state = abstract_decode_state(cfg, SHAPES[dec])
    assert {k: tuple(v.shape) for k, v in _flat(state).items()} == {
        k: v.shape for k, v in _jspec_leaves(jstate).items()}
    for m in MESHES:
        want = _jspec_tree(j_decode.decode_state_shardings(
            jcfg, jstate, J_MESHES[m]))
        got = {k: s.spec for k, s in _flat(decode_state_shardings(
            cfg, state, MESHES[m])).items()}
        assert got == want, m
        want = _jspec_tree(j_decode.batch_shardings(
            j_input_specs(jcfg, J_SHAPES[pre]), J_MESHES[m]))
        got = {k: s.spec for k, s in batch_shardings(
            input_specs(cfg, SHAPES[pre]), MESHES[m]).items()}
        assert got == want, m


# --- REPRO_SHARDED_CE and REPRO_MOE_GROUPS ---------------------------------

def _loss_parity(arch, monkeypatch, env):
    """The port's loss and gradients against a freshly jitted
    reference's, with ``env`` set for both."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg, jcfg = W.smoke(arch), j_reduce(j_get_config(arch))
    tree = jax.tree.map(lambda t: t.float().numpy(),
                        init_params(cfg, "cpu", seed=3))
    batch = j_make_batch(JDataConfig(vocab=cfg.vocab, seq_len=16,
                                     global_batch=4, seed=2), 0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(jcfg, p, b), has_aux=True))(
            jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    loss, m, g = grads_of(cfg, TrainConfig(),
                          from_jax_params(tree, cfg, "cpu"),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jl)) <= LOSS_ATOL
    for k in ("ce", "aux", "z"):
        assert abs(float(m[k]) - float(jm[k])) <= LOSS_ATOL * max(
            1.0, abs(float(jm[k]))), k
    want = _flat(jax.tree.map(np.asarray, jg))
    for k, t in _flat(g).items():
        np.testing.assert_allclose(t.numpy(), want[k], rtol=0, atol=GRAD_REL
                                   * np.abs(want[k]).max() + 1e-12,
                                   err_msg=k)
    return float(loss), m


def test_sharded_ce_matches_reference(monkeypatch):
    """``REPRO_SHARDED_CE=1``: the reference's vocab-sharded loss, and
    within 1e-6 of the port's default formulation."""
    loss, _ = _loss_parity("llama3-8b", monkeypatch,
                           {"REPRO_SHARDED_CE": "1"})
    monkeypatch.setenv("REPRO_SHARDED_CE", "0")
    cfg = W.smoke("llama3-8b")
    batch = {k: torch.from_numpy(v) for k, v in j_make_batch(JDataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=4, seed=2), 0).items()}
    plain = float(loss_fn(cfg, init_params(cfg, "cpu", seed=3), batch)[0])
    assert abs(loss - plain) <= 1e-6


def test_moe_groups_match_reference(monkeypatch):
    """``REPRO_MOE_GROUPS=2``: granite routes each half of the batch on
    its own, as the reference; the aux loss (the groups' mean) differs
    from the whole batch's."""
    _, m = _loss_parity("granite-moe-3b-a800m", monkeypatch,
                        {"REPRO_MOE_GROUPS": "2"})
    monkeypatch.setenv("REPRO_MOE_GROUPS", "0")
    _, m0 = _loss_parity("granite-moe-3b-a800m", monkeypatch, {})
    assert float(m["aux"]) != float(m0["aux"])


# --- the multi-rank run ----------------------------------------------------

def spawn_fixture(group: str):
    """A module-scoped fixture: the directory of ``W.spawn``'s run of the
    worker's ``group``, made once for the module's tests."""
    @pytest.fixture(scope="module")
    def dist_run(tmp_path_factory):
        out = tmp_path_factory.mktemp(f"dist_{group}")
        W.spawn(str(out), group)
        return out
    return dist_run


dist_run = spawn_fixture("sharded")


def test_dp_mean_compressed_matches_reference(dist_run):
    """Four gloo ranks (MAX and int32 SUM all-reduces) against the
    reference under ``jax.vmap(..., axis_name="data")``: bit for bit."""
    trees = [W.dp_tree(r) for r in range(W.WORLD)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    want = jax.vmap(jcomp.dp_mean_compressed, axis_name="data")(stacked)
    got = np.load(dist_run / "dp_mean.npz")
    for k, w in _flat(jax.tree.map(np.asarray, want)).items():
        np.testing.assert_array_equal(got[k], w[0], err_msg=k)


@functools.lru_cache(maxsize=None)
def _reference_model(arch, wide, n_experts: int, env: tuple):
    """(the reference's config, the port's, the port's init as numpy,
    the reference's jitted gradient, its first batch's gradient) for
    ``_reference_run``, made once a module for each config; ``env`` (the
    values of the variables the reference reads as it traces) is part of
    the key."""
    jcfg, cfg = j_reduce(j_get_config(arch)), W.smoke(arch)
    if wide is not None or n_experts:
        jcfg, cfg = (W.moe_config(c, bool(wide), n_experts)
                     for c in (jcfg, cfg))
    tree = jax.tree.map(lambda t: t.float().numpy(), W.init(cfg))
    grad_fn = jax.jit(jax.grad(lambda q, b: j_loss_fn(jcfg, q, b)[0]))
    grad = grad_fn(jax.tree.map(jnp.asarray, tree),
                   _reference_batch(cfg, 0))
    return jcfg, cfg, tree, grad_fn, _flat(jax.tree.map(np.asarray, grad))


def _reference_batch(cfg, it):
    """The reference's batch ``it``, with the vlm's image embeddings."""
    dc = JDataConfig(vocab=cfg.vocab, **W.DC_KW,
                     embed_dim=cfg.d_model if cfg.embed_inputs else 0)
    b = j_make_batch(dc, it)
    if cfg.family == "vlm":
        b["image_embeds"] = W.image_embeds(cfg, dc.global_batch, it)
    return b


def _reference_run(case, wide=None, n_experts: int = 0):
    """The reference's sharded step on a one-device mesh from the port's
    init: (losses, gnorms, final params, final error state, the first
    batch's gradient, per-microbatch quanta).  ``wide`` (not None) widens
    both configs as ``W.widen`` does, ``n_experts`` (not 0) sets their
    experts."""
    arch, mb, compress, _ = case
    env = tuple(os.environ.get(k) for k in ("REPRO_MOE_GROUPS",
                                            "REPRO_SHARDED_CE"))
    jcfg, cfg, tree, grad_fn, grad = _reference_model(arch, wide, n_experts,
                                                      env)
    rows = W.DC_KW["global_batch"]
    oc = W.opt_config()
    jtc = jloop.TrainConfig(microbatches=mb, compress_grads=compress)

    def batch(it):
        return _reference_batch(cfg, it)
    # the reference's step jitted on a one-device mesh of Auto axes (the
    # partitioner's, which its specs are written for)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    step, p_sh, _ = jloop.make_sharded_train_step(
        jcfg, jopt.OptConfig(**vars(oc)), jtc, mesh, batch(0), donate=False)
    p = jax.tree.map(jnp.asarray, tree)
    opt = jopt.init_opt_state(p)
    # the state placed as the step returns it, so that its second call
    # reuses the first call's compilation
    p, opt = jax.device_put((p, opt), (p_sh, jopt.OptState(
        NamedSharding(mesh, PartitionSpec()), p_sh, p_sh)))
    err = jax.device_put(jax.tree.map(jnp.zeros_like, p), p_sh) \
        if compress else None
    losses, gnorms, flips = [], [], []
    for it in range(W.TRAIN_STEPS):
        if compress:
            flips.append(_one_flip(grad_fn, p, batch(it), mb, rows))
        p, opt, err, m = step(p, opt, err, batch(it))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    quantum = {}
    for it in range(W.TRAIN_STEPS if compress else 0):
        b = batch(it)
        for i in range(mb):
            sl = slice(i * rows // mb, (i + 1) * rows // mb)
            g = grad_fn(jax.tree.map(jnp.asarray, tree),
                        {k: v[sl] for k, v in b.items()})
            for k, t in _flat(jax.tree.map(np.asarray, g)).items():
                quantum[k] = quantum.get(k, 0.0) + 1.5 * np.abs(t).max() / 127
    return (losses, gnorms, _flat(jax.tree.map(np.asarray, p)),
            _flat(jax.tree.map(np.asarray, err)) if compress else {},
            grad, quantum, flips)


def _one_flip(grad_fn, p, batch, mb: int, rows: int) -> float:
    """One int8 rounding flip a microbatch, at ``p`` on ``batch``, times
    the gradient's norm: a flip of an element of leaf k moves that
    element of the microbatches' mean by one quantum over mb (q_k = 1.5
    max|g_k| / 127), so the norm by at most max|g_k| q_k / mb over the
    norm, to first order; each microbatch's flip is put in the leaf
    where that is largest.  Returns the sum over microbatches of
    max_k max|g_k| q_k / mb."""
    total = 0.0
    for i in range(mb):
        sl = slice(i * rows // mb, (i + 1) * rows // mb)
        g = grad_fn(p, {k: v[sl] for k, v in batch.items()})
        total += max(1.5 * float(np.abs(t).max()) ** 2 / 127
                     for t in jax.tree.leaves(g))
    return total / mb


@pytest.mark.parametrize("case", range(len(W.TRAIN_CASES)),
                         ids=["-".join(map(str, c)) for c in W.TRAIN_CASES])
def test_sharded_train_step_matches_reference(case, dist_run, monkeypatch):
    """``TRAIN_STEPS`` sharded steps on 4 ranks against the reference's
    ``make_sharded_train_step`` on one device, within the stated
    tolerances: losses, gnorms, the first batch's data-mean gradient,
    the parameters and the error state."""
    arch, mb, compress, groups = W.TRAIN_CASES[case]
    monkeypatch.setenv("REPRO_MOE_GROUPS", str(groups))
    _check_train(np.load(dist_run / f"train_{case}.npz"),
                 _reference_run(W.TRAIN_CASES[case]))


def _check_train(got, ref, flip_slack: bool = False):
    """``flip_slack``: each step's gnorm may also differ by one int8
    rounding flip a microbatch (``_one_flip`` at that step's parameters
    over its norm): the split step sums in another order than one
    device, so a gradient element on a rounding boundary can quantize to
    the next level (smoke llama3-8b widened, int8, 2 microbatches: step
    1's gnorm 1.18e-4 of itself from the reference's)."""
    losses, gnorms, params, err, grad, quantum, flips = ref
    assert int(got["step"]) == W.TRAIN_STEPS
    np.testing.assert_allclose(got["loss"], losses, rtol=0, atol=LOSS_ATOL)
    slack = np.asarray(flips) / np.asarray(gnorms) if flip_slack else 0.0
    gap = np.abs(np.asarray(got["gnorm"]) - np.asarray(gnorms))
    assert np.all(gap <= GRAD_REL * np.abs(np.asarray(gnorms)) + slack), (
        got["gnorm"], gnorms, slack)
    for k, w in grad.items():
        np.testing.assert_allclose(got[f"grad/{k}"], w, rtol=0, atol=GRAD_REL
                                   * np.abs(w).max() + 1e-12, err_msg=k)
    lr1 = W.opt_config().lr / W.opt_config().warmup_steps
    for name, want, slack in (("param", params, lr1), ("err", err, 1.0)):
        for k, w in want.items():
            np.testing.assert_allclose(
                got[f"{name}/{k}"], w, rtol=0,
                atol=W.TRAIN_STEPS * STEP_REL * np.abs(w).max()
                + slack * quantum.get(k, 0.0) + 1e-12, err_msg=f"{name}/{k}")


# --- the split steps' checks, shared by the test_torch_split_*.py files ----

def split_cases(cases, group: str) -> dict:
    """``pytest.mark.parametrize``'s arguments over ``group``'s cases of
    ``W.TP_TRAIN_CASES`` or ``W.TP_SERVE_CASES`` (``W.group_cases``): the
    cases' indices, named by their values."""
    idx = W.group_cases(cases, group)
    return dict(argvalues=idx, ids=["-".join(map(str, cases[i])).replace(
        " ", "") for i in idx])


def attn_whole(shape, arch: str, wide: bool) -> bool:
    """Whether attention runs whole (with one warning) in a split case:
    the smoke configs' 2 KV heads over 4 "model" ranks."""
    return shape == (1, 4) and not wide and W.smoke(arch).family != "ssm"


def check_split_train(case, dist_run):
    """``test_split_train_step_matches_reference``: the tensor-parallel
    step (``TRAIN_STEPS`` steps on 4 ranks) against the reference's
    ``make_sharded_train_step`` on one device, within the sharded step's
    tolerances; every part ran split, except attention where its KV heads
    do not split over the "model" ranks (``attn_whole``), which ran whole
    after one warning, and no other warning of gathered or repeated
    work, for any family."""
    shape, arch, wide, mb, compress = W.TP_TRAIN_CASES[case]
    got = np.load(dist_run / f"tp_train_{case}.npz")
    whole = attn_whole(shape, arch, wide)
    assert got["split"].tolist() == [not whole, True, True]
    assert got["whole_parts"].tolist() == (["attn"] if whole else [])
    assert int(got["whole_warnings"]) == int(whole)
    assert int(got["port_warnings"]) == int(whole)
    _check_train(got, _reference_run((arch, mb, compress, 0), wide),
                 flip_slack=compress)


def sp_cases(group: str) -> dict:
    """``pytest.mark.parametrize``'s arguments over ``W.SP_CASES[group]``,
    named by their values."""
    cases = W.SP_CASES[group]
    return dict(argvalues=range(len(cases)), ids=["-".join(map(str, c))
                                                  .replace(" ", "")
                                                  for c in cases])


def check_sequence_split(group: str, case: int, dist_run) -> dict:
    """The split step under remat "full" at ``W.SP_CASES[group][case]``'s
    sequence length S (``sp_<group>.json``): where S divides the "model"
    size m the stream split by sequence, the residual entering every
    block is this rank's [B/dp, S/m, d] rows and no activation [B/dp, ..,
    d] saved for the backward is larger; elsewhere both are [B/dp, S,
    d].  Either way the split forward's logits are within LOGIT_ATOL of
    the unsharded port's on the whole batch, the loss within LOSS_ATOL
    and every leaf's data-mean gradient within GRAD_REL of its largest
    value (``check_split_train``'s tolerances).  Returns the record."""
    shape, arch, _, _, _, S = W.SP_CASES[group][case]
    r = json.loads((dist_run / f"sp_{group}.json").read_text())[case]
    m, rows = shape[1], W.DC_KW["global_batch"] // shape[0]
    assert r["sp"] == (S % m == 0)
    want = [rows, S // m if r["sp"] else S, W.smoke(arch).d_model]
    assert r["rows"] == rows
    assert r["residual"] == [want]
    assert r["saved"] == want
    assert r["logit_gap"] <= LOGIT_ATOL
    assert abs(r["loss"] - r["want_loss"]) <= LOSS_ATOL
    for k, gap in r["grad_gap"].items():
        assert gap <= GRAD_REL * r["grad_scale"][k] + 1e-12, (k, gap)
    return r


def check_split_serve(case, dist_run) -> dict:
    """``test_split_serving_matches_unsharded``: split ``jit_prefill``,
    positions set ragged with lane 3 idle (``TP_SERVE_POS``), then greedy
    split ``jit_decode`` steps across the cache pieces' boundaries,
    against the unsharded port: the same token streams and positions,
    logits within 1e-5, the caches (gathered after the run, the vlm's
    image K/V and the recurrent states too) within 1e-4; each rank held
    only its lanes and positions of the KV cache (the vlm's [ns, inner,
    ...] layer dimensions whole), and the logits stay on ("batch",
    "vocab").  No case warns of gathered work; where attention runs whole
    (``attn_whole``) ``jit_prefill`` and ``jit_decode`` warn once each.
    Returns the case's record."""
    shape, arch, wide, _ = W.TP_SERVE_CASES[case]
    got = json.loads((dist_run / f"tp_serve_{case}.json").read_text())
    assert got["tokens"] == got["want_tokens"]
    assert got["pos"] == got["want_pos"] == [
        p + W.SERVE_STEPS for p in W.TP_SERVE_POS]
    assert got["logit_gap"] <= LOGIT_ATOL
    assert got["cache_gap"] <= 1e-4
    whole = got["whole"]
    if whole is not None:
        lead = len(whole) - 4            # the layer dimensions
        assert got["piece"] == whole[:lead] + [
            whole[lead] // shape[0], whole[lead + 1] // shape[1]] \
            + whole[lead + 2:]
    assert got["logits_spec"] == "(Shard(dim=0), Shard(dim=1))"
    assert got["port_warnings"] == (2 if attn_whole(shape, arch, wide)
                                    else 0), arch
    return got


def test_checkpoint_restores_on_another_mesh(dist_run):
    """Saved from (2, 2) (gathered on every rank, written by rank 0),
    restored onto (4, 1): every leaf equal and on (4, 1)'s placements;
    the reference's manager reads the same files as case 0's final
    parameters, bit for bit."""
    info = json.loads((dist_run / "ckpt.json").read_text())
    assert info["step"] == 2 and info["extra"] == {"arch": "llama3-8b"}
    assert info["unequal"] == [] and info["misplaced"] == []
    assert info["leaves"] > 0
    params = {k[len("param/"):]: v for k, v in
              np.load(dist_run / "train_0.npz").items()
              if k.startswith("param/")}
    tmpl = {"params": _nest(params), "opt": jopt.OptState(
        0, _nest(params), _nest(params))}
    tree, extra, step = JManager(str(dist_run / "ckpt")).restore(None, tmpl)
    assert step == 2
    for k, v in _flat(tree["params"]).items():
        np.testing.assert_array_equal(np.asarray(v), params[k], err_msg=k)


def _nest(flat):
    out = {}
    for path, v in flat.items():
        *dirs, leaf = path.split("/")
        node = out
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = v
    return out


@pytest.mark.parametrize("arch", W.SERVE_ARCHS)
def test_sharded_serving_matches_unsharded(arch, dist_run):
    """``jit_prefill`` then greedy ``jit_decode`` steps on (2, 2) (lanes
    over data, cache positions over model; granite without
    ``REPRO_MOE_GROUPS`` on the split path: each rank computes its own
    lanes, ranked after the earlier rank's, and nothing warns) against
    the unsharded ``prefill`` and ``decode_step``: the same tokens and
    positions, logits within 1e-5, the state on its shardings."""
    got = json.loads((dist_run / "serve.json").read_text())[arch]
    assert got["whole_batch_warnings"] == 0
    assert got["tokens"] == got["want_tokens"]
    assert got["pos"] == got["want_pos"] == [
        W.SERVE_PROMPT + W.SERVE_STEPS] * W.SERVE_B
    assert got["placed"]
    assert got["logit_gap"] <= LOGIT_ATOL
    assert "(None, 'data', 'model', None, None)" in got["state_specs"]


def test_preempt_on_one_rank_stops_every_rank(dist_run):
    """SIGTERM on one rank of a sharded ``fit``: every rank agrees, saves
    at the same step (a gather on every rank) and stops after it, and
    nothing hangs."""
    info = json.loads((dist_run / "preempt.json").read_text())
    assert info["ranks"] == [{"steps": [0], "stopped": True}] * W.WORLD
    assert info["saved"] == [1]


def test_attend_shard_is_attend_on_the_whole_cache():
    """``DenseBackend.attend_shard`` from position 0 over the whole cache
    gives ``attend``'s output bit for bit, and its lse is the scores'
    log-sum-exp; over two halves merged by their lse it gives the same
    output within 1e-6 (an idle lane too: every piece masked)."""
    from repro_torch.models.kv_backend import DenseBackend

    cfg = W.smoke("llama3-8b")
    g = torch.Generator().manual_seed(3)
    B, S, KV, G, hd = 3, 16, 2, 2, 16
    cache = {"k": torch.randn(B, S, KV, hd, generator=g),
             "v": torch.randn(B, S, KV, hd, generator=g)}
    q = torch.randn(B, KV, G, hd, generator=g)
    pos = torch.tensor([11, 3, -5], dtype=torch.int32)
    be = DenseBackend(cfg, "cpu")
    want, _ = be.attend(cache, q, pos, window=6)
    out, lse = be.attend_shard(cache, q, pos, window=6)
    assert torch.equal(out, want)
    parts = [be.attend_shard({k: v[:, h * 8:(h + 1) * 8]
                              for k, v in cache.items()}, q, pos,
                             start=h * 8, window=6) for h in (0, 1)]
    m = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(p[1] - m) for p in parts]
    merged = sum(p[0] * x[..., None] for p, x in zip(parts, w)) / \
        sum(w)[..., None]
    np.testing.assert_allclose(merged.numpy(), want.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(
        torch.logaddexp(parts[0][1], parts[1][1])[:2].numpy(),
        lse[:2].numpy(), rtol=0, atol=1e-5)


def test_split_serving_on_a_fake_group():
    """``chip_smoke.py`` phase 17's machinery at smoke size: rank 0 of a
    4-rank group of the fake backend (collectives move nothing) on a
    (1, 4) mesh, the wide smoke qwen2-7b from ``init_sharded_params``:
    the prefill keeps this rank's quarter of the positions and of the
    vocab, and a decode step runs 5 collectives a layer on "model" (q, k
    and v gathered in one call, the lse's max and the merge, the
    attention's and the MLP's sums) and one for the embedding, nothing on
    other groups."""
    import dataclasses

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_sharded_params
    from repro_torch.serve.decode import jit_decode, jit_prefill

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        mesh = make_host_mesh(4, "cpu")
        cfg = W.widen(W.smoke("qwen2-7b"), True)
        params = init_sharded_params(cfg, mesh, seed=5, device="cpu")
        shape = ShapeConfig("fake", 32, 2, "prefill")
        pre, _ = jit_prefill(cfg, shape, mesh)
        dec, _ = jit_decode(cfg, dataclasses.replace(shape, kind="decode"),
                            mesh)
        prompt = torch.randint(0, cfg.vocab, (2, 20), dtype=torch.int32)
        b_sh = batch_shardings({"tokens": prompt}, mesh)["tokens"]
        t_sh = batch_shardings({"tokens": prompt[:, 0]}, mesh)["tokens"]
        logits, state = pre(params, {"tokens": specs.distribute(prompt,
                                                                b_sh)})
        assert tuple(state.caches["k"].to_local().shape) == (
            cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.hd)
        assert tuple(logits.to_local().shape) == (2, cfg.vocab // 4)
        rec = CollectiveLog()
        with rec:
            dec(params, state, specs.distribute(
                logits.to_local().argmax(-1).to(torch.int32), t_sh))
        model = mesh.get_group("model").group_name
        assert [c[1] for c in rec.calls] == [model] * (5 * cfg.n_layers + 1)
    finally:
        dist.destroy_process_group()


def test_vlm_split_serving_on_a_fake_group():
    """``chip_smoke.py`` phase 19's machinery at smoke size: rank 0 of a
    4-rank group of the fake backend on a (1, 4) mesh, the wide smoke
    vlm from ``init_sharded_params``: the prefill keeps this rank's
    quarter of the self caches' positions ([ns, inner, B, W/4, KV, hd])
    and the image K/V whole ([ns, B, T, KV, hd]); a decode step runs 5
    collectives a self layer, 2 a cross layer and 1 for the embedding on
    "model", nothing on other groups.  hubert's split ``jit_prefill``
    keeps a quarter of the vocab columns of every frame.  Building the
    steps warns of no gathered or repeated work, for the vlm, hubert or
    xlstm (which runs split, a head a rank)."""
    import dataclasses
    import warnings

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_sharded_params
    from repro_torch.serve.decode import jit_decode, jit_prefill

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        mesh = make_host_mesh(4, "cpu")
        cfg = W.widen(W.smoke("llama-3.2-vision-90b"), True)
        ns, inner = cfg.vlm_dims
        T, KV, hd = cfg.n_image_tokens, cfg.n_kv_heads, cfg.hd
        params = init_sharded_params(cfg, mesh, seed=5, device="cpu")
        shape = ShapeConfig("fake", 32, 2, "prefill")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pre, _ = jit_prefill(cfg, shape, mesh)
            dec, _ = jit_decode(cfg, dataclasses.replace(shape,
                                                         kind="decode"),
                                mesh)
            aud = W.widen(W.smoke("hubert-xlarge"), True)
            enc, _ = jit_prefill(aud, ShapeConfig("fake", 12, 2, "prefill"),
                                 mesh)
            assert W._port_warnings(caught) == 0
            xl = W.smoke("xlstm-125m")
            xl_dec, _ = jit_decode(xl, dataclasses.replace(shape,
                                                           kind="decode"),
                                   mesh)
            assert W._port_warnings(caught) == 0
        prompt = {"tokens": torch.randint(0, cfg.vocab, (2, 20),
                                          dtype=torch.int32),
                  "image_embeds": torch.randn(2, T, cfg.d_model)}
        b_sh = batch_shardings(prompt, mesh)
        t_sh = batch_shardings({"tokens": prompt["tokens"][:, 0]},
                               mesh)["tokens"]
        logits, state = pre(params, {k: specs.distribute(v, b_sh[k])
                                     for k, v in prompt.items()})
        assert tuple(state.caches["k"].to_local().shape) == (
            ns, inner, 2, 8, KV, hd)
        assert tuple(state.caches["ik"].to_local().shape) == (ns, 2, T, KV,
                                                              hd)
        assert tuple(logits.to_local().shape) == (2, cfg.vocab // 4)
        rec = CollectiveLog()
        with rec:
            dec(params, state, specs.distribute(
                logits.to_local().argmax(-1).to(torch.int32), t_sh))
        model = mesh.get_group("model").group_name
        assert [c[1] for c in rec.calls] == [model] * (
            5 * ns * inner + 2 * ns + 1)
        embeds = torch.randn(2, 12, aud.d_model)
        out = enc(init_sharded_params(aud, mesh, seed=5, device="cpu"),
                  {"embeds": specs.distribute(embeds, batch_shardings(
                      {"embeds": embeds}, mesh)["embeds"])})
        assert tuple(out.to_local().shape) == (2, 12, aud.vocab // 4)
        # xlstm split: a head a rank, its cold state whole over "model",
        # 2 collectives a layer (the output's sum, the state's gather)
        xp = init_sharded_params(xl, mesh, seed=5, device="cpu")
        assert xp["blocks"]["m_qkv"].to_local().shape[-2] == 1
        xl_pre, _ = jit_prefill(xl, shape, mesh)
        logits, state = xl_pre(xp, {"tokens": specs.distribute(
            prompt["tokens"], b_sh["tokens"])})
        assert state.pos.to_local().tolist() == [0, 0]
        assert tuple(state.caches["mC"].to_local().shape) == (
            xl.n_layers, 2, xl.n_heads, xl.hd, xl.hd)
        rec = CollectiveLog()
        with rec:
            xl_dec(xp, state, specs.distribute(
                logits.to_local().argmax(-1).to(torch.int32), t_sh))
        assert [c[1] for c in rec.calls] == [model] * (2 * xl.n_layers + 1)
    finally:
        dist.destroy_process_group()


def test_serve_launcher_mesh_host_on_cpu(capsys):
    """``launch.serve --mesh host`` on a one-rank gloo group: 3 requests
    in waves of 2 lanes, 3 greedy tokens each through ``jit_prefill`` and
    ``jit_decode``; the engine's options are refused beside it,
    ``--model-parallel`` without a mesh, and the vlm (its prompts carry
    image embeddings, which the launcher does not make)."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
                      "--mesh", "host", "--requests", "3", "--batch", "2",
                      "--max-new", "3", "--max-len", "16"])
    assert out["requests"] == 3 and out["tokens"] == 9
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out
    for extra in (["--backend", "tiered"], ["--scheduler", "chunked"]):
        with pytest.raises(SystemExit):
            serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                        "--mesh", "host"] + extra)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                    "--model-parallel", "2"])
    with pytest.raises(SystemExit, match="image embeddings"):
        serve.main(["--arch", "llama-3.2-vision-90b", "--smoke", "--device",
                    "cpu", "--mesh", "host"])


def test_moe_ring_split_serving_on_a_fake_group(monkeypatch):
    """``chip_smoke.py`` phase 18's machinery at smoke size: rank 0 of a
    4-rank group of the fake backend on a (1, 4) mesh, the wide smoke
    mixtral with an 8-token window and ``REPRO_WINDOW_CACHE=1``, from
    ``init_sharded_params``: the rank keeps 2 of the 8 experts, the
    prefill lays the prompt out in 2 of the ring's 8 slots, and each
    decode step past the window runs 6 collectives a layer on "model"
    (q, k and v gathered, the lse's max and the merge, the attention's
    sum, the router's logits gathered, the experts' sum) and one for the
    embedding, nothing on other groups; a prompt longer than the ring
    raises ``ValueError``."""
    import dataclasses

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_sharded_params
    from repro_torch.serve.decode import jit_decode, jit_prefill

    monkeypatch.setenv("REPRO_WINDOW_CACHE", "1")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        mesh = make_host_mesh(4, "cpu")
        cfg = W.moe_config(W.smoke("mixtral-8x22b"), True, window=8)
        params = init_sharded_params(cfg, mesh, seed=5, device="cpu")
        w_gate = params["blocks"]["moe"]["w_gate"].to_local()
        assert w_gate.shape[1] == cfg.n_experts // 4
        shape = ShapeConfig("fake", 16, 2, "prefill")
        pre, _ = jit_prefill(cfg, shape, mesh)
        dec, _ = jit_decode(cfg, dataclasses.replace(shape, kind="decode"),
                            mesh)
        prompt = torch.randint(0, cfg.vocab, (2, 6), dtype=torch.int32)
        b_sh = batch_shardings({"tokens": prompt}, mesh)["tokens"]
        t_sh = batch_shardings({"tokens": prompt[:, 0]}, mesh)["tokens"]
        logits, state = pre(params, {"tokens": specs.distribute(prompt,
                                                                b_sh)})
        assert tuple(state.caches["k"].to_local().shape) == (
            cfg.n_layers, 2, 2, cfg.n_kv_heads, cfg.hd)
        model = mesh.get_group("model").group_name
        for i in range(4):
            rec = CollectiveLog()
            with rec:
                logits, state = dec(params, state, specs.distribute(
                    torch.zeros((2,), dtype=torch.int32), t_sh))
            assert [c[1] for c in rec.calls] == [model] * (
                6 * cfg.n_layers + 1), i
        assert state.pos.to_local().tolist() == [10, 10]
        with pytest.raises(ValueError):
            pre(params, {"tokens": specs.distribute(
                torch.zeros((2, 9), dtype=torch.int32), b_sh)})
    finally:
        dist.destroy_process_group()
