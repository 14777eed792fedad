"""Where the two packages' xLSTM gradients part at the reference's init.

At the reference's ``m_qkv`` scale (``init_params``, no ``unit_fan_in``)
the port's gradients of smoke xlstm-125m differ from the reference's by
more than the parity tests' 1e-4 of a leaf's largest value.  This script
runs ONE mLSTM layer (layer 0's weights, its input the normed embedding
of the parity tests' batch) three ways: the reference's operations in
fp32 (JAX, op by op), the port's in fp32, and the port's in float64.
Each is a transcription of its package's ``mlstm_parallel`` (one chunk)
that also returns every intermediate, and its output is first checked
against the package's own function.  The backward takes a seeded
cotangent of the output; each intermediate's cotangent comes from a zero
added to it.  Prints, per operation in the order it runs (forward, then
backward from the output), the largest gap between the two fp32 runs and
each one's gap to float64, all relative to the float64 value's largest
magnitude; the first operation whose fp32 gap exceeds 1e-5 is marked.
Beside them, a control: the port's fp32 run again with only the q/k/v
projection's sum over d taken in another order; where that moves an
operation as far as the packages part, their gap is the rounding of
that order, amplified.  Last, the whole model: every gradient leaf's gap
between the packages (``tests/test_torch_train.py``'s loss and batch)
and each package's gap to the port in float64, at init seed 1 and, for
the largest leaf gaps, at seeds 1 to 6.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/xlstm_gap.py
"""

from __future__ import annotations

import contextlib
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from repro.models import xlstm as jx
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import init_params
from repro_torch.models import xlstm as tx
from repro_torch.models.layers import rms_norm

NAMES = ("qkv", "if_pre", "logf", "b", "D", "m_s", "logits", "expw", "W",
         "num", "den_raw", "den", "h", "og", "out")
THRESH = 1e-5


def inputs():
    """(layer 0's mLSTM weights, the layer input x [B, S, d], the
    output's cotangent) as float64 numpy: the parity tests' smoke config,
    ``init_params(seed=1)``, their batch (2 rows of 16 tokens)."""
    cfg = reduce_for_smoke(get_config("xlstm-125m"))
    params = init_params(cfg, "cpu", seed=1)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=2, seed=3), 0)
    x = F.embedding(torch.from_numpy(batch["tokens"]).long(),
                    params["embed"])
    h = rms_norm(x, params["blocks"]["norm1"][0], cfg.rms_eps)
    p = {k: params["blocks"][k][0].double().numpy()
         for k in ("m_qkv", "m_if", "m_if_b", "m_og", "m_out")}
    r = np.random.default_rng(0).standard_normal(h.shape)
    return p, h.double().numpy(), r


def reference_ops(p, x, eps):
    """The reference's ``mlstm_parallel`` on one chunk, in jnp, each
    intermediate plus ``eps[name]``: (out, intermediates)."""
    t = {}

    def rec(name, v):
        v = v + eps[name]
        t[name] = v
        return v
    B, S, d = x.shape
    qkv = rec("qkv", jnp.einsum("bsd,dqhk->qbshk", x, p["m_qkv"]))
    q, k, v = qkv[0], qkv[1], qkv[2]
    hd = q.shape[3]
    if_pre = rec("if_pre", jnp.einsum("bsd,dgh->bsgh", x, p["m_if"])
                 + p["m_if_b"])
    i_pre, f_pre = if_pre[:, :, 0], if_pre[:, :, 1]
    logf = rec("logf", jax.nn.log_sigmoid(f_pre))
    scale = 1.0 / np.sqrt(hd)
    b = rec("b", jnp.cumsum(logf, axis=1))
    bT, iT = b.transpose(0, 2, 1), i_pre.transpose(0, 2, 1)
    D = bT[:, :, :, None] - bT[:, :, None, :] + iT[:, :, None, :]
    tril = jnp.tril(jnp.ones((S, S), jnp.bool_))
    D = rec("D", jnp.where(tril, D, jx.NEG_INF))
    m = jnp.full(bT.shape[:2], -1e30, jnp.float32)
    m_s = rec("m_s", jnp.maximum(jnp.max(D, axis=-1), m[:, :, None] + bT))
    logits = rec("logits", jnp.einsum("bshk,bthk->bhst", q, k) * scale)
    expw = rec("expw", jnp.exp(D - m_s[..., None]))
    W = rec("W", logits * expw)
    num = rec("num", jnp.einsum("bhst,bthk->bhsk", W, v))
    den_raw = rec("den_raw", W.sum(-1))
    den = rec("den", jnp.maximum(jnp.abs(den_raw), jnp.exp(-m_s)))
    h = rec("h", (num / den[..., None]).transpose(0, 2, 1, 3)
            .reshape(B, S, d))
    og = rec("og", jax.nn.sigmoid(x @ p["m_og"]))
    return rec("out", (h * og) @ p["m_out"]), t


def port_ops(p, x, eps, reorder: bool = False):
    """The port's ``mlstm_parallel`` on one chunk (its operations in its
    order, ``_proj`` as one matrix product), each intermediate plus
    ``eps[name]``: (out, intermediates); fp32 or float64 as the inputs
    are.  ``reorder`` sums the q/k/v projection's products over d in two
    halves (the same values, another rounding), as another matrix
    product's blocking would."""
    t = {}

    def rec(name, v):
        v = v + eps[name]
        t[name] = v
        return v
    B, S, d = x.shape
    w = p["m_qkv"]
    wf = w.reshape(d, -1)
    prod = x[..., :d // 2] @ wf[:d // 2] + x[..., d // 2:] @ wf[d // 2:] \
        if reorder else x @ wf
    qkv = rec("qkv", prod.reshape(B, S, *w.shape[1:]))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    hd = q.shape[3]
    wi = p["m_if"]
    if_pre = rec("if_pre", (x @ wi.reshape(d, -1)).reshape(
        B, S, *wi.shape[1:]) + p["m_if_b"])
    i_pre, f_pre = if_pre[:, :, 0], if_pre[:, :, 1]
    logf = rec("logf", F.logsigmoid(f_pre))
    scale = 1.0 / math.sqrt(hd)
    b = rec("b", torch.cumsum(logf, dim=1))
    bT, iT = b.transpose(1, 2), i_pre.transpose(1, 2)
    D = bT[:, :, :, None] - bT[:, :, None, :] + iT[:, :, None, :]
    tril = torch.tril(torch.ones((S, S), dtype=torch.bool))
    D = rec("D", torch.where(tril, D, tx.NEG_INF))
    m = torch.full(bT.shape[:2], tx.NEG_INF, dtype=x.dtype)
    m_s = rec("m_s", torch.maximum(D.amax(-1), m[:, :, None] + bT))
    logits = rec("logits", torch.einsum("bshk,bthk->bhst", q, k) * scale)
    expw = rec("expw", torch.exp(D - m_s[..., None]))
    W = rec("W", logits * expw)
    num = rec("num", torch.einsum("bhst,bthk->bhsk", W, v))
    den_raw = rec("den_raw", W.sum(-1))
    den = rec("den", torch.maximum(den_raw.abs(), torch.exp(-m_s)))
    h = rec("h", (num / den[..., None]).transpose(1, 2).reshape(B, S, d))
    og = rec("og", torch.sigmoid(x @ p["m_og"]))
    return rec("out", (h * og) @ p["m_out"]), t


def run_reference(p, x, r):
    """(intermediates, their cotangents) of ``reference_ops`` in fp32."""
    p32 = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    x32 = jnp.asarray(x, jnp.float32)
    _, shapes = reference_ops(p32, x32, _zeros_like_names())
    eps = {k: jnp.zeros(v.shape, jnp.float32) for k, v in shapes.items()}
    out, fwd = reference_ops(p32, x32, eps)
    grads = jax.grad(lambda e: (reference_ops(p32, x32, e)[0]
                                * jnp.asarray(r, jnp.float32)).sum())(eps)
    real = jx.mlstm_parallel(p32, x32)

    def port_layout(k, v):      # qkv [3, B, S, H, hd] -> [B, S, 3, H, hd]
        v = np.asarray(v, np.float64)
        return np.moveaxis(v, 0, 2) if k == "qkv" else v
    return ({k: port_layout(k, v) for k, v in fwd.items()},
            {k: port_layout(k, v) for k, v in grads.items()},
            float(np.abs(np.asarray(real) - np.asarray(out)).max()))


def run_port(p, x, r, dtype, reorder: bool = False):
    """(intermediates, their cotangents) of ``port_ops`` in ``dtype``,
    and (fp32) the gap of its output to the port's ``mlstm_parallel``."""
    pt = {k: torch.tensor(v, dtype=dtype) for k, v in p.items()}
    xt = torch.tensor(x, dtype=dtype)
    _, shapes = port_ops(pt, xt, _zeros_like_names())
    eps = {k: torch.zeros(v.shape, dtype=dtype, requires_grad=True)
           for k, v in shapes.items()}
    out, fwd = port_ops(pt, xt, eps, reorder)
    (out * torch.tensor(r, dtype=dtype)).sum().backward()
    gap = float("nan")
    if dtype == torch.float32:
        with torch.no_grad():
            gap = float((tx.mlstm_parallel(pt, xt) - out).abs().max())
    return ({k: v.detach().double().numpy() for k, v in fwd.items()},
            {k: eps[k].grad.double().numpy() for k in fwd}, gap)


class _zeros_like_names(dict):
    """An ``eps`` that adds 0 to every intermediate (a first pass, for
    their shapes)."""

    def __missing__(self, key):
        return 0.0


def table() -> tuple[list, dict]:
    """([(phase, op, |ref - port|, |ref - f64|, |port - f64|, |port -
    port reordered|)], each relative to the float64 value's largest
    magnitude (the backward m_s's, which is 0 in exact arithmetic, to
    D's), forward ops in order then backward ops from the output;
    and the checks: each transcription's fp32 gap to its package's
    function, and the normaliser's conditioning, min over rows of
    |sum_t W| / sum_t |W| in float64)."""
    p, x, r = inputs()
    jf, jb, jgap = run_reference(p, x, r)
    pf, pb, pgap = run_port(p, x, r, torch.float32)
    rf, rb, _ = run_port(p, x, r, torch.float32, reorder=True)
    df, db, _ = run_port(p, x, r, torch.float64)
    rows = []
    for phase, (a, b_, c, d) in (("forward", (jf, pf, df, rf)),
                                 ("backward", (jb, pb, db, rb))):
        names = NAMES if phase == "forward" else NAMES[::-1]
        for n in names:
            # the stabiliser m_s cancels out of the output, so its
            # cotangent is 0 in exact arithmetic: scale it by D's
            s = np.abs(c["D" if phase == "backward" and n == "m_s"
                         else n]).max() or 1.0
            rows.append((phase, n, np.abs(a[n] - b_[n]).max() / s,
                         np.abs(a[n] - c[n]).max() / s,
                         np.abs(b_[n] - c[n]).max() / s,
                         np.abs(b_[n] - d[n]).max() / s))
    cond = (np.abs(df["den_raw"]) / np.abs(df["W"]).sum(-1)).min()
    return rows, {"reference": jgap, "port": pgap, "conditioning": cond}


@contextlib.contextmanager
def _float64_port():
    """The port's operations in float64 while on: ``Tensor.float`` keeps
    a float64 tensor, and tensors made as float32 are made float64 (the
    port pins fp32 for its scans' state and its fp32 casts)."""
    real_float = torch.Tensor.float
    made = {n: getattr(torch, n) for n in ("zeros", "full", "ones",
                                           "empty", "tensor")}

    def wide(f):
        @functools.wraps(f)
        def g(*a, **k):
            if k.get("dtype") == torch.float32:
                k["dtype"] = torch.float64
            return f(*a, **k)
        return g
    torch.Tensor.float = lambda t, *a, **k: (
        t if t.dtype == torch.float64 else real_float(t, *a, **k))
    for n, f in made.items():
        setattr(torch, n, wide(f))
    try:
        yield
    finally:
        torch.Tensor.float = real_float
        for n, f in made.items():
            setattr(torch, n, f)


def model_gaps(seed: int = 1) -> dict:
    """Every gradient leaf of smoke xlstm-125m's ``lm_loss`` at
    ``init_params(seed=seed)`` on the parity tests' batch -> (|ref - port|
    relative to the reference's leaf max, as the parity tests measure;
    |ref - f64| and |port - f64| relative to the float64 leaf max)."""
    from repro.configs import get_config as j_get_config
    from repro.configs import reduce_for_smoke as j_reduce
    from repro.models import loss_fn as j_loss_fn
    from repro_torch.train.loop import TrainConfig, grads_of
    from repro_torch.weights import from_jax_params

    cfg = reduce_for_smoke(get_config("xlstm-125m"))
    jcfg = j_reduce(j_get_config("xlstm-125m"))
    params = init_params(cfg, "cpu", seed=seed)
    tree = jax.tree.map(lambda t: t.numpy(), params)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=2, seed=3), 0)
    jg = jax.grad(lambda q, b: j_loss_fn(jcfg, q, b)[0])(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    want = _flat(from_jax_params(jax.tree.map(np.asarray, jg), cfg, "cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = _flat(grads_of(cfg, TrainConfig(), params, tb)[2])
    with _float64_port():
        p64 = jax.tree.map(lambda t: t.double(), params)
        ref = _flat(grads_of(cfg, TrainConfig(), p64, tb)[2])
    out = {}
    for k, w in want.items():
        a, b, c = (t.detach().double().numpy() for t in (w, got[k], ref[k]))
        out[k] = (np.abs(a - b).max() / np.abs(a).max(),
                  np.abs(a - c).max() / np.abs(c).max(),
                  np.abs(b - c).max() / np.abs(c).max())
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def main():
    rows, checks = table()
    print(f"the transcriptions against the packages' own mlstm_parallel "
          f"(fp32, max abs): reference {checks['reference']:.3e}, port "
          f"{checks['port']:.3e}; the normaliser's min |sum W| / sum |W| "
          f"{checks['conditioning']:.3e}")
    print("op (gaps relative to the float64 value's largest magnitude; "
          "the backward m_s to D's): "
          "ref-port, ref-f64, port-f64, port-port (qkv summed over d in two "
          "halves)")
    first = set()
    for phase, n, ab, af, bf, rv in rows:
        mark = ""
        if phase not in first and ab > THRESH:
            first.add(phase)
            mark = "  <- first over 1e-5"
        print(f"{phase:8s} {n:8s} {ab:.3e}  {af:.3e}  {bf:.3e}  "
              f"{rv:.3e}{mark}")
    print("the whole model's gradient leaves at init seed 1: ref-port "
          "(relative to the reference's max, as the parity tests), "
          "ref-f64, port-f64")
    for k, (ab, af, bf) in sorted(model_gaps().items()):
        print(f"  {k:16s} {ab:.3e}  {af:.3e}  {bf:.3e}")
    print("by init seed, the largest over the leaves: ref-port, ref-f64, "
          "port-f64")
    for seed in range(1, 7):
        gaps = np.array(list(model_gaps(seed).values()))
        print(f"  seed {seed}: {gaps[:, 0].max():.3e}  {gaps[:, 1].max():.3e}"
              f"  {gaps[:, 2].max():.3e}")


if __name__ == "__main__":
    main()
