"""The whole slice at engine level: the port's ``Engine(device="cpu")``
against the JAX ``Engine`` on the traces of ``tests/test_engine.py``
(tiered backend, greedy scheduler), and on the "parity" trace under every
other policy preset, the dense backend, the full-width read, synchronous
maintenance, the chunked scheduler and the MoE smoke config.  Counters must be exactly equal and
token streams equal; the smallest top-2 logit margin the port saw is
asserted above the logits tolerance, so a token mismatch could only come
from a real fault.  Plus the port's device and import rules."""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import init_params as j_init_params
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import init_params
from repro_torch.serve import engine as t_engine
from repro_torch.serve.engine import Engine, EngineConfig, Request
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
LOGITS_ATOL = 1e-4

# (trace, EngineConfig overrides, requests: rng seed, n, prompt len fn,
#  max_new fn) — the token-parity and lane-recycle traces of test_engine.py
TRACES = {
    "parity": (dict(batch=2, max_len=48, backend="tiered", page_tokens=8,
                    fast_data_slots=8, maintain_every=3),
               (5, 5, lambda r: 3 + r % 3, lambda r: 4 + (r % 2) * 4)),
    "recycle": (dict(batch=2, max_len=48, backend="tiered", page_tokens=8,
                     fast_data_slots=4, maintain_every=2),
                (9, 5, lambda r: 4, lambda r: 10)),
    "parity_write_aware": (dict(batch=2, max_len=48, backend="tiered",
                                page_tokens=8, fast_data_slots=4,
                                maintain_every=3, policy="write_aware"),
                           (5, 5, lambda r: 3 + r % 3,
                            lambda r: 4 + (r % 2) * 4)),
}
# the "parity" trace under every other preset, the dense backend, the
# full-width read, synchronous maintenance and the chunked scheduler
# (8-token chunks), and on the MoE smoke config
_PARITY = TRACES["parity"]
TRACES.update({f"parity_{p}": ({**_PARITY[0], "policy": p}, _PARITY[1])
               for p in ("mea", "on_demand", "topk", "recency", "threshold")})
TRACES.update({
    "parity_dense": ({**_PARITY[0], "backend": "dense"}, _PARITY[1]),
    "parity_full_width": ({**_PARITY[0], "page_bucket": False}, _PARITY[1]),
    "parity_sync_maintain": ({**_PARITY[0], "overlap_maintain": False},
                             _PARITY[1]),
    "parity_chunked": ({**_PARITY[0], "scheduler": "chunked",
                        "prefill_chunk": 8}, _PARITY[1]),
    "parity_granite": _PARITY,
})
ARCH = {"parity_granite": "granite-moe-3b-a800m"}


def _like(template, tree):
    """``tree``'s values (torch) in ``template``'s layout and dtypes (JAX)."""
    if isinstance(template, dict):
        return {k: _like(v, tree[k]) for k, v in template.items()}
    return jnp.asarray(tree.float().numpy()).astype(template.dtype)


@functools.lru_cache(maxsize=None)
def _models(arch: str = "llama3-8b"):
    """One seeded model for both engines: the port's ``init_params``,
    handed to the reference in its own layout.  (The reference's init
    folds ``hash()`` of each parameter's name into its key, so its weights,
    and with them the smallest top-2 margin of a run, change from process
    to process.)  With seed 2 the smallest margin over the three traces
    is 1.26e-3, twelve times the logits tolerance.  The port's copy goes
    through ``from_jax_params``."""
    jcfg = j_reduce(j_get_config(arch))
    cfg = reduce_for_smoke(get_config(arch))
    jparams = _like(j_init_params(jcfg, jax.random.key(0)),
                    init_params(cfg, "cpu", seed=2))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _requests(make, vocab, spec):
    seed, n, plen, mnew = spec
    rng = np.random.default_rng(seed)
    return [make(rid=r, prompt=rng.integers(0, vocab, plen(r)),
                 max_new=mnew(r)) for r in range(n)]


def _run_port(ec, spec, monkeypatch, arch: str = "llama3-8b"):
    """Port engine run; returns (streams, counters, min live top-2
    margin).  The margin spy wraps the engine's decode step and reads
    each live lane's logits row."""
    _, _, cfg, params = _models(arch)
    margins = []
    real = t_engine.decode_step

    def spy(cfg_, params_, state, tokens, **kw):
        live = state.pos >= 0
        logits, new = real(cfg_, params_, state, tokens, **kw)
        top2 = torch.topk(logits[live], 2, dim=-1).values
        margins.extend((top2[:, 0] - top2[:, 1]).tolist())
        return logits, new

    monkeypatch.setattr(t_engine, "decode_step", spy)
    eng = Engine(cfg, params, ec, device="cpu")
    for r in _requests(Request, cfg.vocab, spec):
        eng.submit(r)
    done = eng.run()
    monkeypatch.setattr(t_engine, "decode_step", real)
    return ({r.rid: r.tokens for r in done}, eng.counters, min(margins),
            eng)


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_engine_matches_reference(trace, monkeypatch):
    over, spec = TRACES[trace]
    arch = ARCH.get(trace, "llama3-8b")
    jcfg, jparams, _, _ = _models(arch)
    jeng = JEngine(jcfg, jparams, JEngineConfig(**over))
    for r in _requests(JRequest, jcfg.vocab, spec):
        jeng.submit(r)
    jdone = jeng.run()
    streams, counters, margin, eng = _run_port(EngineConfig(**over), spec,
                                               monkeypatch, arch)
    assert margin > LOGITS_ATOL, f"top-2 margin {margin} under tolerance"
    assert streams == {r.rid: r.tokens for r in jdone}
    assert counters == jeng.counters
    assert eng.releases == jeng.releases
    if over["backend"] == "tiered":     # the dense backend keeps no books
        assert eng.releases == spec[1]
        assert counters["migrations"] > 0


def test_engine_overlap_equals_sync_maintenance(monkeypatch):
    """Double-buffered maintenance (plan at the hook, apply before the
    next step) changes neither the token streams nor the counters."""
    over, spec = TRACES["parity"]
    runs = [_run_port(EngineConfig(**over, overlap_maintain=o), spec,
                      monkeypatch)[:2] for o in (False, True)]
    assert runs[0][0] == runs[1][0]
    c0, c1 = runs[0][1], runs[1][1]
    assert {k: c0[k] for k in ("migrations", "demotions")} \
        == {k: c1[k] for k in ("migrations", "demotions")}
    assert c1["migrations"] + c1["demotions"] > 0


def test_cuda_request_without_card_raises():
    """Every entry point defaults to the card and never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    from repro_torch.models.kv_backend import TieredBackend
    cfg = reduce_for_smoke(get_config("llama3-8b"))
    for call in (lambda: resolve_device("cuda"),
                 lambda: init_params(cfg),
                 lambda: TieredBackend(cfg, 2, 64),
                 lambda: Engine(cfg, _models()[3], EngineConfig()),
                 lambda: serve.main(["--arch", "llama3-8b", "--smoke"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (f, mod)
