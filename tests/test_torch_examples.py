"""The port's examples (``examples/torch_{quickstart,serve_tiered,
engine_tiered,policy_sweep}.py``), each run as a subprocess under
``EXAMPLES_SMOKE=1 --device cpu``: it exits 0 and prints every line
label of its reference counterpart (``examples/<name>.py``), each label
a literal of the reference's source."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# example -> the labels of the lines it prints, as the reference prints them
LABELS = {
    "quickstart": (
        "=== Trimma vs MemPod (linear remap table) on a pagerank-like "
        "trace ===", "  metadata blocks : ", "  remap-cache hit : ",
        "  fast serve rate : ", "  speedup         : ",
        "=== TieredKVCache: Trimma metadata managing a two-tier KV pool ===",
        "  lookups=", " iRC hits=", "  migrations=", "metadata pages=",
        "  resident in fast pool: "),
    "serve_tiered": (
        "  req ", " tokens -> ",
        "=== tiered KV: dense reference vs Trimma-translated paged read ===",
        "  attention drift across ", " migration rounds: ",
        "  migrations=", " forced_evictions=", " translated pages=",
        "device-table hits=", "  after releasing lane 0: seq-1 output "
        "drift="),
    "engine_tiered": (
        "=== backend=", " decode steps, ", "  req ", " tok -> ",
        " new, latency ", "  latency p50 ", "; modal token ",
        "  metadata: lookups=", "  releases on lane recycle: ",
        "  epoch promo bytes: ", "  epoch demo bytes:  ",
        "tiered token streams identical to dense: OK"),
    "policy_sweep": (
        "=== Trimma-F under ", " policies x ", " accesses each) ===",
        "policy", "threshold", "mea", "on_demand", "write_aware",
        "=== TieredKVCache maintain() under each policy ===",
        " promotions=", "demotions=", " moved=", "resident=",
        "(threshold keeps pages until decay zeroes them; on_demand promotes "),
}


@pytest.fixture(scope="module")
def runs():
    """The four examples started together (each one torch thread), so the
    module takes about as long as the slowest: name -> ``Popen``."""
    env = dict(os.environ, EXAMPLES_SMOKE="1", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, f"examples/torch_{name}.py", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in sorted(LABELS)}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize("name", sorted(LABELS))
def test_example_runs_on_the_cpu(name, runs):
    """``examples/torch_<name>.py`` under ``EXAMPLES_SMOKE=1 --device
    cpu`` exits 0 and prints each of ``LABELS[name]``, which the
    reference's ``examples/<name>.py`` holds in its source."""
    ref = (ROOT / "examples" / f"{name}.py").read_text()
    for label in LABELS[name]:
        assert label in ref, (name, label)
    stdout, stderr = runs[name].communicate(timeout=240)
    assert runs[name].returncode == 0, stderr[-2000:]
    for label in LABELS[name]:
        assert label in stdout, (name, label, stdout[-2000:])
