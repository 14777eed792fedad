#!/usr/bin/env python3
"""Where an access's cycles go inside the simulator's scan kernel (card).

    python3 scripts/sim_scan_phases.py [--parent SRC]

Builds a copy of ``src/repro_torch/kernels/sim_scan/csrc/sim_scan.cu``
with ``clock64`` stamps in warp 0 around each phase of one access (the
copy lives under ``src/repro_torch/build/``; the kernel source keeps no
switch for it), runs Trimma-C and Trimma-F of the Figure 7 sweep (14
traces, accesses [0, 512) and the whole 49,152) through it and through
the unstamped kernel, and prints the unstamped kernel's time (CUDA
events, cold L2) and the stamped copy's mean SM cycles per access and
phase.  The stamps cost a few percent; a phase's cycles include the
stalls on what earlier phases issued.

``--parent SRC`` does the same for the kernel before its redesign (``git
show de669bb:src/repro_torch/kernels/sim_scan/csrc/sim_scan.cu > SRC``,
under a directory ``.gitignore`` lists), with that design's phases, and
checks its end states against this tree's kernel.
The chain's yardstick (``sim_scan_chase_op``) is printed first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

STAMP_DEFS = '''namespace {
__device__ unsigned long long g_prof[16];
__shared__ volatile int g_sink;
#define SINK(x) (g_sink = (int)(x))
#define STAMP(k) do { const long long _n = clock64(); ph[k] += _n - tp; \\
                      tp = _n; } while (0)
'''
READOUT = '''extern "C" {
int sim_scan_prof_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
}
int sim_scan_prof_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
'''
FLUSH = '''
    for (int k = 0; k < 10; ++k)
      atomicAdd(&g_prof[k], (unsigned long long)ph[k]);
'''

# this tree's kernel: (phase names, [(text, text with stamps)])
TREE = (("trace", "batch", "match", "walk+fill", "look+data",
         "tracker+gate", "tick", "victim", "install", "loop"), [
    ("    for (int i = p.start; i < p.end; ++i) {\n"
     "      const int32_t step_after",
     "    long long ph[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "    long long tp = clock64();\n"
     "    for (int i = p.start; i < p.end; ++i) {\n"
     "      STAMP(9);\n"
     "      const int32_t step_after"),
    ("        sim.load_state();\n      }",
     "        sim.load_state();\n"
     "        SINK(sim.bm + sim.bto + sim.bem + (int)sim.bsv);\n"
     "        STAMP(1);\n      }"),
    ("      step = step_after;\n",
     "      step = step_after;\n"
     "      SINK(b + w + m + to + em + (int)sv);\n      STAMP(0);\n"),
    ("      // 3. the policy gate: record",
     "      STAMP(4);\n      // 3. the policy gate: record"),
    ("      if (POL != POL_NONE && tick) {",
     "      SINK(go);\n      STAMP(5);\n"
     "      if (POL != POL_NONE && tick) {"),
    ("        const Probe r = sim.match(b, look);\n",
     "        STAMP(6);\n        const Probe r = sim.match(b, look);\n"
     "        SINK(r.hit + r.val + r.id_way);\n"
     "        STAMP(2);\n"),
    ("      // 4. install / migrate\n"
     "      if (go) {\n        const Slot v = sim.pick_victim(b, s);\n",
     "      STAMP(3);\n      // 4. install / migrate\n"
     "      if (go) {\n        const Slot v = sim.pick_victim(b, s);\n"
     "        SINK(v.v);\n        STAMP(7);\n"),
    ("          sim.install_swap(b, v);\n        }\n      }\n    }\n",
     "          sim.install_swap(b, v);\n        }\n"
     "        SINK(owner[v.v]);\n        STAMP(8);\n      }\n    }\n"
     "    if (lane == 0) {" + FLUSH + "    }\n"),
])

# the kernel before its redesign (warp 0 runs each access, lane-0 stores)
PARENT = (("trace", "remap[b]", "probe", "walk+fill", "data+counters",
           "tracker", "gate", "victim", "install", "loop"), [
    ("  for (int i = p.start; i < p.end; ++i) {\n"
     "    const int32_t step_after",
     "  long long ph[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long tp = clock64();\n"
     "  for (int i = p.start; i < p.end; ++i) {\n"
     "    if (warp == 0) STAMP(9);\n"
     "    const int32_t step_after"),
    ("      const bool d = p.deallocs[x] != 0;\n",
     "      const bool d = p.deallocs[x] != 0;\n      SINK(b + w + d);\n"),
    ("      step = step_after;\n\n",
     "      step = step_after;\n      STAMP(0);\n\n"),
    ("      const int32_t m = sim.remap[b];\n",
     "      const int32_t m = sim.remap[b];\n      SINK(m);\n"
     "      STAMP(1);\n"),
    ("        const bool walk = !hit;\n",
     "        SINK(hit + val);\n        STAMP(2);\n"
     "        const bool walk = !hit;\n"),
    ("      // 2. data access\n",
     "      STAMP(3);\n      // 2. data access\n"),
    ("      // 3. the policy gate, first half: record the touch\n",
     "      STAMP(4);\n"
     "      // 3. the policy gate, first half: record the touch\n"),
    ("        sc = score_at(p, sim.touch, sim.ema, b);\n      }\n    }\n",
     "        sc = score_at(p, sim.touch, sim.ema, b);\n      }\n"
     "      SINK(sc);\n      STAMP(5);\n    }\n"),
    ("    if (warp == 0 && elig) {\n",
     "    if (warp == 0) STAMP(6);\n    if (warp == 0 && elig) {\n"),
    ("      sim.put(&fifo[s], floormod(fifo[s] + pos + 1, p.k));\n",
     "      sim.put(&fifo[s], floormod(fifo[s] + pos + 1, p.k));\n"
     "      SINK(v);\n      STAMP(7);\n"),
    ("        sim.install_swap(b, v);\n      }\n    }\n  }\n",
     "        sim.install_swap(b, v);\n      }\n      SINK(owner[v]);\n"
     "      STAMP(8);\n    }\n  }\n"
     "  if (warp == 0 && (tid & 31) == 0) {" + FLUSH + "  }\n"),
])


def stamped(src: str, recipe) -> str:
    s = src.replace("namespace {\n", STAMP_DEFS, 1)
    for old, new in recipe[1] + [('extern "C" {\n', READOUT)]:
        if s.count(old) != 1:
            raise SystemExit(f"sim_scan_phases: the source no longer has "
                             f"one {old!r}; update the recipe")
        s = s.replace(old, new)
    return s


def build(name: str, text: str) -> Path:
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / f"{name}.cu"
    lib = _build.BUILD_DIR / f"lib{name}.so"
    src.write_text(text)
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                          str(lib), str(src)], capture_output=True,
                         text=True)
    if out.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{out.stderr[-3000:]}")
    return lib


def bind(path: Path):
    """(remap, tagmatch, None) entries, as ``sim_scan_op`` unpacks them;
    the lib is kept for its readout."""
    lib = ctypes.CDLL(str(path))
    for fn in (lib.sim_scan_remap, lib.sim_scan_tagmatch):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, (lib.sim_scan_remap, lib.sim_scan_tagmatch, None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke
    from repro_torch import core as P
    from repro_torch.core import simulator as sim
    from repro_torch.kernels import _build
    from repro_torch.kernels.sim_scan import ops

    if not torch.cuda.is_available():
        raise SystemExit("sim_scan_phases: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = chip_smoke._card_line()
    print(f"card: {card}")
    tree_src = _build.SOURCES["sim_scan"].read_text()
    libs = {"tree stamped": (bind(build("sim_scan_stamped",
                                        stamped(tree_src, TREE))), TREE[0])}
    if args.parent is not None:
        parent = args.parent.read_text()
        libs["parent"] = (bind(build("sim_scan_parent", parent)), None)
        libs["parent stamped"] = (bind(build(
            "sim_scan_parent_stamped", stamped(parent, PARENT))), PARENT[0])
    for kind in ("smem", "l2"):
        r = ops.sim_scan_chase_op(kind, dev)
        print(f"chase {kind}: {r['ns']:.2f} ns, {r['cycles']:.1f} cycles")

    data = json.loads(chip_smoke.SIM_FIG7.read_text())
    wls, L = data["workloads"], data["trace_len"]
    tm = P.TIMINGS[data["timing"]]
    for name in ("trimma_c", "trimma_f"):
        cfg = P.SimConfig(**data["configs"][name]).validate()
        bs, ws = [], []
        for wl in wls:
            b, w = P.generate_trace(P.WORKLOADS[wl], cfg.slow_blocks, L,
                                    data["seed"])
            bs.append(P.relabel_first_touch(b) if cfg.mode == "flat" else b)
            ws.append(w)
        b = torch.as_tensor(np.stack(bs).astype(np.int32), device=dev)
        w = torch.as_tensor(np.stack(ws), device=dev)
        d = torch.zeros_like(w)
        fresh = sim.init_state(cfg, sim.make_geometry(cfg), len(wls), dev)
        for end in (512, L):
            state = {k: v.clone() for k, v in fresh.items()}

            def reset():
                for k, v in fresh.items():
                    state[k].copy_(v)

            def run():
                ops.sim_scan_op(cfg, tm, state, b, w, d, 0, end)

            _build._loaded.pop("sim_scan", None)
            ms = chip_smoke._time_ms(run, reps=5 if end == 512 else 3,
                                     warmup=1, setup=reset)
            want = {k: v.clone() for k, v in state.items()}
            print(f"{name} [0, {end}) kernel: {ms:.4f} ms, "
                  f"{1e6 * ms / end:.0f} ns an access step")
            for label, ((lib, entries), phases) in libs.items():
                _build._loaded["sim_scan"] = entries
                line = f"{name} [0, {end}) {label}:"
                if phases is None:
                    t = chip_smoke._time_ms(run, reps=5 if end == 512 else 3,
                                            warmup=1, setup=reset)
                    line += f" {t:.4f} ms, {1e6 * t / end:.0f} ns a step;"
                lib_read = getattr(lib, "sim_scan_prof_read", None)
                reset()
                if lib_read is not None:
                    lib.sim_scan_prof_reset()
                run()
                torch.cuda.synchronize()
                bad = [k for k in want if not torch.equal(want[k], state[k])]
                line += " end state " + ("equal" if not bad else f"differs "
                                         f"in {bad}")
                if lib_read is not None:
                    h = (ctypes.c_ulonglong * 16)()
                    lib_read(h)
                    n = len(wls) * end
                    cyc = [h[k] / n for k in range(10)]
                    c = dict(zip(ops.KERNEL_COUNTERS,
                                 state["counters"].sum(0).tolist()))
                    line += (f"; cycles an access {sum(cyc):.0f}: " +
                             ", ".join(f"{p} {x:.0f}"
                                       for p, x in zip(phases, cyc)) +
                             f"; walks {c['walks'] / n:.3f}, installs "
                             f"{(c['installs'] + c['swaps']) / n:.3f} an "
                             f"access")
                print(line, flush=True)
            _build._loaded.pop("sim_scan", None)
    print(f"card: {card}")


if __name__ == "__main__":
    main()
