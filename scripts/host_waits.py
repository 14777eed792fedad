#!/usr/bin/env python3
"""Where the host waits for the card in one main-path engine run.

  python3 scripts/host_waits.py

Builds the main path of ``chip_smoke.py`` (llama3-8b at full width, the
tiered engine, the same 16 seeded requests), runs it once with PyTorch's
sync debug mode set to warn, and prints each call site in the port that
made the host wait (a device-to-host read, an upload from pageable
memory, a 0-d index read on the host), with its count per decode step.
Needs a card.
"""

from __future__ import annotations

import collections
import sys
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("host_waits: needs a CUDA card")
    print(f"card: {chip_smoke._card_line()}")
    _build.build_all()
    dev = torch.device("cuda", 0)
    cfg, params = chip_smoke.main_model(torch, dev)
    eng = chip_smoke.main_path_engine(torch, dev, cfg, params)
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()
                  if "repro_torch" in f.filename]
        sites[" <- ".join(f"{Path(f.filename).name}:{f.lineno}"
                          for f in frames[::-1][:3])] += 1

    warnings.showwarning = record
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        eng.run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = eng.steps
    print(f"host waits: {sum(sites.values())} in {n} decode steps, "
          f"{sum(sites.values()) / n:.3f} per step")
    for site, k in sites.most_common():
        print(f"{k / n:8.3f}/step {k:6d}  {site}")


if __name__ == "__main__":
    main()
