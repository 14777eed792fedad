#!/usr/bin/env python3
"""Why a parity test must not hand one numpy buffer to both packages when
the port writes it in place.

  JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/jax_alias_race.py [--busy 8]

(1) ``jnp.asarray`` of a suitably aligned fp32 numpy array shares its
buffer (zero copy on the CPU), as ``torch.from_numpy`` does: a write
through the tensor shows through the jax array.  (2) A jitted call
returns before it has run; a write to its aliased input made right
after the call can reach the computation.  The reference's AdamW step
(``repro.train.optimizer.apply_updates``) is dispatched on such an
input, then the input is overwritten; the script counts the results
that saw the write, with ``--busy`` processes spinning to load the
CPU as a parallel test run does.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp

import numpy as np


def _spin():
    while True:
        pass


def _aligned(rng, shape):
    n = int(np.prod(shape))
    raw = np.empty(n + 64, np.float32)
    off = (-raw.ctypes.data % 64) // 4
    a = raw[off:off + n].reshape(shape)
    a[...] = rng.standard_normal(shape) * 0.5
    return a


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--busy", type=int, default=8)
    ap.add_argument("--trials", type=int, default=300)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from repro.train import optimizer as jopt

    rng = np.random.default_rng(0)
    shared = seen = 0
    for _ in range(args.trials):
        a = _aligned(rng, (16, 8))
        j = jnp.asarray(a)
        if j.unsafe_buffer_pointer() == a.ctypes.data:
            shared += 1
            torch.from_numpy(a).add_(1.0)
            seen += float(np.asarray(j)[0, 0]) == float(a[0, 0])
    print(f"aliasing: {shared} of {args.trials} aligned arrays share their "
          f"buffer with jnp.asarray; a torch write showed through in "
          f"{seen} of them")

    oc = jopt.OptConfig(lr=1e-2, warmup_steps=3, total_steps=8,
                        clip_norm=5.0)
    step = jax.jit(lambda p, g, s: jopt.apply_updates(oc, p, g, s))
    spinners = [mp.get_context("spawn").Process(target=_spin, daemon=True)
                for _ in range(args.busy)]
    for p in spinners:
        p.start()
    try:
        late = 0
        g = {"w": jnp.ones((16, 8), jnp.float32)}
        for _ in range(args.trials):
            a = _aligned(rng, (16, 8))
            before = a.copy()
            p = {"w": jnp.asarray(a)}
            out, _, _ = step(p, g, jopt.init_opt_state(p))
            a += 100.0              # the in-place write, after dispatch
            late += bool(np.abs(np.asarray(out["w"]) - before).max() > 50)
    finally:
        for p in spinners:
            p.kill()
    print(f"dispatch: {late} of {args.trials} AdamW steps read a write made "
          f"after their call returned ({args.busy} busy processes)")


if __name__ == "__main__":
    main()
