"""Training launcher (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --smoke --steps 50 --ckpt-dir /tmp/ckpt [--resume] \\
      [--compress-grads] [--microbatches 2] [--remat full]

trains on the card; ``--device cpu`` runs the plain versions.
``--smoke`` takes the tiny same-family config
(``configs.reduce_for_smoke``).  The reference's ``--mesh host`` and
``--model-parallel`` wait for the port's sharding (ROADMAP.md, queue 1,
"Sharding") and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from repro_torch.configs import ALL_ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="none", choices=["none", "host"])
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if args.mesh != "none" or args.model_parallel > 1:
        raise NotImplementedError(
            "--mesh host and --model-parallel > 1 need the port's sharding "
            "(ROADMAP.md, queue 1, item 4, \"Sharding\")")

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.loop import TrainConfig, fit
    from repro_torch.train.optimizer import OptConfig

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch,
                    embed_dim=cfg.d_model if cfg.embed_inputs else 0)
    tc = TrainConfig(steps=args.steps, microbatches=args.microbatches,
                     remat=args.remat, compress_grads=args.compress_grads,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     watchdog_secs=120.0)
    metrics = fit(cfg, dc, OptConfig(lr=args.lr, total_steps=args.steps),
                  tc, resume=args.resume, device=args.device)
    print("final:", metrics)
    return metrics


if __name__ == "__main__":
    main()
