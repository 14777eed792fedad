"""Training launcher (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --smoke --steps 50 --ckpt-dir /tmp/ckpt [--resume] \\
      [--compress-grads] [--microbatches 2] [--remat full]

trains on the card; ``--device cpu`` runs the plain versions.
``--smoke`` takes the tiny same-family config
(``configs.reduce_for_smoke``).

``--mesh host [--model-parallel N]`` trains sharded on a ("data",
"model") ``DeviceMesh`` over every rank (``train.loop.fit(mesh=...)``):

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch llama3-8b --smoke --steps 20 --mesh host --model-parallel 2

The process group comes from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``); run
without it, the launcher makes a one-rank group.  NCCL on the card, gloo
with ``--device cpu``.  ``--model-parallel N`` splits the compute over
the N "model" ranks (heads, MLP or experts, the hybrid's Mamba channels
or the xLSTM's heads, and vocabulary, ``sharding/tensor_parallel.py``)
and each rank draws only its own pieces of the parameters
(``models.init_sharded_params``).  Each data rank computes its own rows; an MoE
dispatch ranks them after the earlier ranks' rows, as the reference
routes the whole batch (``moe.moe_ffn_split``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile


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
    ap.add_argument("--mesh", default="none", choices=["none", "host"],
                    help="host: train sharded over every rank, each data "
                    "rank on its own rows of the batch")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks on the mesh's \"model\" axis: heads, MLP "
                    "or experts, Mamba channels and vocabulary split over "
                    "them (tensor-parallel compute, each rank drawing only "
                    "its pieces)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if args.model_parallel > 1 and args.mesh == "none":
        ap.error("--model-parallel needs --mesh host")

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
    oc = OptConfig(lr=args.lr, total_steps=args.steps)
    if args.mesh == "none":
        metrics = fit(cfg, dc, oc, tc, resume=args.resume,
                      device=args.device)
        print("final:", metrics)
        return metrics
    with process_group(args.device) as rank:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(args.model_parallel, args.device)
        log = print if rank == 0 else (lambda _: None)
        metrics = fit(cfg, dc, oc, tc, mesh=mesh, resume=args.resume,
                      device=args.device, log=log)
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        log(f"final: {metrics} (mesh {shape})")
    return metrics


@contextlib.contextmanager
def process_group(device):
    """The process group for a sharded run, yielding this rank: torchrun's
    when its environment is set, else a one-rank group over a file store
    in a temporary directory.  NCCL on the card (each rank on card
    ``LOCAL_RANK``), gloo on the CPU.  Destroyed on exit."""
    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    with tempfile.TemporaryDirectory(prefix="repro_torch_pg_") as tmp:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(
                backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                rank=0, world_size=1)
        try:
            yield dist.get_rank()
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
