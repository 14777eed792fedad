"""Train a ~100M-parameter llama-family model for a few hundred steps on
the synthetic motif corpus through the PyTorch port, with checkpoints,
resume and the whole training loop: the port's counterpart of
``train_tiny_lm.py``.  On the card every attention layer runs the flash
kernel forward and backward.

    PYTHONPATH=src python examples/torch_train_tiny_lm.py [--steps 300]
    ... --device cpu       # the plain versions on the CPU (~25 s a step)

Loss falls from ~ln(V) to well below it within a few hundred steps as the
model learns the motifs.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.train.loop import TrainConfig, fit  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402


def tiny_llama() -> ArchConfig:
    """~100M params, llama3 family structure."""
    base = get_config("llama3-8b")
    return dataclasses.replace(
        base, name="llama-tiny-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=1536, vocab=8192, dtype="float32")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_tiny_lm"))
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = tiny_llama()
    print(f"model: {cfg.name}  params ~{cfg.n_params()/1e6:.0f}M")
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch, motif_frac=0.6)
    tc = TrainConfig(steps=args.steps, remat="none",
                     ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=20)
    # motif-heavy data concentrates embedding-row gradients (gnorm ~1e4+);
    # Adam's per-parameter normalisation handles that, so the global clip
    # is effectively off here (a clip would strangle the update)
    metrics = fit(cfg, dc, OptConfig(lr=6e-4, warmup_steps=30,
                                     total_steps=args.steps,
                                     clip_norm=1e9),
                  tc, resume=not args.no_resume, device=args.device)
    print("final:", metrics)
    assert metrics["loss"] < 8.0, "loss should drop well below ln(8192)=9.01"


if __name__ == "__main__":
    main()
