"""Deterministic, seekable synthetic data pipeline (port of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step, host shard): no iterator
state to checkpoint, and a restarted run recomputes exactly the batches
it would have seen.  ``make_batch`` is the reference's numpy code,
copied, so both packages draw the same tokens bit for bit; only
``device_batch`` differs: it returns torch tensors on an explicit
device (there is no mesh).

The token stream mixes Zipf-like vocabulary draws with repeated n-gram
motifs, so a small model's loss falls clearly within a few hundred steps
(``examples/torch_train_tiny_lm.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 16
    n_motifs: int = 256
    motif_frac: float = 0.5
    embed_dim: int = 0          # > 0: emit frame embeddings (audio)


def _motif_table(cfg: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed ^ 0x5EED)
    return rng.integers(0, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len),
                        dtype=np.int32)


def make_batch(cfg: DataConfig, step: int, *, shard: int = 0,
               n_shards: int = 1) -> dict:
    """Batch for ``step``; host ``shard`` of ``n_shards`` gets rows
    [shard*B/n, (shard+1)*B/n).  Numpy: {"tokens" [b,S] int32, "labels"
    [b,S] int32} ({"embeds" [b,S,embed_dim] fp32, "labels"} with
    ``embed_dim``)."""
    assert cfg.global_batch % n_shards == 0
    b = cfg.global_batch // n_shards
    rows = np.arange(shard * b, (shard + 1) * b, dtype=np.int64)
    S = cfg.seq_len

    # a generator per row, seeded by (seed, step, row): seekable, shardable
    ss = np.random.SeedSequence([cfg.seed, int(step)])
    child = ss.spawn(cfg.global_batch)
    toks = np.empty((b, S + 1), np.int32)
    motifs = _motif_table(cfg)
    for i, r in enumerate(rows):
        rng = np.random.default_rng(child[int(r)])
        # Zipf-like backbone
        u = rng.random(S + 1)
        base = np.minimum((cfg.vocab ** u - 1.0) / max(cfg.vocab - 1, 1)
                          * cfg.vocab, cfg.vocab - 1).astype(np.int32)
        # motifs overlaid at random offsets
        n_m = int(S * cfg.motif_frac / cfg.motif_len)
        offs = rng.integers(0, max(S + 1 - cfg.motif_len, 1), size=n_m)
        ids = rng.integers(0, cfg.n_motifs, size=n_m)
        for o, m in zip(offs, ids):
            base[o:o + cfg.motif_len] = motifs[m]
        toks[i] = base

    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1].copy()}
    if cfg.embed_dim:
        rng = np.random.default_rng([cfg.seed, int(step), 7])
        batch["embeds"] = rng.standard_normal(
            (b, S, cfg.embed_dim), dtype=np.float32)
        batch.pop("tokens")
    return batch


def batch_rows(cfg: DataConfig, step: int, shard: int,
               n_shards: int) -> dict:
    """Rows [shard*B/n, (shard+1)*B/n) of ``make_batch(cfg, step)``, the
    whole batch's rows: the tokens from ``make_batch``'s own shard (each
    row has its own generator), the frame embeddings (``embed_dim``) cut
    from the whole batch's, which one generator draws for every row at
    once (``make_batch``'s shard would draw other values)."""
    if not cfg.embed_dim:
        return make_batch(cfg, step, shard=shard, n_shards=n_shards)
    b = cfg.global_batch // n_shards
    return {k: v[shard * b:(shard + 1) * b]
            for k, v in make_batch(cfg, step).items()}


def device_batch(cfg: DataConfig, step: int, device=None) -> dict:
    """``make_batch(cfg, step)`` as tensors on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in make_batch(cfg, step).items()}
