"""Plain PyTorch version of the migration gather: out[i] = pool[idx[i]]."""

import torch


def remap_gather_ref(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return pool[idx.long()]
