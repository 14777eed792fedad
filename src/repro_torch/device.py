"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA request on a machine without one
    raises instead of quietly running on the CPU.  ``meta`` (shapes and
    dtypes, no storage) is taken for the abstract trees."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"false; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string -> torch dtype."""
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(DTYPES)}")
    return DTYPES[name]
