"""Checkpoints (port of ``repro.ckpt``)."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
