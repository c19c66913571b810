"""Resilience: rotating checksummed checkpoints and ``--resume auto``."""
from .ckpt import CheckpointManager, find_resumable

__all__ = ["CheckpointManager", "find_resumable"]
