"""Replica-parallel training on one device."""
from .dp import ParallelDDPG
from .harness import run_chunked_episodes

__all__ = ["ParallelDDPG", "run_chunked_episodes"]
