"""Replica-parallel training on one device, synchronous
(``run_chunked_episodes``) or with decoupled actor threads
(``async_rl.run_async``)."""
from .async_rl import AsyncConfig, AsyncResult, run_async
from .dp import ParallelDDPG, make_replay_ingest
from .harness import run_chunked_episodes

__all__ = ["AsyncConfig", "AsyncResult", "ParallelDDPG",
           "make_replay_ingest", "run_async", "run_chunked_episodes"]
