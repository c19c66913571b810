"""Replica-parallel training: on one device, synchronous
(``run_chunked_episodes``) or with decoupled actor threads
(``async_rl.run_async``), and on a mesh of ranks (``mesh``,
``partition``: one process per rank on ``torch.distributed``)."""
from .async_rl import AsyncConfig, AsyncResult, run_async
from .dp import ParallelDDPG, make_replay_ingest
from .harness import run_chunked_episodes
from .mesh import Mesh, init_distributed, launch
from .partition import (ShardingPlan, match_partition_rules, sharded_rules,
                        spec_summary)

__all__ = ["AsyncConfig", "AsyncResult", "Mesh", "ParallelDDPG",
           "ShardingPlan", "init_distributed", "launch",
           "make_replay_ingest", "match_partition_rules", "run_async",
           "run_chunked_episodes", "sharded_rules", "spec_summary"]
