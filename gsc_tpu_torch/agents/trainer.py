"""Replica-parallel trainer: the core loop of ``Trainer.train_parallel``.

The port of the part of ``gsc_tpu.agents.trainer`` that trains B env
replicas on one network: the learner state and the per-replica replay
shards are made once, then every episode samples each replica's traffic
on the host (seed ``base_seed + 1000 * episode + r``), runs the chunked
rollout and the end-of-episode learn burst (``parallel.harness``), appends
the return to ``rewards.csv`` (field ``r``, the JAX package's schema) and
reports one row: return, mean and final success ratio, critic and actor
loss, q, env-steps/s.  The agent config's precision policy applies
throughout (``cli train --precision``).  Saving a checkpoint at the end is
the CLI's (``cli train --checkpoint``, ``utils.checkpoint``); resuming
from one, evaluation, the single-env loop and the run observability of the
JAX trainer are not ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import csv
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from ..config.schema import AgentConfig
from ..env.driver import EpisodeDriver
from ..env.env import ServiceCoordEnv
from ..env.observations import GraphObs
from ..parallel.dp import ParallelDDPG
from ..parallel.harness import run_chunked_episodes


class RewardsWriter:
    """rewards.csv with one field ``r`` per episode."""

    def __init__(self, path: Optional[str]):
        self._file = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._file = open(path, "w", newline="")
            self._csv = csv.DictWriter(self._file, fieldnames=["r"])
            self._csv.writeheader()

    def write(self, reward: float):
        if self._file:
            self._csv.writerow({"r": reward})
            self._file.flush()

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


def _first(obs: GraphObs) -> GraphObs:
    return GraphObs(**{k: v[0] for k, v in vars(obs).items()})


class Trainer:
    def __init__(self, env: ServiceCoordEnv, driver: EpisodeDriver,
                 agent_cfg: AgentConfig, seed: int = 0,
                 result_dir: Optional[str] = None, device=None):
        self.env = env
        self.driver = driver
        self.agent_cfg = agent_cfg
        self.seed = seed
        self.result_dir = result_dir
        self.device = device
        self.history: List[Dict] = []
        self.pddpg: Optional[ParallelDDPG] = None

    def train_parallel(self, episodes: int, num_replicas: int,
                       chunk: int = 50,
                       on_row: Optional[Callable[[Dict], None]] = None):
        """Train ``num_replicas`` replicas for ``episodes`` episodes;
        returns (state, buffers).  ``on_row`` gets each episode's row as
        soon as it is drained."""
        steps = self.agent_cfg.episode_steps
        self.pddpg = pddpg = ParallelDDPG(
            self.env, self.agent_cfg, num_replicas, device=self.device,
            seed=self.seed)
        dev = pddpg.device
        topo = self.driver.topology.to(dev)
        _, one_obs = self.env.reset(
            topo, self.driver.traffic_for(self.driver.base_seed).to(dev),
            batch=1)
        state = pddpg.init(torch.Generator().manual_seed(self.seed))
        buffers = pddpg.init_buffers(_first(one_obs))
        writer = RewardsWriter(os.path.join(self.result_dir, "rewards.csv")
                               if self.result_dir else None)
        start = time.perf_counter()

        def report(ep, ret, succ, final, learned):
            sps = ((ep + 1) * steps * num_replicas
                   / (time.perf_counter() - start))
            row = {"episode": ep, "episodic_return": ret,
                   "mean_succ_ratio": succ, "final_succ_ratio": final,
                   **{k: float(v) for k, v in (learned or {}).items()},
                   "sps": sps}
            self.history.append(row)
            writer.write(ret)
            if on_row is not None:
                on_row(row)

        try:
            state, buffers = run_chunked_episodes(
                pddpg, topo,
                lambda ep: self.driver.replica_traffic(
                    ep, num_replicas).to(dev),
                state, buffers, episodes, steps, chunk, on_episode=report)
        finally:
            writer.close()
        return state, buffers
