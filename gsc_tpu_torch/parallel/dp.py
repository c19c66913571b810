"""Replica-parallel DDPG on one device.

The port of the single-device path of ``gsc_tpu.parallel.dp.ParallelDDPG``:
B env replicas step in lockstep (every tensor carries the [B] replica dim
the JAX package gets from ``vmap``), each with its own traffic, feeding B
per-replica replay shards; the learner samples batches across all shards
and updates one set of parameters.  Without a sharding plan or buffer
donation: the port's carries are updated in place where that saves memory
(the replay shards, the learner state).

Random numbers come from a ``Draws`` source (``agents.ddpg``): warm-up
uniforms and exploration normals per rollout step, replay indices per
gradient step, and the simulator's processing-delay noise.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..agents.buffer import ReplayBuffer, buffer_add, buffer_init, restore_batch
from ..agents.ddpg import DDPG, DDPGState, Draws
from ..config.schema import AgentConfig
from ..env.env import EnvState, ServiceCoordEnv
from ..env.observations import GraphObs
from ..env.permutation import ShuffleOps
from ..sim.state import TrafficSchedule
from ..topology.compiler import Topology


def shard_capacity(mem_limit: int, replicas: int) -> int:
    """Slots per replica shard: ``mem_limit // replicas`` (at least 1), so
    the shards together hold the single-env agent's budget."""
    return max(mem_limit // replicas, 1)


class ParallelDDPG:
    """B-replica data-parallel wrapper around the DDPG agent."""

    def __init__(self, env: ServiceCoordEnv, agent: AgentConfig,
                 num_replicas: int, device=None, seed: int = 0):
        self.env = env
        self.agent = agent
        self.B = num_replicas
        self.ddpg = DDPG(env, agent, device=device)
        self.device = self.ddpg.device
        self.shuffle = ShuffleOps(agent, env.limits)
        self.draws = Draws(seed, self.device)

    # ----------------------------------------------------------------- init
    def init(self, generator: torch.Generator) -> DDPGState:
        """Learner state drawn from ``generator`` (on the CPU)."""
        return self.ddpg.init_state(generator)

    def init_buffers(self, sample_obs: GraphObs) -> ReplayBuffer:
        """Per-replica replay shards [B, capacity, ...], capacity
        ``mem_limit // B`` (at least 1), so the total matches the
        single-env agent's budget.  ``sample_obs`` is one observation
        without a batch dim."""
        cap = shard_capacity(self.agent.mem_limit, self.B)
        return buffer_init(self.ddpg.example_transition(sample_obs), cap,
                           lead=(self.B,), device=self.device)

    def reset_all(self, topo: Topology, traffic: TrafficSchedule
                  ) -> Tuple[EnvState, GraphObs]:
        """Fresh episode on every replica (``traffic`` [B, ...])."""
        return self.env.reset(topo, traffic, batch=self.B)

    # -------------------------------------------------------------- rollout
    @torch.no_grad()
    def rollout_episodes(self, state: DDPGState, buffers: ReplayBuffer,
                         env_states: EnvState, obs: GraphObs, topo: Topology,
                         traffic: TrafficSchedule, episode_start_step: int,
                         num_steps: int
                         ) -> Tuple[DDPGState, ReplayBuffer, EnvState,
                                    GraphObs, Dict[str, torch.Tensor]]:
        """``num_steps`` steps of every replica: action, env step, replay
        write.  ``episode_start_step``
        is the global step of the first one (the warm-up gate reads it).
        Returns the chunk's stats, still on the device."""
        perm = self.shuffle.init_perm(self.B, self.device)
        obs = self.shuffle.permute_obs(obs, perm)
        topo_idx = topo.topo_id.expand(self.B)
        engine = self.env.engine
        rewards, succ, e2e = [], [], []
        for i in range(num_steps):
            mask = self.shuffle.step_mask(obs, None, perm)
            action = self.ddpg.choose_action(
                state.actor, obs, mask, episode_start_step + i, self.draws)
            action = self.env.process_action(action)
            env_states, next_obs, reward, done, info = self.env.step(
                env_states, topo, traffic,
                self.shuffle.env_action(action, perm),
                self.draws.sim_noise(engine, self.B))
            next_obs, perm = self.shuffle.advance(next_obs, perm)
            buffer_add(buffers, {
                "obs": obs, "next_obs": next_obs, "action": action,
                "reward": reward, "done": done.to(torch.float32),
                "topo_idx": topo_idx})
            rewards.append(reward)
            succ.append(info["succ_ratio"])
            e2e.append(info["avg_e2e_delay"])
            obs = next_obs
        r = torch.stack(rewards)            # [T, B]
        s = torch.stack(succ)
        stats = {"episodic_return": r.sum(0).mean(),
                 "mean_succ_ratio": s.mean(),
                 "mean_e2e_delay": torch.stack(e2e).mean(),
                 "final_succ_ratio": s[-1].mean(),
                 "per_replica_return": r.sum(0)}
        return state, buffers, env_states, obs, stats

    def chunk_step(self, state: DDPGState, buffers: ReplayBuffer,
                   env_states: EnvState, obs: GraphObs, topo: Topology,
                   traffic: TrafficSchedule, episode_start_step: int,
                   num_steps: int, learn: bool = False):
        """A chunk of the rollout and, when ``learn`` (the final chunk of
        an episode), the end-of-episode learn burst.  Returns (state,
        buffers, env_states, obs, stats, learn_metrics or None)."""
        state, buffers, env_states, obs, stats = self.rollout_episodes(
            state, buffers, env_states, obs, topo, traffic,
            episode_start_step, num_steps)
        metrics = None
        if learn:
            state, metrics = self.learn_burst(state, buffers)
        return state, buffers, env_states, obs, stats, metrics

    # ------------------------------------------------------------- learning
    def sample_across(self, buffers: ReplayBuffer) -> Dict:
        """A uniform batch over (replica, slot) pairs of all shards."""
        bidx, sidx = self.draws.replay(self.agent.batch_size, self.B,
                                       buffers.size)
        raw = {k: d[bidx, sidx] for k, d in buffers.data.items()}
        return restore_batch(buffers.shapes, raw)

    def learn_burst(self, state: DDPGState, buffers: ReplayBuffer):
        """``learn_steps`` gradient steps on batches sampled across the
        replica shards."""
        return self.ddpg.learn_burst(state,
                                     lambda: self.sample_across(buffers))
