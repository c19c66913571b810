"""Replica-parallel DDPG on one device.

The port of the single-device path of ``gsc_tpu.parallel.dp.ParallelDDPG``:
B env replicas step in lockstep (every tensor carries the [B] replica dim
the JAX package gets from ``vmap``), each with its own traffic, feeding B
per-replica replay shards; the learner samples batches across all shards
and updates one set of parameters.  The topology is shared by every
replica or stacked per replica (a mixed batch or the scenario factory);
each replay row records its replica's ``topo_id`` as ``topo_idx``.
Either observation mode: a flat observation (``graph_mode`` false) acts
under the env's action mask of each replica's network.  With
a ``learn_ledger`` the rollout's stats carry the shards' fill and the
learn burst's metrics the learning signal, as on the single env.
Without a sharding plan or buffer donation: the port's carries are
updated in place where that saves memory (the replay shards, the learner
state).

Random numbers come from a ``Draws`` source (``agents.ddpg``): warm-up
uniforms and exploration normals per rollout step, replay indices per
gradient step, and the simulator's processing-delay noise.

One instance serves the decoupled actor/learner loop
(``parallel.async_rl``) from several threads: an actor thread rolls out
with ``rollout_episodes(..., actor=, draws=)`` on its own copy of the
actor network (``actor_copy``) and its own random source
(``actor_draws``) into a scratch ring of one chunk, never touching the
learner's modules, whose parameters and Adam moments ``learn_burst``
updates in place on the learner's thread; ``make_replay_ingest`` folds
each shipped block into the learner's shared ring.

Under a sharding plan (``plan``, a ``parallel.partition.ShardingPlan``
over a ``parallel.mesh.Mesh``) the instance is one rank of a mesh: it
rolls out only its replica rows ``plan.rows(B)`` (their traffic, env
states and replay shards; every random draw with a replica axis is drawn
whole and sliced, ``Draws.rows``), the rollout's per-replica numbers are
gathered into global replica order before any mean, and each gradient
step's batch is drawn alike on every rank over the global replica and
slot indices and gathered row by row as bytes
(``ShardingPlan.gather_batch``), so every rank runs the same learn burst
on the same batch and ends with the same learner state: no gradient is
reduced across ranks.  Around each ``chunk_step`` the learner state is
gathered from the plan's residency and sliced back into it.
``sample_mode="local"`` takes ``max(batch // B, 1)`` slots from every
replica in replica order in place of the uniform batch over (replica,
slot) pairs (``_sample_local`` of the JAX package).
"""
from __future__ import annotations

import contextlib
import copy
import time
from types import SimpleNamespace
from typing import Callable, Dict, Optional, Tuple

import torch

from ..agents.buffer import ReplayBuffer, buffer_add, buffer_init, restore_batch
from ..agents.ddpg import DDPG, DDPGState, Draws
from ..models.nets import Actor
from ..obs.learning import replay_stats
from ..config.schema import AgentConfig
from ..env.env import EnvState, ServiceCoordEnv
from ..env.permutation import ShuffleOps
from ..sim.state import TrafficSchedule
from ..topology.compiler import Topology


def shard_capacity(mem_limit: int, replicas: int) -> int:
    """Slots per replica shard: ``mem_limit // replicas`` (at least 1), so
    the shards together hold the single-env agent's budget."""
    return max(mem_limit // replicas, 1)


def make_replay_ingest(num_replicas: int, capacity: int
                       ) -> Callable[[ReplayBuffer, Dict], ReplayBuffer]:
    """The replay service's insert: fold one block of flattened
    transition leaves [B, T, ...] (an actor's scratch ring in insertion
    order) into the shared ring [B, capacity, ...] at each replica's
    cursor, wrapping, with one in-place index copy per leaf on the current
    stream; the cursors advance by T and the sizes clamp at capacity.
    The caller owns the ring (the learner thread) and keeps T <=
    capacity."""
    b_n, cap = int(num_replicas), int(capacity)

    def replay_ingest(buffers: ReplayBuffer, block: Dict) -> ReplayBuffer:
        t_n = next(iter(block.values())).shape[1]
        dev = buffers.pos.device
        idx = (buffers.pos.long()[:, None]
               + torch.arange(t_n, device=dev)[None, :]) % cap
        rows = torch.arange(b_n, device=dev)[:, None].expand(b_n, t_n)
        for k, d in buffers.data.items():
            d.index_put_((rows, idx), block[k].to(d.dtype))
        buffers.pos = (buffers.pos + t_n) % cap
        buffers.size = torch.clamp(buffers.size + t_n, max=cap)
        return buffers

    return replay_ingest


class ParallelDDPG:
    """B-replica data-parallel wrapper around the DDPG agent."""

    def __init__(self, env: ServiceCoordEnv, agent: AgentConfig,
                 num_replicas: int, device=None, seed: int = 0,
                 learn_ledger=None, plan=None, sample_mode: str = "across"):
        if sample_mode not in ("across", "local"):
            raise ValueError(f"unknown sample_mode {sample_mode!r}")
        if plan is not None and num_replicas % plan.n_devices != 0:
            raise ValueError(
                f"num_replicas ({num_replicas}) must be divisible by the "
                f"mesh device count ({plan.n_devices}, mesh "
                f"{plan.describe()}) for an even replica sharding")
        if plan is not None and not agent.graph_mode:
            raise ValueError("a mesh of a flat agent (graph_mode: false) "
                             "is not ported yet: train it without a mesh")
        if plan is not None and plan.resident_sharded:
            raise ValueError(
                "the tp rule book's tensor-parallel dispatch is not ported "
                "yet (the next slice of the port); use --partition-rules "
                "replicated or sharded")
        self.env = env
        self.agent = agent
        self.B = num_replicas
        self.sample_mode = sample_mode
        self.plan = plan
        # this rank's replica rows (all of them without a plan)
        self.lo, self.hi = plan.rows(num_replicas) if plan else (0,
                                                                 num_replicas)
        self.ddpg = DDPG(env, agent, device=device,
                         learn_ledger=learn_ledger)
        self.device = self.ddpg.device
        self.shuffle = ShuffleOps(agent, env.limits)
        self.draws = Draws(seed, self.device, rows=self.draw_rows)
        # under a plan (synchronized): seconds of each learn burst, and
        # the rollouts' seconds and env steps on this rank's rows
        self.burst_s = []
        self.rollout_s = 0.0
        self.rollout_steps = 0

    @property
    def rows_n(self) -> int:
        """Replicas this instance rolls out."""
        return self.hi - self.lo

    @property
    def draw_rows(self):
        """``Draws.rows`` of this rank (None without a plan)."""
        return None if self.plan is None else (self.lo, self.hi, self.B)

    # ----------------------------------------------------------------- init
    def init(self, generator: torch.Generator) -> DDPGState:
        """Learner state drawn from ``generator`` (on the CPU)."""
        return self.ddpg.init_state(generator)

    def init_buffers(self, sample_obs,
                     capacity: Optional[int] = None) -> ReplayBuffer:
        """Per-replica replay shards [B, capacity, ...] (a rank's rows
        under a plan), capacity ``mem_limit // B`` (at least 1) unless
        given, so the total matches the single-env agent's budget.
        ``sample_obs`` is one observation without a batch dim."""
        cap = capacity or shard_capacity(self.agent.mem_limit, self.B)
        return buffer_init(self.ddpg.example_transition(sample_obs), cap,
                           lead=(self.rows_n,), device=self.device)

    def actor_copy(self, actor: Actor) -> Actor:
        """An acting copy of ``actor`` (no gradients) for one actor
        thread: the learner's module is never read while it trains."""
        return copy.deepcopy(actor).requires_grad_(False)

    def actor_draws(self, seed: int, actor: int) -> Draws:
        """Actor ``actor``'s random source: a generator on the device
        seeded by (``seed``, 1000 + actor)."""
        draws = Draws(0, self.device)
        draws.generator.manual_seed(((seed & 0xFFFFFFFF) << 32)
                                    | (1000 + actor))
        return draws

    def reset_all(self, topo: Topology, traffic: TrafficSchedule
                  ) -> Tuple[EnvState, object]:
        """Fresh episode on every replica (``traffic`` [B, ...]; a rank's
        rows under a plan)."""
        return self.env.reset(topo, traffic, batch=self.rows_n)

    # -------------------------------------------------------------- rollout
    @torch.no_grad()
    def rollout_episodes(self, state: DDPGState, buffers: ReplayBuffer,
                         env_states: EnvState, obs, topo: Topology,
                         traffic: TrafficSchedule, episode_start_step: int,
                         num_steps: int, actor: Optional[Actor] = None,
                         draws: Optional[Draws] = None
                         ) -> Tuple[DDPGState, ReplayBuffer, EnvState,
                                    object, Dict[str, torch.Tensor]]:
        """``num_steps`` steps of every replica: action, env step, replay
        write.  ``episode_start_step``
        is the global step of the first one (the warm-up gate reads it).
        ``actor`` and ``draws`` (default: ``state.actor``, this
        instance's source) are what an actor thread acts with.  Returns
        the chunk's stats, still on the device."""
        actor = actor if actor is not None else state.actor
        draws = draws if draws is not None else self.draws
        n = self.rows_n
        perm = self.shuffle.init_perm(n, self.device, draws)
        obs = self.shuffle.permute_obs(obs, perm)
        # each replica's network: a stacked topology's per-replica ids
        topo_idx = topo.expand(n).topo_id
        env_mask = self.ddpg.env_mask(topo, n)
        engine = self.env.engine
        rewards, succ, e2e = [], [], []
        for i in range(num_steps):
            mask = self.shuffle.step_mask(obs, env_mask, perm)
            action = self.ddpg.choose_action(
                actor, obs, mask, episode_start_step + i, draws)
            action = self.env.process_action(action)
            env_states, next_obs, reward, done, info = self.env.step(
                env_states, topo, traffic,
                self.shuffle.env_action(action, perm),
                draws.sim_noise(engine, n))
            next_obs, perm = self.shuffle.advance(next_obs, perm, draws)
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
        e = torch.stack(e2e)
        ring = buffers
        if self.plan is not None:
            # every replica's numbers in global replica order, laid out
            # as a run without a mesh lays them out, before any mean
            got = self.plan.gather_replica_rows(
                {"r": r.t(), "s": s.t(), "e": e.t(), "size": buffers.size},
                self.B)
            r, s, e = (got[k].t().contiguous() for k in "rse")
            ring = SimpleNamespace(size=got["size"],
                                   capacity=buffers.capacity)
        stats = {"episodic_return": r.sum(0).mean(),
                 "mean_succ_ratio": s.mean(),
                 "mean_e2e_delay": e.mean(),
                 "final_succ_ratio": s[-1].mean(),
                 "per_replica_return": r.sum(0)}
        if self.ddpg.learn_ledger is not None:
            stats["replay"] = replay_stats(ring)
        return state, buffers, env_states, obs, stats

    def chunk_step(self, state: DDPGState, buffers: ReplayBuffer,
                   env_states: EnvState, obs, topo: Topology,
                   traffic: TrafficSchedule, episode_start_step: int,
                   num_steps: int, learn: bool = False, observe=None):
        """A chunk of the rollout and, when ``learn`` (the final chunk of
        an episode), the end-of-episode learn burst (in ``observe(
        "learn_burst")``'s context when given, a cost ledger's).  Under a
        plan the learner state is gathered from its residency on entry
        and sliced back on exit.  Returns (state, buffers, env_states,
        obs, stats, learn_metrics or None)."""
        if self.plan is not None:
            self.plan.gather_state(state)
            t0 = time.perf_counter()
        state, buffers, env_states, obs, stats = self.rollout_episodes(
            state, buffers, env_states, obs, topo, traffic,
            episode_start_step, num_steps)
        if self.plan is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.rollout_s += time.perf_counter() - t0
            self.rollout_steps += self.rows_n * num_steps
        metrics = None
        if learn:
            with (observe("learn_burst") if observe is not None
                  else contextlib.nullcontext()):
                state, metrics = self.learn_burst(state, buffers)
        if self.plan is not None:
            self.plan.place_state(state)
        return state, buffers, env_states, obs, stats, metrics

    # ------------------------------------------------------------- learning
    def global_sizes(self, buffers: ReplayBuffer) -> torch.Tensor:
        """The fill of every replica's shard [B] (gathered under a plan)."""
        if self.plan is None:
            return buffers.size
        return self.plan.gather_replica_rows({"size": buffers.size},
                                             self.B)["size"]

    def _batch(self, buffers: ReplayBuffer, bidx: torch.Tensor,
               sidx: torch.Tensor) -> Dict:
        if self.plan is None:
            raw = {k: d[bidx, sidx] for k, d in buffers.data.items()}
        else:
            t0 = time.perf_counter()
            raw = self.plan.gather_batch(buffers.data, bidx, sidx, self.B)
            self.plan.gather_s += time.perf_counter() - t0
            self.plan.gathers += 1
        return restore_batch(buffers.shapes, raw)

    def sample_across(self, buffers: ReplayBuffer,
                      sizes: Optional[torch.Tensor] = None) -> Dict:
        """A uniform batch over (replica, slot) pairs of all shards
        (``sizes``: every replica's fill, default ``buffers.size``)."""
        bidx, sidx = self.draws.replay(
            self.agent.batch_size, self.B,
            buffers.size if sizes is None else sizes)
        return self._batch(buffers, bidx, sidx)

    def sample_local(self, buffers: ReplayBuffer,
                     sizes: Optional[torch.Tensor] = None) -> Dict:
        """A shard-local stratified batch: ``max(batch // B, 1)`` slots
        from every replica's shard, concatenated in replica order."""
        per = max(self.agent.batch_size // self.B, 1)
        bidx, sidx = self.draws.local(
            self.B, per, buffers.size if sizes is None else sizes)
        return self._batch(buffers, bidx, sidx)

    def learn_burst(self, state: DDPGState, buffers: ReplayBuffer):
        """``learn_steps`` gradient steps on batches sampled across the
        replica shards (or shard-local ones, ``sample_mode="local"``)."""
        sample = (self.sample_local if self.sample_mode == "local"
                  else self.sample_across)
        if self.plan is None:
            return self.ddpg.learn_burst(state, lambda: sample(buffers))
        t0 = time.perf_counter()
        sizes = self.global_sizes(buffers)
        out = self.ddpg.learn_burst(state, lambda: sample(buffers, sizes))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.burst_s.append(time.perf_counter() - t0)
        return out
