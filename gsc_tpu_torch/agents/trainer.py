"""Trainers: the single-env loop, replica-parallel training, evaluation.

The port of ``gsc_tpu.agents.trainer.Trainer`` without the run observer,
the rollback guard, fault injection, preemption and hot-swap publishing:

- ``train`` is the single-env loop (the JAX package's serial loop,
  ``pipeline=False``, whose results its pipelined loop equals bit for
  bit): per episode ``driver.episode(ep)`` (the schedule's network and
  traffic seeded ``base_seed + ep``), ``env.reset``, then
  ``DDPG.episode_step``, which learns when the episode ends at or after
  the last warm-up step (``end_step >= nb_steps_warmup_critic - 1``);
- ``train_parallel`` trains B env replicas on each episode's scheduled
  network, with host traffic (seed ``base_seed + 1000 * episode + r``),
  the chunked rollout and the end-of-episode learn burst
  (``parallel.harness``);
- ``evaluate`` runs greedy episodes (no noise, no learning) on the
  inference network, optionally writing the reference's test-mode CSV
  suite to ``<result_dir>/test``.

Both training loops append one ``rewards.csv`` row (field ``r``) and one
``history`` row per episode, resume from a restored (``init_state``,
``init_buffer(s)``, ``start_episode``) with the random source restored
into ``Trainer.draws``, and save a checkpoint through ``ckpt_manager``
every ``ckpt_interval`` episodes once the learner state read back on the
host is finite.  The agent config's precision policy applies throughout.
"""
from __future__ import annotations

import csv
import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config.schema import AgentConfig
from ..env.driver import EpisodeDriver
from ..env.env import ServiceCoordEnv
from ..env.observations import GraphObs
from ..parallel.dp import ParallelDDPG
from ..parallel.harness import run_chunked_episodes
from ..topology.compiler import Topology
from .ddpg import DDPG, DDPGState, Draws

log = logging.getLogger("gsc_tpu_torch.agents.trainer")


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


def state_is_finite(state: DDPGState) -> bool:
    """Every float tensor of the learner state (networks, targets, Adam
    moments), read on the host, is finite."""
    tensors = [t for net in ("actor", "critic", "target_actor",
                             "target_critic")
               for t in getattr(state, net).state_dict().values()]
    for opt in (state.actor_opt, state.critic_opt):
        tensors += [t for st in opt.state.values() for t in st.values()
                    if torch.is_tensor(t)]
    return all(bool(torch.isfinite(t).all()) for t in tensors
               if t.is_floating_point())


class Trainer:
    def __init__(self, env: ServiceCoordEnv, driver: EpisodeDriver,
                 agent_cfg: AgentConfig, seed: int = 0,
                 result_dir: Optional[str] = None, device=None):
        self.env = env
        self.driver = driver
        self.agent_cfg = agent_cfg
        self.seed = seed
        self.result_dir = result_dir
        self.ddpg = DDPG(env, agent_cfg, device=device)
        self.device = self.ddpg.device
        # the random source of every training path: warm-up uniforms,
        # exploration normals, replay indices, processing-delay noise
        self.draws = Draws(seed, self.device)
        self.history: List[Dict] = []
        self.pddpg: Optional[ParallelDDPG] = None
        self.completed_episodes = 0
        self._topos: Dict[int, Topology] = {}

    # ---------------------------------------------------------------- inputs
    def _on_device(self, topo: Topology) -> Topology:
        """The device copy of one of the driver's topologies (made once)."""
        key = id(topo)
        if key not in self._topos:
            self._topos[key] = (topo, topo.to(self.device))
        return self._topos[key][1]

    def _episode(self, ep: int, test_mode: bool = False):
        topo, traffic = self.driver.episode(ep, test_mode)
        return self._on_device(topo), traffic.to(self.device)

    def _rewards(self) -> RewardsWriter:
        return RewardsWriter(os.path.join(self.result_dir, "rewards.csv")
                             if self.result_dir else None)

    def init_state(self) -> DDPGState:
        """The learner state drawn from the trainer's seed."""
        return self.ddpg.init_state(torch.Generator().manual_seed(self.seed))

    def template(self, replicas: int = 1):
        """A learner state and an empty replay (one ring, or ``replicas``
        shards) of the shapes a run trains: the target a checkpoint is
        restored into."""
        topo, traffic = self._episode(0)
        _, obs = self.env.reset(topo, traffic, batch=1)
        if replicas > 1:
            buffer = ParallelDDPG(self.env, self.agent_cfg, replicas,
                                  device=self.device).init_buffers(_first(obs))
        else:
            buffer = self.ddpg.init_buffer(_first(obs))
        return self.init_state(), buffer

    def _maybe_save(self, ckpt_manager, ckpt_interval: int, ep: int,
                    start_episode: int, state: DDPGState, buffer):
        """The periodic checkpoint after episode ``ep``, of a state found
        finite on the host."""
        if ckpt_manager is None or not ckpt_interval \
                or (ep + 1 - start_episode) % ckpt_interval:
            return
        if not state_is_finite(state):
            log.warning("episode=%d: the learner state is not finite; no "
                        "periodic checkpoint", ep)
            return
        ckpt_manager.save(state, buffer, episode=ep + 1, draws=self.draws)

    # ------------------------------------------------------------ single env
    def train(self, episodes: int,
              init_state: Optional[DDPGState] = None, init_buffer=None,
              start_episode: int = 0, ckpt_manager=None,
              ckpt_interval: int = 0,
              on_row: Optional[Callable[[Dict], None]] = None):
        """Train one env through episode ``episodes - 1``; returns (state,
        buffer).  A restored (``init_state``, ``init_buffer``,
        ``start_episode``), with ``draws`` restored too, continues a run
        bit for bit.  ``on_row`` gets each episode's row."""
        steps = self.agent_cfg.episode_steps
        topo, traffic = self._episode(start_episode)
        env_state, obs = self.env.reset(topo, traffic, batch=1)
        state = init_state if init_state is not None else self.init_state()
        buffer = init_buffer if init_buffer is not None else \
            self.ddpg.init_buffer(_first(obs))
        writer = self._rewards()
        start = time.perf_counter()
        try:
            for ep in range(start_episode, episodes):
                if ep > start_episode:
                    topo, traffic = self._episode(ep)
                    env_state, obs = self.env.reset(topo, traffic, batch=1)
                global_step = ep * steps
                end_step = global_step + steps - 1
                learn = end_step >= self.agent_cfg.nb_steps_warmup_critic - 1
                state, buffer, env_state, obs, stats, metrics = \
                    self.ddpg.episode_step(state, buffer, env_state, obs,
                                           topo, traffic, global_step,
                                           self.draws, learn=learn)
                row = {k: float(v) for k, v in stats.items()}
                row.update({k: float(v) for k, v in (metrics or {}).items()})
                row.update(episode=ep, sps=(ep - start_episode + 1) * steps
                           / (time.perf_counter() - start))
                self.history.append(row)
                writer.write(row["episodic_return"])
                if on_row is not None:
                    on_row(row)
                self._maybe_save(ckpt_manager, ckpt_interval, ep,
                                 start_episode, state, buffer)
        finally:
            writer.close()
        self.completed_episodes = max(episodes, start_episode)
        return state, buffer

    # ------------------------------------------------------- replica-parallel
    def train_parallel(self, episodes: int, num_replicas: int,
                       chunk: int = 50,
                       on_row: Optional[Callable[[Dict], None]] = None,
                       init_state: Optional[DDPGState] = None,
                       init_buffers=None, start_episode: int = 0,
                       ckpt_manager=None, ckpt_interval: int = 0):
        """Train ``num_replicas`` replicas through episode ``episodes -
        1``, each episode on the network the schedule names; returns
        (state, buffers).  Resumes like ``train``.  ``on_row`` gets each
        episode's row as soon as it is drained."""
        steps = self.agent_cfg.episode_steps
        self.pddpg = pddpg = ParallelDDPG(
            self.env, self.agent_cfg, num_replicas, device=self.device,
            seed=self.seed)
        pddpg.draws = self.draws
        dev = pddpg.device
        topo0, traffic0 = self._episode(0)
        _, one_obs = self.env.reset(topo0, traffic0, batch=1)
        state = init_state if init_state is not None else \
            pddpg.init(torch.Generator().manual_seed(self.seed))
        buffers = init_buffers if init_buffers is not None else \
            pddpg.init_buffers(_first(one_obs))
        writer = self._rewards()
        start = time.perf_counter()

        def report(ep, ret, succ, final, learned):
            # the learner state and the shards are updated in place, so
            # ``state`` and ``buffers`` are those after episode ``ep``
            sps = ((ep - start_episode + 1) * steps * num_replicas
                   / (time.perf_counter() - start))
            row = {"episode": ep, "episodic_return": ret,
                   "mean_succ_ratio": succ, "final_succ_ratio": final,
                   **{k: float(v) for k, v in (learned or {}).items()},
                   "sps": sps}
            self.history.append(row)
            writer.write(ret)
            if on_row is not None:
                on_row(row)
            self._maybe_save(ckpt_manager, ckpt_interval, ep, start_episode,
                             state, buffers)

        try:
            state, buffers = run_chunked_episodes(
                pddpg,
                lambda ep: (self._on_device(self.driver.topology_for(ep)),
                            self.driver.replica_traffic(
                                ep, num_replicas).to(dev)),
                state, buffers, episodes, steps, chunk, on_episode=report,
                start_episode=start_episode)
        finally:
            writer.close()
        self.completed_episodes = max(episodes, start_episode)
        return state, buffers

    # ------------------------------------------------------------ evaluation
    def evaluate(self, state: DDPGState, episodes: int = 1,
                 test_mode: bool = True, telemetry: bool = False,
                 write_schedule: bool = False) -> Dict[str, float]:
        """Greedy episodes (the actor, clipped and post-processed; no
        noise, no learning) on the inference network (``test_mode``).
        With ``telemetry`` the test-mode CSV suite goes to
        ``<result_dir>/test``.  Returns the mean return, the mean final
        success ratio, and the wall seconds up to the first completed
        control step (``compile_warmup_s``), after it (``steady_s``) and
        in all (``total_s``)."""
        writer = None
        if telemetry and self.result_dir:
            from ..utils.telemetry import TestModeWriter
            writer = TestModeWriter(
                os.path.join(self.result_dir, "test"),
                write_schedule=write_schedule,
                sf_names=self.env.service.sf_names,
                sfc_names=self.env.service.sfc_names)
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else lambda: None)
        host = lambda t: t[0].cpu()
        totals, succ = [], []
        t_eval0 = time.perf_counter()
        warmup_s = None
        # the whole greedy rollout in inference mode: the actor's
        # actions are inference tensors, which the env then consumes
        with torch.inference_mode():
            for ep in range(episodes):
                topo, traffic = self._episode(ep, test_mode)
                env_state, obs = self.env.reset(topo, traffic, batch=1)
                noise = Draws(self.seed + 10_000 + ep, self.device)
                ep_reward, info = 0.0, None
                for _ in range(self.agent_cfg.episode_steps):
                    t0 = time.perf_counter()
                    action = self.ddpg.greedy_action(obs, actor=state.actor)
                    sync()
                    runtime = time.perf_counter() - t0
                    env_state, obs, reward, done, info = self.env.step(
                        env_state, topo, traffic, action,
                        noise.sim_noise(self.env.engine, 1))
                    ep_reward += float(reward[0])
                    if warmup_s is None:
                        warmup_s = time.perf_counter() - t_eval0
                    if writer:
                        sim = env_state.sim
                        t_steps = traffic.ingress_active.shape[0]
                        idx = min(int(sim.run_idx[0]) - 1, t_steps - 1)
                        writer.write_step(
                            episode=ep, time=float(sim.t[0]),
                            metrics=sim.metrics.map(host),
                            placement=host(info["placement"]).numpy(),
                            node_cap=traffic.node_cap[max(idx, 0)].cpu()
                        .numpy(),
                            schedule=host(info["schedule"]).numpy(),
                            runtime=runtime,
                            rl_state=host(obs.nodes).numpy().T.reshape(-1)
                            .tolist(),
                            truncated_arrivals=int(sim.truncated_arrivals[0]))
                totals.append(ep_reward)
                succ.append(float(info["succ_ratio"][0]))
        if writer:
            writer.close()
        total_s = time.perf_counter() - t_eval0
        warmup = warmup_s if warmup_s is not None else total_s
        return {"mean_return": float(np.mean(totals)),
                "final_succ_ratio": float(np.mean(succ)),
                "compile_warmup_s": round(warmup, 3),
                "steady_s": round(total_s - warmup, 3),
                "total_s": round(total_s, 3)}
