"""Trainers: the single-env loop, replica-parallel training, evaluation.

The port of ``gsc_tpu.agents.trainer.Trainer``:

- ``train`` is the single-env loop: per episode ``driver.episode(ep)``
  (the schedule's network and traffic seeded ``base_seed + ep``),
  ``env.reset``, then ``DDPG.episode_step``, which learns when the
  episode ends at or after the last warm-up step (``end_step >=
  nb_steps_warmup_critic - 1``).  ``pipeline=True`` (the default) samples
  the next episodes' traffic on the host in a prefetch thread and reads
  each episode's metrics one episode behind its dispatch;
  ``pipeline=False`` is the serial loop.  Both give the same learner
  state, replay and random source, tensor for tensor: the prefetch thread
  builds host data only, and the main thread moves it to the device and
  draws every random number;
- ``train_parallel`` trains B env replicas on each episode's scheduled
  network with traffic sampled on the device (``DeviceTraffic``; host
  traffic seeded ``base_seed + 1000 * episode + r`` with
  ``device_traffic=False``), on a registry mixture of networks, or on
  the scenario factory's draws under the TD curriculum, with the chunked
  rollout and the end-of-episode learn burst (``parallel.harness``);
- ``train_parallel(plan=...)`` is one rank of a mesh
  (``parallel.mesh``, ``parallel.partition``): the rank rolls out its
  replica rows of every episode (the scenario source's [B] draw, sliced),
  learns on batches gathered alike on every rank, and agrees with the
  other ranks on every control decision (the preemption flag, the finite
  checks, whether a checkpoint or a publish happens); rank 0 owns the
  outputs (observer, rewards CSV, checkpoints, publishes), and the loop
  returns the full learner state and the whole replay on every rank;
- ``train_async`` is ``train_parallel``'s decoupled form (``cli train
  --async``): actor threads, each on its own CUDA stream, roll out into
  the learner's replay ring while this thread learns and publishes
  (``parallel.async_rl``);
- ``evaluate`` runs greedy episodes (no noise, no learning) on the
  inference network, optionally writing the reference's test-mode CSV
  suite to ``<result_dir>/test``.

Every loop runs either observation mode (``AgentConfig.graph_mode``); the
evaluation's ``rl_state`` column is the flat observation itself in flat
mode and the node features flattened alike in graph mode.  With
``tensorboard`` and a ``result_dir`` each loop also writes
``charts/episodic_return`` and ``charts/SPS`` per episode, and the
single-env loop ``losses/qf1_loss``, ``losses/actor_loss`` and
``losses/qf1_values`` after a learn burst, to ``<result_dir>/tb``
through ``torch.utils.tensorboard`` (nothing where it does not import),
as the JAX trainer does.

Cost ledger (``obs.perf``, when the observer keeps one): the single-env
loop observes its first ``episode_step`` dispatch (and the first that
learns, if the first did not), or on the serial loop (``pipeline=False``)
``rollout_episode`` and ``learn_burst`` apart; the replica loop its first
learning ``chunk_step`` with the ``learn_burst`` inside it, the scenario
factory's first ``factory_sample``, and on a mesh's rank 0 the
``chunk_step`` again as ``chunk_step_sharded`` (the rank's program is the
one each rank dispatches).  After the loop the ``dispatch`` phase's wall
goes to the fused entry, as in the JAX package, without the observed
dispatch; the other entries keep their counts untimed (their calls are
enqueued, not waited for); ``train_async`` captures nothing.

Both training loops append one ``rewards.csv`` row (field ``r``) and one
``history`` row per episode, resume from a restored (``init_state``,
``init_buffer(s)``, ``start_episode``) with the random source restored
into ``Trainer.draws``, stop at an episode boundary when a
``PreemptionGuard`` has caught a signal, and report into a
``RunObserver`` (``obs``) when given one: ``episode`` events with the
phase timings, drop reasons and device memory, ``recovery`` events,
``learn_signal`` events when the observer keeps a learn ledger, and the
pipeline watchdog.

Self-healing on the single-env loop, each action a ``recovery`` event: a
``TransientDispatchError`` is dispatched again after a backoff
(``retry_policy``); a dead or interrupted prefetcher is restarted from
the episode counter, and past ``pipeline_fault_limit`` faults the run
continues with the pipeline off; a learner state whose all-finite flag
drains false is rolled back to the last verified snapshot
(``rollback``, ``resilience.guard.RollbackGuard``) and the poisoned
episodes are skipped; periodic checkpoints (``ckpt_manager``,
``ckpt_interval``) save the verified snapshot.  ``fault_plan`` injects
the faults that drive these paths.  On the replica path a fault plan
adds a host-side finite check after every episode, backed by the guard.
The agent config's precision policy applies throughout.

Train-while-serve: both loops take a ``publisher`` (a
:class:`~gsc_tpu_torch.serve.fleet.WeightPublisher`) and a positive
``publish_interval`` and publish the actor every N episodes, one host copy
of its leaves per publish.  The single-env loop ships the rollback
guard's verified snapshot of the drained episode (the live actor when
rollback is off); the replica loop ships the drained actor after a host
finite check, and skips the publish loudly on a non-finite one.
"""
from __future__ import annotations

import contextlib
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
from ..env.observations import GraphObs, obs_map
from ..parallel.dp import ParallelDDPG
from ..parallel.harness import run_chunked_episodes
from ..resilience.faults import FaultInjected, refuse_async_sites
from ..resilience.guard import (RollbackGuard, all_finite, materialize,
                                poison_tree)
from ..resilience.retry import (RetryPolicy, TransientDispatchError,
                                call_with_retry)
from ..sim.state import DROP_REASONS
from ..topology.compiler import Topology
from ..utils.telemetry import PhaseTimer, phase_span
from .buffer import buffer_nbytes
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


def _first(obs):
    """The first replica's observation (either mode)."""
    return obs_map(obs, lambda x: x[0])


def _rl_state(obs) -> List[float]:
    """The first replica's observation as the test-mode CSVs' flat
    ``rl_state``: a flat observation itself, or the node features
    transposed and flattened."""
    x = obs.nodes[0].T if isinstance(obs, GraphObs) else obs[0]
    return x.cpu().numpy().reshape(-1).tolist()


def state_is_finite(state: DDPGState) -> bool:
    """The learner state's all-finite flag, read on the host."""
    return float(all_finite(state)) > 0


class Trainer:
    def __init__(self, env: ServiceCoordEnv, driver: EpisodeDriver,
                 agent_cfg: AgentConfig, seed: int = 0,
                 result_dir: Optional[str] = None, device=None, obs=None,
                 check_invariants: bool = False, fault_plan=None,
                 rollback: bool = True,
                 retry_policy: Optional[RetryPolicy] = None,
                 pipeline_fault_limit: int = 3, learn_ledger=None,
                 tensorboard: bool = False):
        self.env = env
        self.driver = driver
        self.agent_cfg = agent_cfg
        self.seed = seed
        self.result_dir = result_dir
        self.fault_plan = fault_plan
        self.rollback = rollback
        self.retry_policy = retry_policy or RetryPolicy()
        self.pipeline_fault_limit = pipeline_fault_limit
        self.check_invariants = check_invariants
        # the run observer: the trainer reports into it; its lifecycle
        # (start, close) belongs to the caller
        self.obs = obs
        self.learn_obs = obs.learn if obs is not None else None
        # the learn ledger's spec: the observer's, else ``learn_ledger``
        # (a rank of a mesh other than 0 keeps the ledger its rank 0 has,
        # so the curriculum moves alike on every rank)
        spec = (self.learn_obs.spec(driver.num_topo_ids,
                                    driver.topo_id_names)
                if self.learn_obs is not None else learn_ledger)
        self.ddpg = DDPG(env, agent_cfg, device=device, learn_ledger=spec)
        self.device = self.ddpg.device
        if obs is not None:
            obs.record_precision(agent_cfg.precision_policy)
        # the random source of every training path: warm-up uniforms,
        # exploration normals, replay indices, processing-delay noise
        self.draws = Draws(seed, self.device)
        self.history: List[Dict] = []
        self.pddpg: Optional[ParallelDDPG] = None
        # episodes drained when a loop returned, and whether a preemption
        # guard stopped it: the CLI checkpoints off these
        self.completed_episodes = 0
        self.preempted = False
        self.phase_timer: Optional[PhaseTimer] = None
        self._last_drained = -1
        self._live_prefetch = None
        self._topos: Dict[int, Topology] = {}
        # the replica run's TD curriculum (factory mixes), once it ran
        self.curriculum = None
        # the decoupled run's accounting (train_async)
        self.async_info: Optional[Dict] = None
        # a mesh rank's accounting (train_parallel with a plan)
        self.mesh_info: Optional[Dict] = None
        self.tb = None
        if tensorboard and result_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(os.path.join(result_dir, "tb"))
            except ImportError:
                pass

    def _tb_row(self, row: Dict, global_step: int, losses: bool = False):
        """One episode's scalars into the TensorBoard writer, if any."""
        if self.tb is None:
            return
        self.tb.add_scalar("charts/episodic_return", row["episodic_return"],
                           global_step)
        self.tb.add_scalar("charts/SPS", row["sps"], global_step)
        if losses:
            self.tb.add_scalar("losses/qf1_loss", row["critic_loss"],
                               global_step)
            self.tb.add_scalar("losses/actor_loss", row["actor_loss"],
                               global_step)
            self.tb.add_scalar("losses/qf1_values", row["q_values"],
                               global_step)

    def _tb_close(self):
        if self.tb is not None:
            self.tb.close()

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
            self._recover(ep, site="learner_state", action="detected",
                          fault="non_finite_state",
                          detail="checkpoint skipped so the last-good "
                                 "pointer keeps the previous verified state")
            return
        ckpt_manager.save(state, buffer, episode=ep + 1, draws=self.draws)

    def _publish(self, publisher, publish_interval: int, ep: int,
                 start_episode: int, actor, verified: bool):
        """The hot-swap publish after episode ``ep``: ``actor`` (a module
        or a state dict) copied to the host once, the version's manifest
        recording the episode count.  ``verified``: the caller found it
        finite; else it is checked on the host here and a non-finite
        actor is not published."""
        if publisher is None or not publish_interval \
                or (ep + 1 - start_episode) % publish_interval:
            return
        from ..serve.fleet import host_leaves, leaves_finite

        leaves = host_leaves(actor)
        if not verified and not leaves_finite(leaves):
            self._recover(ep, site="learner_state", action="detected",
                          fault="non_finite_state",
                          detail="hot-swap publish skipped so a poisoned "
                                 "actor never reaches the serving fleet")
            return
        publisher.publish(leaves, meta={"episode": ep + 1}, verified=True)

    # ------------------------------------------------------------ resilience
    def _recover(self, episode: int, site: str, action: str,
                 fault: Optional[str] = None, attempt: Optional[int] = None,
                 detail: Optional[str] = None):
        """Log one self-healing action and emit its ``recovery`` event."""
        log.warning("recovery: site=%s action=%s episode=%s fault=%s%s",
                    site, action, episode, fault,
                    f" ({detail})" if detail else "")
        if self.obs is not None:
            self.obs.recovery(episode=episode, site=site, action=action,
                              fault=fault, attempt=attempt, detail=detail)

    def _topology_extra(self, episode: int, episodic_return: float,
                        extra: Optional[Dict] = None) -> Optional[Dict]:
        """Stamp the scheduled network's name on an episode event and
        gauge its return (``topology_return{topology=}``)."""
        if self.obs is None:
            return extra
        name = self.driver.topology_name_for(episode)
        self.obs.hub.gauge("topology_return", float(episodic_return),
                           topology=name)
        return {**(extra or {}), "topology": name}

    def _prefetch_fault_hook(self):
        """The prefetcher's ``before_episode`` hook: the injection point
        of ``slow_episode`` and ``prefetch_die``."""
        plan = self.fault_plan
        if plan is None:
            return None

        def hook(ep: int, stop_event):
            spec = plan.fire("slow_episode", ep)
            if spec is not None:
                stop_event.wait(spec.arg if spec.arg is not None else 1.0)
            if plan.fire("prefetch_die", ep) is not None:
                raise FaultInjected(
                    f"injected prefetcher death at episode {ep}")
        return hook

    def _on_watchdog_escalate(self, age: float):
        """Watchdog escalation (on the watchdog thread): interrupt the live
        prefetcher; the loop restarts it from the episode counter."""
        pf = self._live_prefetch
        if pf is not None:
            pf.interrupt(f"watchdog escalation: no completed episode in "
                         f"{age:.1f}s")

    def _save_verified(self, ckpt_manager, guard: RollbackGuard, state,
                       buffer, episode: int):
        """Checkpoint the guard's verified snapshot (the state after
        ``episode - 1``), whatever the live state has moved on to."""
        _, snap = guard.last_good
        v_state, v_buffer = materialize(snap, state, buffer)
        v_draws = Draws(self.seed, self.device)
        v_draws.generator.set_state(snap.draws)
        ckpt_manager.save(v_state, v_buffer, episode=episode, draws=v_draws)

    # ------------------------------------------------------------ cost ledger
    def _watch(self, sharded: bool = False):
        """``observe(name, learn=True)`` over the observer's cost ledger
        (None without one): the context a dispatch of entry ``name`` runs
        in, observed when the ledger wants it; ``sharded`` records a
        ``chunk_step`` as ``chunk_step_sharded`` too."""
        perf = self.obs.perf if self.obs is not None else None
        if perf is None:
            return None

        def observe(name: str, learn: bool = True):
            also = ((f"{name}_sharded",) if sharded and name == "chunk_step"
                    else ())
            return perf.observe(name, device=self.device, learn=learn,
                                also=also)
        return observe

    def _observations(self, name: str) -> int:
        """The ledger's observations of ``name`` so far (0 without one)."""
        perf = self.obs.perf if self.obs is not None else None
        return 0 if perf is None else perf.observations(name)

    def _exclude_observed(self, name: str, before: int, seconds: float):
        """Leave a dispatch of ``seconds`` out of the timings of ``name``
        (and its ``_sharded`` twin) when it was observed since ``before``
        (``_observations``)."""
        perf = self.obs.perf
        if perf.observations(name) > before:
            for n in (name, f"{name}_sharded"):
                if perf.has(n):
                    perf.exclude(n, seconds)

    def _note_cost_timings(self, timer, primary: Optional[str]):
        """Merge the run's measured wall into the ledger after the loop:
        the ``dispatch`` phase to the fused entry ``primary`` (and its
        ``_sharded`` twin; None on the serial loop, whose phase covers two
        entries), and the phase summary itself."""
        perf = self.obs.perf if self.obs is not None else None
        if perf is None or timer is None:
            return
        phases = timer.summary()
        disp = phases.get("dispatch")
        if primary is not None and disp:
            for name in (primary, f"{primary}_sharded"):
                if perf.has(name):
                    perf.note_timing(name, disp["total_s"], disp["count"])
        perf.note_phases(phases)

    # ------------------------------------------------------------ single env
    def _drain(self, entry, start: float, start_episode: int, timer,
               writer, on_row, verbose: bool) -> bool:
        """Read one dispatched episode's metrics, log its row and report
        it; returns its all-finite verdict (the flags of the state that
        entered the episode and of the state its burst left)."""
        ep, end_step, stats, metrics, sim, topo, replay_bytes = entry
        hub = self.obs.hub if self.obs else None
        steps = self.agent_cfg.episode_steps
        with phase_span("drain", timer, hub):
            replay = stats.pop("replay", None)
            signal = metrics.pop("learn_signal", None) if metrics else None
            row = {k: float(v) for k, v in stats.items()}
            row.update({k: float(v) for k, v in (metrics or {}).items()})
            sps = (ep - start_episode + 1) * steps / (time.perf_counter()
                                                      - start)
            trunc = int(sim.truncated_arrivals[0])
            if trunc > 0:
                log.warning(
                    "episode=%d: %d arrivals admitted late (flow-table "
                    "slot exhaustion): raise SimConfig.max_flows to restore "
                    "exact arrival timing", ep, trunc)
            finite = float(stats["state_finite"]) > 0 and (
                metrics is None or float(metrics["state_finite"]) > 0)
            row.update(episode=ep, sps=sps)
            self.history.append(row)
            writer.write(row["episodic_return"])
            self._tb_row(row, end_step, losses=metrics is not None)
            if on_row is not None:
                on_row(row)
            if verbose:
                log.info("episode=%d return=%.3f succ=%.3f sps=%.1f", ep,
                         row["episodic_return"], row["mean_succ_ratio"],
                         sps)
        if self.check_invariants:
            from ..utils.debug import check_invariants
            errs = check_invariants(sim, topo,
                                    self.env.engine.tables.chain_len)
            if errs:
                log.warning("episode=%d simulator invariants violated: %s",
                            ep, "; ".join(errs))
                if self.obs:
                    self.obs.invariant_violation(ep, errs)
        if self.obs:
            self.obs.episode_end(
                episode=ep, global_step=end_step,
                metrics={k: v for k, v in row.items()
                         if k not in ("episode", "sps")},
                sps=sps, phases=timer.summary(),
                drop_reasons=dict(zip(
                    DROP_REASONS, sim.metrics.drop_reasons[0].tolist())),
                truncated_arrivals=trunc, replay_bytes=replay_bytes,
                extra=self._topology_extra(ep, row["episodic_return"]))
            if self.learn_obs is not None and (signal is not None
                                               or replay is not None):
                self.learn_obs.episode(ep, signal=signal, replay=replay)
        return finite

    def train(self, episodes: int,
              init_state: Optional[DDPGState] = None, init_buffer=None,
              start_episode: int = 0, ckpt_manager=None,
              ckpt_interval: int = 0,
              on_row: Optional[Callable[[Dict], None]] = None,
              pipeline: bool = True, preempt=None, profile: bool = False,
              verbose: bool = False, publisher=None,
              publish_interval: int = 0):
        """Train one env through episode ``episodes - 1``; returns (state,
        buffer).  A restored (``init_state``, ``init_buffer``,
        ``start_episode``), with ``draws`` restored too, continues a run
        bit for bit.  ``on_row`` gets each episode's row; ``preempt`` (a
        ``PreemptionGuard``) stops the loop at the next episode boundary
        after a signal; ``profile`` writes a ``torch.profiler`` trace to
        ``<result_dir>/profile``.  ``publisher`` with a positive
        ``publish_interval`` publishes the guard's verified actor of the
        drained episode every N episodes (the live actor without
        rollback)."""
        refuse_async_sites(self.fault_plan)
        if self.driver.topo_mix:
            # the mixture fills a replica axis the single env lacks
            raise ValueError(
                "topo_mix needs the replica-parallel path "
                "(train_parallel / --replicas > 1); the single-env loop "
                "has no batch axis to fill with the mixture")
        if profile and self.result_dir:
            from ..utils.debug import Profiler
            with Profiler(os.path.join(self.result_dir, "profile")):
                return self.train(episodes, init_state, init_buffer,
                                  start_episode, ckpt_manager, ckpt_interval,
                                  on_row, pipeline, preempt, False, verbose,
                                  publisher, publish_interval)
        self.phase_timer = timer = PhaseTimer()
        hub = self.obs.hub if self.obs else None
        steps = self.agent_cfg.episode_steps
        plan = self.fault_plan
        guard = RollbackGuard(self.draws) if self.rollback else None
        self.preempted = False
        self._last_drained = start_episode - 1
        if ckpt_interval and ckpt_manager is not None and guard is None:
            log.warning("periodic checkpoints save the rollback guard's "
                        "verified snapshots (rollback on); --ckpt-interval "
                        "is ignored this run")

        def make_prefetcher(from_ep):
            pf = self.driver.prefetcher(
                from_ep, max(episodes, start_episode + 1),
                heartbeat=(self.obs.prefetcher_heartbeat()
                           if self.obs else None),
                before_episode=self._prefetch_fault_hook())
            self._live_prefetch = pf
            if self.obs:
                self.obs.attach_prefetcher(pf)
            return pf

        prefetch = make_prefetcher(start_episode) if pipeline else None
        watch = self._watch()
        pipeline_faults = 0
        if self.obs:
            if self.obs.watchdog is not None:
                self.obs.watchdog.on_escalate = self._on_watchdog_escalate
            self.obs.resume_watchdog()
        pending = []   # dispatched episodes whose metrics are not yet read
        max_pending = 1 if pipeline else 0

        def next_episode(ep):
            nonlocal prefetch, pipeline_faults, max_pending
            item = None
            while prefetch is not None and item is None:
                try:
                    with phase_span("host_sample_wait", timer, hub):
                        item = prefetch.get(ep)
                except RuntimeError as e:
                    # the producer died or was interrupted: restart it from
                    # the episode counter (staging depends on the index
                    # alone), or past the limit go on without it
                    pipeline_faults += 1
                    prefetch.close()
                    fault = f"{type(e).__name__}: {e}"
                    if pipeline_faults > self.pipeline_fault_limit:
                        prefetch = self._live_prefetch = None
                        max_pending = 0
                        self._recover(
                            ep, site="pipeline", action="pipeline_off",
                            fault=fault, attempt=pipeline_faults,
                            detail=f"{pipeline_faults} pipeline faults > "
                                   f"limit {self.pipeline_fault_limit}; "
                                   "serial sampling + immediate drains "
                                   "for the rest of the run")
                    else:
                        self._recover(
                            ep, site="prefetcher", action="restart",
                            fault=fault, attempt=pipeline_faults,
                            detail=f"re-staging from episode {ep}")
                        prefetch = make_prefetcher(ep)
            if item is None:
                with phase_span("host_sample", timer, hub):
                    item = self.driver.episode(ep)
            topo, traffic = item
            return self._on_device(topo), traffic.to(self.device)

        writer = self._rewards()
        start = time.perf_counter()
        state = buffer = None
        try:
            topo, traffic = next_episode(start_episode)
            env_state, obs = self.env.reset(topo, traffic, batch=1)
            state = init_state if init_state is not None \
                else self.init_state()
            buffer = init_buffer if init_buffer is not None else \
                self.ddpg.init_buffer(_first(obs))
            replay_bytes = buffer_nbytes(buffer)
            if guard is not None:
                guard.init(start_episode - 1, state, buffer)

            def drain_one():
                """Drain the oldest pending episode: on a finite verdict
                promote the snapshot and checkpoint, else roll back and
                drop the episodes in flight."""
                entry = pending.pop(0)
                k = entry[0]
                if self._drain(entry, start, start_episode, timer, writer,
                               on_row, verbose):
                    self._last_drained = max(self._last_drained, k)
                    if guard is not None:
                        guard.promote(k, state, buffer,
                                      pending_empty=not pending)
                        if (ckpt_manager is not None and ckpt_interval
                                and (k + 1 - start_episode) % ckpt_interval
                                == 0 and guard.last_good[0] == k):
                            self._save_verified(ckpt_manager, guard, state,
                                                buffer, k + 1)
                        # the verified snapshot after episode k (the live
                        # actor may be a dispatch ahead, not yet checked)
                        if guard.last_good[0] == k:
                            self._publish(publisher, publish_interval, k,
                                          start_episode,
                                          guard.last_good[1].nets["actor"],
                                          verified=True)
                    else:
                        self._publish(publisher, publish_interval, k,
                                      start_episode, state.actor,
                                      verified=True)
                    return
                if guard is None:
                    self._recover(
                        k, site="learner_state", action="detected",
                        fault="non_finite_state",
                        detail="rollback disabled (--no-rollback): "
                               "continuing with the poisoned state")
                    self._last_drained = max(self._last_drained, k)
                    return
                dropped = [e[0] for e in pending]
                pending.clear()
                tag, _, _ = guard.restore(state, buffer)
                self._recover(
                    k, site="learner_state", action="rollback",
                    fault="non_finite_state",
                    detail=f"restored snapshot of episode {tag}; skipped "
                           f"poisoned episode {k}"
                           + (f"; dropped in-flight {dropped}"
                              if dropped else ""))

            for ep in range(start_episode, episodes):
                if preempt is not None and preempt.triggered:
                    self.preempted = True
                    self._recover(
                        ep, site="run", action="preempt_snapshot",
                        fault=preempt.signame,
                        detail=f"stopping before episode {ep}; in-flight "
                               "episodes drain, then the caller "
                               "checkpoints")
                    break
                if ep > start_episode:
                    topo, traffic = next_episode(ep)
                    env_state, obs = self.env.reset(topo, traffic, batch=1)
                global_step = ep * steps
                end_step = global_step + steps - 1
                learn = end_step >= self.agent_cfg.nb_steps_warmup_critic - 1
                if guard is not None:
                    # the candidate: the state after episode ep - 1, taken
                    # before any fault injection
                    guard.stage(ep - 1, state, buffer)
                if plan is not None and plan.fire("nan_grads", ep):
                    # the effect of a NaN gradient update on the state
                    # entering this episode
                    poison_tree(state.actor)
                (state, buffer, env_state, obs, stats,
                 metrics) = self._dispatch_with_retry(
                    ep, state, buffer, env_state, obs, topo, traffic,
                    global_step, learn, timer, hub, watch, pipeline)
                if self.obs:
                    self.obs.episode_dispatched(ep)
                pending.append((ep, end_step, stats, metrics, env_state.sim,
                                topo, replay_bytes))
                while len(pending) > max_pending:
                    drain_one()
            while pending:
                drain_one()
        finally:
            if self.obs:
                self.obs.pause_watchdog()
                if self.obs.watchdog is not None:
                    self.obs.watchdog.on_escalate = None
            self._live_prefetch = None
            # only nonempty when an exception propagates: keep the rows of
            # episodes that completed before it, best effort
            while pending:
                entry = pending.pop(0)
                try:
                    self._drain(entry, start, start_episode, timer, writer,
                                on_row, verbose)
                except Exception:
                    log.warning("dropping metrics of episode %d: drain "
                                "failed after a faulted dispatch", entry[0])
                    break
            if prefetch is not None:
                prefetch.close()
            writer.close()
            self._tb_close()
        self.completed_episodes = self._last_drained + 1
        if plan is not None:
            plan.warn_unfired(hub)
        self._note_cost_timings(timer, "episode_step" if pipeline else None)
        if verbose:
            log.info("pipeline phase timings: %s", timer.summary())
        return state, buffer

    def _dispatch_with_retry(self, ep, state, buffer, env_state, obs, topo,
                             traffic, global_step, learn, timer, hub,
                             watch=None, pipeline=True):
        """One episode's ``episode_step`` under the retry policy, observed
        by the cost ledger's ``watch`` when it wants it (as
        ``episode_step``; on the serial loop as ``rollout_episode`` and
        ``learn_burst``).  The injected ``dispatch_transient`` raises at
        entry, before any tensor is touched, so a retry dispatches the
        same inputs."""
        plan = self.fault_plan

        def dispatch():
            if plan is not None and plan.fire("dispatch_transient", ep):
                raise TransientDispatchError(
                    f"injected transient dispatch failure at episode {ep}")
            fused = watch is not None and pipeline
            before = self._observations("episode_step")
            t0 = time.perf_counter()
            with phase_span("dispatch", timer, hub), \
                    torch.profiler.record_function(f"episode_step_{ep}"), \
                    (watch("episode_step", learn) if fused
                     else contextlib.nullcontext()):
                out = self.ddpg.episode_step(
                    state, buffer, env_state, obs, topo, traffic,
                    global_step, self.draws, learn=learn,
                    observe=None if pipeline else watch)
            if fused:
                self._exclude_observed("episode_step", before,
                                       time.perf_counter() - t0)
            return out

        return call_with_retry(
            dispatch, self.retry_policy,
            on_retry=lambda attempt, exc, delay: self._recover(
                ep, site="dispatch", action="retry", fault=repr(exc),
                attempt=attempt,
                detail=f"backing off {delay:.2f}s before re-dispatch"))

    # ------------------------------------------------------- replica-parallel
    def _episode_generator(self, episode: int) -> torch.Generator:
        """The random source of one episode's device-sampled scenarios
        and traffic, seeded by the trainer's seed and the episode alone
        (a resumed run draws the same episodes)."""
        g = torch.Generator(device=self.device)
        return g.manual_seed(((self.seed & 0xFFFFFFFF) << 32)
                            | (2000 + episode))

    def _scenario_source(self, num_replicas: int, device_traffic: bool,
                         curriculum):
        """(inputs(ep) -> (topology, [B] traffic) on the device, the mix
        plan or None, the factory or None, the curriculum or None) of a
        replica run: the scheduled network per episode with one
        ``DeviceTraffic`` per network (or host traffic), the driver's mix
        plan with device or host traffic, or the scenario factory
        steered by the curriculum."""
        from ..sim.traffic_device import DeviceTraffic
        from ..topology.scenarios import (mix_device_samplers,
                                          sample_mix_device)

        drv, dev = self.driver, self.device
        factory = drv.factory_on(dev) if drv.factory_spec else None
        if factory is not None and not device_traffic:
            raise ValueError(
                "the scenario factory IS on-device sampling — "
                "device_traffic=False has no host path to fall back to "
                "(use a registry --topo-mix for host-generated traffic)")
        plan = (drv.mix_plan(num_replicas)
                if drv.topo_mix and factory is None else None)
        curr = None
        if factory is not None:
            from ..env.curriculum import Curriculum, CurriculumConfig
            curr = Curriculum(factory.family_names,
                              curriculum or CurriculumConfig())
            return (lambda ep: factory.sample_batch(
                self._episode_generator(ep),
                torch.as_tensor(curr.weights(), dtype=torch.float32),
                num_replicas), None, factory, curr)
        samplers = {}
        if plan is not None:
            topo = self._on_device(plan.topo)
            if not device_traffic:
                return (lambda ep: (topo, drv.mix_traffic(ep, plan).to(dev)),
                        plan, None, None)
            mix = mix_device_samplers(plan, drv.sim_cfg, drv.service,
                                      drv.episode_steps,
                                      default_trace=drv.trace, device=dev)
            return (lambda ep: (topo, sample_mix_device(
                plan, mix, self._episode_generator(ep))), plan, None, None)

        def scheduled(ep):
            host = drv.topology_for(ep)
            topo = self._on_device(host)
            if not device_traffic:
                return topo, drv.replica_traffic(ep, num_replicas).to(dev)
            # one sampler per scheduled network object
            if id(host) not in samplers:
                samplers[id(host)] = DeviceTraffic(
                    drv.sim_cfg, drv.service, host, drv.episode_steps,
                    trace=drv.trace, capacity=drv.capacity, device=dev)
            return topo, samplers[id(host)].sample_batch(
                self._episode_generator(ep), num_replicas)
        return scheduled, None, None, None

    def train_parallel(self, episodes: int, num_replicas: int,
                       chunk: int = 50,
                       on_row: Optional[Callable[[Dict], None]] = None,
                       init_state: Optional[DDPGState] = None,
                       init_buffers=None, start_episode: int = 0,
                       ckpt_manager=None, ckpt_interval: int = 0,
                       preempt=None, profile: bool = False,
                       verbose: bool = False, device_traffic: bool = True,
                       curriculum=None, publisher=None,
                       publish_interval: int = 0, plan=None):
        """Train ``num_replicas`` replicas through episode ``episodes -
        1``; returns (state, buffers).  Each episode runs on the network
        the schedule names, its traffic sampled on the device
        (``DeviceTraffic``, one per network; ``device_traffic=False``: the
        host traffic seeded ``base_seed + 1000 * episode + r``); under the
        driver's registry ``topo_mix`` on the mix plan's per-replica
        networks (device or host traffic alike); under a ``factory:`` mix
        on scenarios the ``ScenarioFactory`` samples per replica and
        episode, whose family weights the TD curriculum (``curriculum``, a
        ``CurriculumConfig``) moves after each episode from the learn
        ledger's per-family |TD| (uniform without a ledger), with
        ``curriculum_weight{family=}`` gauges and one ``curriculum`` event
        per episode.  Device draws come from a generator seeded by the
        trainer's seed and the episode.  Resumes, stops on preemption and
        reports like ``train``; episode events of a mixed batch carry the
        per-entry returns (``per_topology_return``), and the learn ledger
        attributes |TD| per entry or family.  Episodes drain as they
        finish, so the live state after an episode is the one checked:
        periodic checkpoints save a state found finite on the host, and
        under a fault plan every episode is checked on the host
        (``nan_grads`` poisons the state entering its episode) and a
        non-finite one rolls back to the guard's last verified
        snapshot.  ``publisher`` with a positive ``publish_interval``
        publishes the drained actor every N episodes after a host finite
        check (a non-finite one is skipped with a ``recovery`` event).

        ``plan`` (a ``parallel.partition.ShardingPlan``) makes this one
        rank of its mesh: ``init_buffers`` then holds the rank's replica
        rows, each episode's scenarios are drawn whole and sliced to them,
        the state lives in the plan's residency between episodes, every
        control decision is agreed across ranks, checkpoints and
        publishes gather the state (and the replay) to rank 0, and the
        returned state and replay are whole on every rank."""
        if profile and self.result_dir:
            from ..utils.debug import Profiler
            with Profiler(os.path.join(self.result_dir, "profile")):
                return self.train_parallel(
                    episodes, num_replicas, chunk, on_row, init_state,
                    init_buffers, start_episode, ckpt_manager, ckpt_interval,
                    preempt, False, verbose, device_traffic, curriculum,
                    publisher, publish_interval, plan)
        refuse_async_sites(self.fault_plan)
        steps = self.agent_cfg.episode_steps
        if steps % chunk != 0:
            raise ValueError(f"chunk ({chunk}) must divide episode_steps "
                             f"({steps})")
        self.pddpg = pddpg = ParallelDDPG(
            self.env, self.agent_cfg, num_replicas, device=self.device,
            seed=self.seed, learn_ledger=self.ddpg.learn_ledger, plan=plan)
        inputs, mix, factory, curr = self._scenario_source(
            num_replicas, device_traffic, curriculum)
        mesh = plan.mesh if plan is not None else None
        if plan is not None:
            whole = inputs
            inputs = lambda ep: tuple(x.rows(pddpg.lo, pddpg.hi)
                                      for x in whole(ep))
        pddpg.draws = self.draws
        self.draws.rows = pddpg.draw_rows
        topo0, traffic0 = self._episode(0)
        _, one_obs = self.env.reset(topo0, traffic0, batch=1)
        state = init_state if init_state is not None else \
            pddpg.init(torch.Generator().manual_seed(self.seed))
        buffers = init_buffers if init_buffers is not None else \
            pddpg.init_buffers(_first(one_obs))
        # what rank 0 alone knows, agreed once: whether checkpoints and
        # publishes happen (every rank joins their gathers)
        saves = ckpt_manager is not None
        publishes = publisher is not None
        if mesh is not None:
            saves, publishes = mesh.agree_any(saves), mesh.agree_any(
                publishes)
            plan.place_state(state)
        chaos = self.fault_plan
        guard = None
        if chaos is not None and self.rollback:
            guard = RollbackGuard(self.draws)
            guard.init(start_episode - 1, state, buffers)
        self.phase_timer = timer = PhaseTimer()
        hub = self.obs.hub if self.obs else None
        self.preempted = False
        self._last_drained = start_episode - 1
        writer = self._rewards()
        start = time.perf_counter()
        if self.obs:
            self.obs.resume_watchdog()
        watch = self._watch(sharded=plan is not None)

        def episode_inputs(ep):
            # what producing the episode's (topology, traffic) costs the
            # host: sampling on the host, or enqueueing the device work
            observed = watch is not None and factory is not None
            with phase_span("scenario_regen", timer, hub), \
                    (watch("factory_sample") if observed
                     else contextlib.nullcontext()):
                return inputs(ep)

        def due(interval: int) -> bool:
            return bool(interval) and (ep + 1 - start_episode) % interval == 0

        def finite(st) -> bool:
            # the host finite check, agreed: under the sharded book each
            # rank holds other slices of the state
            ok = state_is_finite(st)
            return mesh.agree_all(ok) if mesh is not None else ok

        def whole_state(fn):
            # run fn on the full learner state (gathered on every rank
            # under a plan) and go back to the residency after
            if plan is not None:
                plan.gather_state(state)
            try:
                return fn()
            finally:
                if plan is not None:
                    plan.place_state(state)

        try:
            for ep in range(start_episode, episodes):
                stop = preempt is not None and preempt.triggered
                if mesh is not None:
                    stop = mesh.agree_any(stop)
                if stop:
                    self.preempted = True
                    self._recover(
                        ep, site="run", action="preempt_snapshot",
                        fault=getattr(preempt, "signame", None),
                        detail=f"stopping before episode {ep}; the caller "
                               "checkpoints the drained state")
                    break
                if chaos is not None and chaos.fire("nan_grads", ep):
                    poison_tree(state.actor)
                if self.obs:
                    self.obs.episode_dispatched(ep)
                done = {}
                before = self._observations("chunk_step")
                t0 = time.perf_counter()
                with phase_span("dispatch", timer, hub):
                    state, buffers = run_chunked_episodes(
                        pddpg, episode_inputs, state, buffers, ep + 1,
                        steps, chunk,
                        on_episode=lambda e, res: done.update(res),
                        start_episode=ep, observe=watch)
                if watch is not None:
                    self._exclude_observed("chunk_step", before,
                                           time.perf_counter() - t0)
                ret = done["episodic_return"]
                learned = done["learn"]
                signal = (learned or {}).pop("learn_signal", None)
                if curr is not None:
                    # the next episode's family weights from this one's
                    # per-family |TD| (host arithmetic on drained values)
                    if signal is not None:
                        curr.fold_td(signal["td_abs_sum"].cpu().numpy(),
                                     signal["td_count"].cpu().numpy())
                    curr.emit_weights(hub, ep)
                if chaos is not None:
                    # the replicas drain as they finish: the live state is
                    # the state after episode ep
                    if finite(state):
                        if guard is not None:
                            guard.promote(ep, state, buffers,
                                          pending_empty=True)
                    elif guard is not None:
                        tag, _, _ = guard.restore(state, buffers)
                        self._recover(
                            ep, site="learner_state", action="rollback",
                            fault="non_finite_state",
                            detail=f"restored snapshot of episode {tag}; "
                                   f"dropped poisoned episode {ep}")
                    else:
                        self._recover(
                            ep, site="learner_state", action="detected",
                            fault="non_finite_state",
                            detail="rollback disabled (--no-rollback): "
                                   "continuing with the poisoned state")
                sps = ((ep - start_episode + 1) * steps * num_replicas
                       / (time.perf_counter() - start))
                row = {"episode": ep, "episodic_return": ret,
                       "mean_succ_ratio": done["mean_succ_ratio"],
                       "final_succ_ratio": done["final_succ_ratio"],
                       **{k: float(v) for k, v in (learned or {}).items()},
                       "sps": sps}
                self.history.append(row)
                writer.write(ret)
                self._tb_row(row, (ep + 1) * steps)
                if on_row is not None:
                    on_row(row)
                if verbose:
                    log.info("episode=%d return=%.3f succ=%.3f sps=%.1f",
                             ep, ret, row["mean_succ_ratio"], sps)
                if self.obs:
                    extra = {"replicas": num_replicas}
                    if mix is not None:
                        extra.update(self._entry_returns(
                            mix.names, done["per_replica_return"]))
                    elif factory is None:
                        # one network per episode: its schedule name
                        extra = self._topology_extra(ep, ret, extra=extra)
                    self.obs.episode_end(
                        episode=ep, global_step=(ep + 1) * steps - 1,
                        metrics={k: v for k, v in row.items()
                                 if k not in ("episode", "sps")},
                        sps=sps, phases=timer.summary(),
                        replay_bytes=buffer_nbytes(buffers), extra=extra)
                    if self.learn_obs is not None and (
                            signal is not None or done["replay"] is not None):
                        self.learn_obs.episode(ep, signal=signal,
                                               replay=done["replay"])
                self._last_drained = ep
                # a mesh gathers the state (and the replay) on every rank
                # before rank 0 checks it on the host and writes it out
                if mesh is None:
                    self._publish(publisher, publish_interval, ep,
                                  start_episode, state.actor, verified=False)
                    self._maybe_save(ckpt_manager, ckpt_interval, ep,
                                     start_episode, state, buffers)
                else:
                    if publishes and due(publish_interval):
                        whole_state(lambda: self._publish(
                            publisher, publish_interval, ep, start_episode,
                            state.actor, verified=False))
                    if saves and due(ckpt_interval):
                        whole_state(lambda: self._maybe_save(
                            ckpt_manager, ckpt_interval, ep, start_episode,
                            state, plan.gather_buffers(buffers,
                                                       num_replicas)))
        finally:
            if self.obs:
                self.obs.pause_watchdog()
            writer.close()
            self._tb_close()
            self.draws.rows = None
        self.completed_episodes = self._last_drained + 1
        self.curriculum = curr
        if chaos is not None:
            chaos.warn_unfired(hub)
        self._note_cost_timings(timer, "chunk_step")
        if plan is not None:
            self.mesh_info = {
                "mesh": plan.describe(), "rank": mesh.rank,
                "rules": plan.rules_name,
                "split_leaves": len(plan.split_leaves()),
                "entry_gathers": plan.entry_gathers,
                "resident_bytes": plan.resident_bytes,
                "full_bytes": plan.full_bytes,
                "batch_gathers": plan.gathers,
                "gather_ms_per_step": (1e3 * plan.gather_s / plan.gathers
                                       if plan.gathers else None),
                "burst_s": list(pddpg.burst_s),
                "rollout_s": pddpg.rollout_s,
                "rollout_env_steps": pddpg.rollout_steps}
            # the full learner state and the whole replay on every rank
            plan.gather_state(state)
            buffers = plan.gather_buffers(buffers, num_replicas)
        return state, buffers

    def train_async(self, episodes: int, num_replicas: int,
                    chunk: int = 50, actor_threads: int = 2,
                    verbose: bool = False, device_traffic: bool = True,
                    profile: bool = False,
                    init_state: Optional[DDPGState] = None,
                    init_buffers=None, start_episode: int = 0,
                    ckpt_manager=None, ckpt_interval: int = 0,
                    preempt=None, plan=None, publisher=None,
                    publish_bursts: int = 1, curriculum=None,
                    max_staleness: int = 0, learn_ratio: float = 1.0,
                    throttle_s: float = 0.0,
                    on_row: Optional[Callable[[Dict], None]] = None):
        """Decoupled actor/learner training (``cli train --async``):
        ``actor_threads`` threads roll ``num_replicas`` replicas out
        continuously, each on its own CUDA stream, and ship transition
        blocks into the shared replay ring, while this thread, the
        learner, ingests them, runs learn bursts under its
        ``learn_ratio`` pacing and publishes the actor every
        ``publish_bursts`` bursts through a ``WeightPublisher`` that the
        actors adopt from between chunks (``parallel.async_rl``).

        Scenarios come from the same source as ``train_parallel``'s (the
        schedule with device traffic, a registry mix, or the factory
        under the TD curriculum, whose weights each burst's learning
        signal moves), keyed by the global episode index.  Episodes drain
        in completion order: each one appends a ``history`` row and a
        ``rewards.csv`` row and reports an ``episode`` event with the
        acting actor and policy version; the ``policy_lag``,
        ``replay_lag``, ``learner_idle_frac``, ``actor_idle_frac`` and
        ``replay_fill_frac`` gauges and the ``actor_dispatch``,
        ``replay_ingest``, ``learn_dispatch``, ``actor_idle`` and
        ``learner_idle`` phases go to the observer.  A preemption stops
        the actors at their next boundary after the learner has drained
        everything produced; periodic checkpoints are saved from this
        thread at the contiguous drained prefix; ``publisher`` (the
        hot-swap directory's) is the bus the actors subscribe to.  Under
        a fault plan the async sites fire and, with ``rollback``, blocks
        are quarantined and bursts rolled back.  ``plan`` (a mesh) does
        not exist in the port and must be None.  Returns (state,
        buffers); the run's accounting is ``self.async_info``."""
        if plan is not None:
            raise ValueError("the port has no device mesh: plan must be "
                             "None")
        if not self.agent_cfg.graph_mode:
            raise ValueError("decoupled training (--async) of a flat agent "
                             "(graph_mode: false) is not ported yet")
        if profile and self.result_dir:
            from ..utils.debug import Profiler
            with Profiler(os.path.join(self.result_dir, "profile")):
                return self.train_async(
                    episodes, num_replicas, chunk,
                    actor_threads=actor_threads, verbose=verbose,
                    device_traffic=device_traffic, profile=False,
                    init_state=init_state, init_buffers=init_buffers,
                    start_episode=start_episode,
                    ckpt_manager=ckpt_manager, ckpt_interval=ckpt_interval,
                    preempt=preempt, publisher=publisher,
                    publish_bursts=publish_bursts, curriculum=curriculum,
                    max_staleness=max_staleness, learn_ratio=learn_ratio,
                    throttle_s=throttle_s, on_row=on_row)
        import threading

        from ..parallel.async_rl import AsyncConfig, run_async

        steps = self.agent_cfg.episode_steps
        if steps % chunk != 0:
            raise ValueError(f"chunk ({chunk}) must divide episode_steps "
                             f"({steps})")
        inputs, mix, factory, curr = self._scenario_source(
            num_replicas, device_traffic, curriculum)
        self.pddpg = pddpg = ParallelDDPG(
            self.env, self.agent_cfg, num_replicas, device=self.device,
            seed=self.seed, learn_ledger=self.ddpg.learn_ledger)
        # the learner's random source (replay indices); each actor draws
        # from its own
        pddpg.draws = self.draws
        topo0, traffic0 = self._episode(0)
        _, one_obs = self.env.reset(topo0, traffic0, batch=1)
        state = init_state if init_state is not None else \
            pddpg.init(torch.Generator().manual_seed(self.seed))
        buffers = init_buffers if init_buffers is not None else \
            pddpg.init_buffers(_first(one_obs))
        self.phase_timer = timer = PhaseTimer()
        hub = self.obs.hub if self.obs else None
        self.preempted = False
        self._last_drained = start_episode - 1
        writer = self._rewards()
        # the curriculum's weights are read by actor threads (scenarios)
        # and moved by this one (bursts)
        curr_lock = threading.Lock()

        def scenario_fn(ep):
            with phase_span("scenario_regen", timer, hub), curr_lock:
                return inputs(ep)

        start = time.perf_counter()
        drained_n = [0]
        # episodes drain in completion order: the resume counter advances
        # only through the contiguous drained prefix
        drained_set: set = set()
        prefix = [start_episode - 1]

        def on_episode(rec, ring):
            ep = rec["episode"]
            drained_n[0] += 1
            sps = (drained_n[0] * steps * num_replicas
                   / (time.perf_counter() - start))
            ret = rec["episodic_return"]
            row = {"episode": ep, "episodic_return": ret,
                   "mean_succ_ratio": rec["mean_succ_ratio"],
                   "final_succ_ratio": rec["final_succ_ratio"],
                   "actor": rec["actor"],
                   "policy_version": rec["policy_version"], "sps": sps}
            self.history.append(row)
            writer.write(ret)
            self._tb_row(row, (ep + 1) * steps)
            if on_row is not None:
                on_row(row)
            if verbose:
                log.info("episode=%d actor=%d v=%d return=%.3f sps=%.1f",
                         ep, rec["actor"], rec["policy_version"], ret, sps)
            if curr is not None:
                with curr_lock:
                    curr.emit_weights(hub, ep)
            if self.obs:
                extra = {"replicas": num_replicas, "actor": rec["actor"],
                         "policy_version": rec["policy_version"]}
                if mix is not None:
                    extra.update(self._entry_returns(
                        mix.names, rec["per_replica_return"]))
                elif factory is None:
                    extra = self._topology_extra(ep, ret, extra=extra)
                self.obs.episode_dispatched(ep)
                self.obs.episode_end(
                    episode=ep, global_step=(ep + 1) * steps - 1,
                    metrics={k: v for k, v in row.items()
                             if k not in ("episode", "sps", "actor",
                                          "policy_version")},
                    sps=sps, phases=timer.summary(),
                    replay_bytes=buffer_nbytes(ring), extra=extra)
            if hub is not None:
                hub.gauge("replay_fill_frac",
                          float(ring.size.sum()) / (ring.size.numel()
                                                    * ring.capacity))
            drained_set.add(ep)
            while prefix[0] + 1 in drained_set:
                prefix[0] += 1
                drained_set.discard(prefix[0])
            self._last_drained = prefix[0]

        def on_burst(n, st, metrics):
            sig = (metrics or {}).get("learn_signal")
            if curr is not None and sig is not None:
                # the curriculum steers from each burst's |TD|: bursts
                # are not tied to one episode's drain
                with curr_lock:
                    curr.fold_td(sig["td_abs_sum"].cpu().numpy(),
                                 sig["td_count"].cpu().numpy())

        def checkpoint_fn(st, ring, n_drained):
            # the contiguous drained prefix tags it, so a resume never
            # skips an undrained episode
            if state_is_finite(st):
                ckpt_manager.save(st, ring, episode=self._last_drained + 1,
                                  draws=self.draws)
            else:
                self._recover(
                    self._last_drained, site="learner_state",
                    action="detected", fault="non_finite_state",
                    detail="checkpoint skipped so the last-good pointer "
                           "keeps the previous verified state")

        cfg = AsyncConfig(actor_threads=actor_threads,
                          publish_bursts=publish_bursts,
                          max_staleness=max_staleness,
                          learn_ratio=learn_ratio, throttle_s=throttle_s)
        if self.obs:
            self.obs.resume_watchdog()
        try:
            res = run_async(
                pddpg, scenario_fn, state, buffers, episodes, steps, chunk,
                self.seed, cfg, publisher=publisher, hub=hub, timer=timer,
                on_episode=on_episode, on_burst=on_burst,
                should_stop=((lambda: preempt.triggered)
                             if preempt is not None else None),
                start_episode=start_episode,
                checkpoint_every=(ckpt_interval if ckpt_manager is not None
                                  else 0),
                checkpoint_fn=(checkpoint_fn if ckpt_manager is not None
                               else None),
                fault_plan=self.fault_plan,
                rollback=(self.rollback and self.fault_plan is not None),
                on_recovery=self._recover, retry_policy=self.retry_policy)
        finally:
            if self.obs:
                self.obs.pause_watchdog()
            writer.close()
            self._tb_close()
        if preempt is not None and preempt.triggered:
            self.preempted = True
            self._recover(
                self._last_drained + 1, site="run",
                action="preempt_snapshot", fault=preempt.signame,
                detail="async run drained and stopped; the caller "
                       "checkpoints the drained state")
        self.completed_episodes = self._last_drained + 1
        self.curriculum = curr
        self.async_info = res.info
        if self.fault_plan is not None:
            self.fault_plan.warn_unfired(hub)
        if hub is not None:
            hub.event("async_train", **res.info)
        return res.state, res.buffers

    def _entry_returns(self, names, returns) -> Dict:
        """A mixed batch's returns per mix entry (the mean over its
        replicas), gauged as ``topology_return{topology=}``, and the
        per-replica entry names, for the episode event."""
        groups: Dict[str, List[float]] = {}
        for name, v in zip(names, returns):
            groups.setdefault(name, []).append(v)
        per = {n: float(np.mean(v)) for n, v in groups.items()}
        for n, v in per.items():
            self.obs.hub.gauge("topology_return", v, topology=n)
        return {"topology": list(names), "per_topology_return": per}

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
                t_ep = time.perf_counter()
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
                            rl_state=_rl_state(obs),
                            truncated_arrivals=int(sim.truncated_arrivals[0]))
                totals.append(ep_reward)
                succ.append(float(info["succ_ratio"][0]))
                if self.obs is not None:
                    self.obs.eval_episode(ep, ep_reward, succ[-1],
                                          time.perf_counter() - t_ep)
        if writer:
            writer.close()
        total_s = time.perf_counter() - t_eval0
        warmup = warmup_s if warmup_s is not None else total_s
        return {"mean_return": float(np.mean(totals)),
                "final_succ_ratio": float(np.mean(succ)),
                "compile_warmup_s": round(warmup, 3),
                "steady_s": round(total_s - warmup, 3),
                "total_s": round(total_s, 3)}
