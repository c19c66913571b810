"""Decoupled actor/learner training, the Sebulba shape.

The port of ``gsc_tpu.parallel.async_rl``.
``Trainer.train_parallel`` interleaves acting and learning on one thread;
here they run apart:

- **Actor threads** roll the replicas out continuously, each on its own
  CUDA stream, with its own copy of the actor network
  (``ParallelDDPG.actor_copy``), its own env replicas and its own random
  source (``ParallelDDPG.actor_draws``: a generator on the device seeded
  by (seed, 1000 + actor)).  Every chunk is written into a fresh scratch
  ring of one chunk, whose leaves (the block) go to the learner through
  a bounded channel together with an event recorded on the actor's
  stream after the chunk, and the chunk's per-replica rewards, success
  ratios and delays, unmeaned (``rollout_episodes(local=True)``, which
  issues no collective).  Between chunks an actor adopts newly
  published weights through an in-process ``VersionWatcher`` on the
  ``WeightPublisher`` (``serve.fleet``), so no chunk mixes two policy
  versions.

- The **learner** (the calling thread) owns the shared [B, cap] replay
  ring and the learner state, whose modules and Adam moments the learn
  bursts update in place; no actor thread reads them.  It pops every
  queued block, makes its own stream wait on the block's event, marks
  the block's memory as used by its stream (``record_stream``, so that
  the caching allocator never hands an actor's freed block to another
  allocation while the ingest still reads it) and folds it into the ring
  (``make_replay_ingest``, one index copy per leaf).  It runs learn
  bursts whenever its budget allows (``learn_ratio``: 1.0 is one burst
  per B x episode_steps ingested steps, the synchronous loop's pace) and
  publishes the actor every ``publish_bursts`` bursts (one host copy of
  its leaves).  No thread calls a device-wide synchronisation.

Staleness is bounded and measured: ``max_staleness`` caps the produced
but not yet ingested steps (the channel blocks the producer; the wait is
the ``actor_idle`` phase), ``policy_lag`` gauges how many published
versions behind each ingested block's acting policy was, ``replay_lag``
the backlog at each ingest, and waiting for ingested steps to unlock a
burst is the ``learner_idle`` phase.

Episodes are owned by global index (actor a runs start + a, start + a +
A, ...), and each episode's scenario comes from ``scenario_fn(ep)``
under one lock, so what an episode trains on does not depend on the
number of actor threads.

**Over the ranks of a mesh** (``train --async --mesh``: the
``ParallelDDPG`` carries a ``ShardingPlan`` over the dp axis; a tp-only
carving is refused, ``ShardingPlan.assert_async_capable``).  Every rank
is one process with its own actor threads (``cfg.actor_threads`` per
rank), which roll out only the rank's replica rows ``plan.rows(B)``, and
its own learner, whose ring is the rank's shard ``[rows, cap]``: an
ingest is a local write.  The process group matches collectives by the
order each rank issues them, so only the learner thread talks to it
(``parallel.mesh`` raises on a collective from any other thread), and it
issues them in a sequence every rank derives from the same numbers.
Each pass of the learner loop begins with one agreement (an all_reduce
MIN of one integer vector, ``Mesh.agree_min``) that settles the pass:
the fewest steps any rank has ingested (which paces the bursts), whether
any rank was asked to stop, whether every rank's fleet has finished, and
which episodes have drained on every rank.  Then, in this order: the
episodes newly drained on every rank (in global episode order) with
their per-replica numbers gathered into global replica order and meaned
as a run without a mesh means them, a checkpoint (the rings gathered,
``ShardingPlan.gather_buffers``), at most one learn burst
(``ParallelDDPG.learn_burst``: every rank samples the same global batch
and gathers its rows as bytes, so every rank ends the burst with the
same learner state and no gradient is reduced), and a publish after a
burst (the state gathered from the plan's residency; each rank's actors
adopt from the rank's own publisher).  Each of these holds
``ParallelDDPG.dispatch_lock``: the lock orders the threads of a rank,
the agreement orders the ranks.  ``info`` reports the ring shards and
the collectives the actor threads and the ingests issued (both 0).
Without a plan the loop is the same, its agreement this process's own
numbers.  A scenario source that the learner moves (the factory's
curriculum) is read by the actors from a snapshot per episode, which
the learner hands out at the same pass on every rank
(``scenario_snapshot``), so every rank's rows of an episode come from
one draw.

Self-healing, as in the JAX package: an ``ActorSupervisor`` restarts a
dead actor thread (an exception or the ``actor_die`` fault) from its
episode counter within ``restart_budget``, then degrades the fleet and
hands the dead actor's episodes to the survivors.  With ``rollback``
the learner checks every popped block for non-finite values and
quarantines a poisoned one (``ring_poison``), and keeps a
``RollbackGuard`` snapshot verified one burst late from the burst's
``state_finite`` flag (``nan_grads`` poisons the state entering the
keyed burst); ``learner_transient`` is retried with backoff,
``watcher_stall`` skips one adoption, ``publish_corrupt`` is refused by
the watchers' finite check.  Every recovery goes to ``on_recovery``.
With neither ``rollback`` nor a ``fault_plan`` none of it runs.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..agents.buffer import ReplayBuffer, buffer_nbytes
from ..env.observations import obs_map
from ..ops.cost import collective_counts
from ..resilience.faults import FaultInjected
from ..resilience.guard import RollbackGuard, all_finite, poison_tree
from ..resilience.retry import (RetryPolicy, TransientDispatchError,
                                call_with_retry)
from .dp import make_replay_ingest, replica_stats

log = logging.getLogger("gsc_tpu_torch.parallel.async_rl")


@dataclass
class AsyncConfig:
    """Knobs for the decoupled actor/learner loop."""

    actor_threads: int = 2
    # learner -> actor weight publish cadence, in learn bursts
    publish_bursts: int = 1
    # produced but not yet ingested env steps the actors may run ahead of
    # the learner before the channel blocks them; 0: two episodes per
    # actor (one being acted, one queued behind the learner's ingest)
    max_staleness: int = 0
    # the learner's burst budget per ingested env step, relative to the
    # synchronous loop (1.0: one burst per B * episode_steps steps)
    learn_ratio: float = 1.0
    # test hook: seconds the learner sleeps after each burst
    throttle_s: float = 0.0
    # seconds the learner waits per idle poll
    idle_wait_s: float = 0.002
    # supervised restarts per actor before the fleet degrades
    restart_budget: int = 2


class _Channel:
    """Bounded actor -> learner conduit of transition blocks.  ``put``
    blocks while the backlog (produced - ingested steps) would exceed
    ``max_outstanding``: that wait is the staleness backpressure.  Every
    block carries a FIFO ``seq``."""

    def __init__(self, max_outstanding: int):
        self.max_outstanding = int(max_outstanding)
        self._cond = threading.Condition()
        self._blocks: deque = deque()   # guarded-by: self._cond
        self.produced_steps = 0         # guarded-by: self._cond
        self.ingested_steps = 0         # guarded-by: self._cond
        self.max_observed_lag = 0       # guarded-by: self._cond
        self._seq = 0                   # guarded-by: self._cond
        self._stop = False              # guarded-by: self._cond

    def outstanding(self) -> int:
        # writers hold the cond; monitoring reads tolerate one block of
        # staleness (ints)
        return self.produced_steps - self.ingested_steps  # gsc-lint: disable=R7 -- put() holds the cond; monitor reads tolerate staleness

    def put(self, block, steps: int, version: int, ready=None, timer=None,
            on_wait: Optional[Callable[[float], None]] = None) -> int:
        """Enqueue one block (``ready``: the event after which it is
        complete, None on the CPU); returns its seq (>= 1), or 0 when the
        run is stopping.  ``on_wait(seconds)`` gets each backpressure
        wait."""
        with self._cond:
            while (not self._stop and self._blocks
                   and self.outstanding() + steps > self.max_outstanding):
                t0 = time.perf_counter()
                self._cond.wait(0.05)
                waited = time.perf_counter() - t0
                if timer is not None:
                    timer.add("actor_idle", waited)
                if on_wait is not None:
                    on_wait(waited)
            if self._stop:
                return 0
            self._seq += 1
            self._blocks.append((block, int(steps), int(version),
                                 self._seq, ready))
            self.produced_steps += int(steps)
            self.max_observed_lag = max(self.max_observed_lag,
                                        self.outstanding())
            self._cond.notify_all()
            return self._seq

    def get_nowait(self):
        with self._cond:
            if not self._blocks:
                return None
            item = self._blocks.popleft()
            self.ingested_steps += item[1]
            self._cond.notify_all()
            return item

    def wait_for_data(self, timeout: float):
        with self._cond:
            if not self._blocks:
                self._cond.wait(timeout)

    def set_max_outstanding(self, n: int):
        """Re-derive the cap (the fleet degraded): blocked producers wake
        and check the new bound."""
        with self._cond:
            self.max_outstanding = int(n)
            self._cond.notify_all()

    def stop(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()


class _ActorPolicy:
    """The ``VersionWatcher``'s server end for one actor: ``apply_weights``
    runs in the actor's own thread (``poll_once`` between chunks) and
    copies the published host leaves into the actor's module on its
    stream."""

    def __init__(self, actor: torch.nn.Module):
        self.actor = actor
        self.policy_version = 0

    @torch.no_grad()
    def apply_weights(self, leaves, version: int, fingerprint,
                      meta: Optional[Dict] = None):
        for t, leaf in zip(self.actor.state_dict().values(), leaves):
            t.copy_(torch.as_tensor(np.asarray(leaf)), non_blocking=False)
        self.policy_version = int(version)


class ActorSupervisor:
    """Per-actor episode bookkeeping and the restart/degrade policy.

    Each actor owns an ordered queue of its uncompleted episodes.
    ``claim`` returns the head without popping, so an actor that dies
    mid-episode re-runs it from its start on restart (chunks it already
    shipped are ingested twice: replay duplicates, not corruption);
    ``complete`` pops once the episode's stats are staged.  Failures
    queue here and the learner supervises: within ``restart_budget`` per
    actor it spawns a fresh thread, past it the actor is degraded out and
    its episodes go to an orphan queue that the survivors drain after
    their own.  With no survivor and episodes unrun the learner raises
    the last actor error."""

    def __init__(self, assignments: Dict[int, List[int]],
                 restart_budget: int):
        self._lock = threading.Lock()
        self._remaining = {aid: deque(eps)          # guarded-by: self._lock
                           for aid, eps in assignments.items()}
        self._orphans: deque = deque()              # guarded-by: self._lock
        self._failures: deque = deque()             # guarded-by: self._lock
        self.restart_budget = int(restart_budget)
        # mutated by the learner thread only, read after the join
        self.restarts = {aid: 0 for aid in assignments}
        self.dead: set = set()
        self.errors: List[BaseException] = []

    def claim(self, aid: int) -> Optional[int]:
        with self._lock:
            q = self._remaining[aid]
            if not q and self._orphans:
                q.append(self._orphans.popleft())
            return q[0] if q else None

    def complete(self, aid: int, episode: int):
        with self._lock:
            q = self._remaining[aid]
            if q and q[0] == episode:
                q.popleft()

    def report_failure(self, aid: int, episode: int, exc: BaseException):
        with self._lock:
            self._failures.append((aid, episode, exc))

    def pop_failure(self):
        with self._lock:
            return self._failures.popleft() if self._failures else None

    def note_restart(self, aid: int) -> int:
        self.restarts[aid] += 1
        return self.restarts[aid]

    def degrade(self, aid: int, exc: BaseException) -> int:
        """Move the dead actor's episodes to the orphans; returns the
        number of actors still alive."""
        with self._lock:
            self.dead.add(aid)
            self._orphans.extend(self._remaining[aid])
            self._remaining[aid].clear()
            self.errors.append(exc)
            return len(self._remaining) - len(self.dead)

    def unrun(self) -> int:
        with self._lock:
            return (sum(len(q) for q in self._remaining.values())
                    + len(self._orphans))

    def total_restarts(self) -> int:
        return sum(self.restarts.values())


class _FlightLedger:
    """Host-side flight recorder of one run: the threads append plain
    rows (one lock, no device reads, no events on the hot path); the run's
    end emits them as ``async_actor_ep`` and ``async_learner_spans``
    events, which ``obs.trace.build_trace`` turns into per-actor, channel
    and learner tracks with put -> pop and publish -> adopt arrows.

    Rows: actor episode ``{ep, actor, shard, chunks: [[t0, t1, ver]],
    puts: [[t_enq, wait_s, steps, ver, seq]], adopts: [[ts, ver]]}``;
    ingest ``[t0, t1, steps, ver, lag, seq, shard]``; burst ``[t0, t1,
    n]``; publish ``[ts, ver]``.  ``shard`` is the ring shard the blocks
    land in: the rank's under a mesh, else 0."""

    def __init__(self, shard: int = 0):
        self.shard = int(shard)
        self._lock = threading.Lock()
        self.actor_eps: List[Dict] = []   # guarded-by: self._lock
        self.ingests: List[List] = []     # guarded-by: self._lock
        self.bursts: List[List] = []      # guarded-by: self._lock
        self.publishes: List[List] = []   # guarded-by: self._lock

    def note_actor_episode(self, rec: Dict):
        with self._lock:
            self.actor_eps.append(rec)

    def note_ingest(self, t0, t1, steps, version, lag, seq):
        with self._lock:
            self.ingests.append([round(t0, 6), round(t1, 6), int(steps),
                                 int(version), int(lag), int(seq),
                                 self.shard])

    def note_burst(self, t0, t1, n):
        with self._lock:
            self.bursts.append([round(t0, 6), round(t1, 6), int(n)])

    def note_publish(self, ts, version):
        with self._lock:
            self.publishes.append([round(ts, 6), int(version)])

    def flush_deferred(self, hub, chunk_rows: int = 256):
        with self._lock:
            actor_eps = list(self.actor_eps)
            ingests = list(self.ingests)
            bursts = list(self.bursts)
            publishes = list(self.publishes)
        for rec in actor_eps:
            hub.event("async_actor_ep", **rec)
        total = max(len(ingests), len(bursts), len(publishes))
        parts = max(1, -(-total // chunk_rows))
        for p in range(parts):
            lo, hi = p * chunk_rows, (p + 1) * chunk_rows
            hub.event("async_learner_spans", part=p, parts=parts,
                      ingests=ingests[lo:hi], bursts=bursts[lo:hi],
                      publishes=publishes[lo:hi])


@dataclass
class AsyncResult:
    """What one decoupled run produced."""

    state: Any
    buffers: Any
    episodes: List[Dict] = field(default_factory=list)   # drain order
    info: Dict = field(default_factory=dict)


def _poisoned(block: Dict) -> Dict:
    """A NaN copy of a block's float leaves (the ``ring_poison`` fault;
    the actor's own scratch stays as it is)."""
    return {k: v * float("nan") if v.is_floating_point() else v
            for k, v in block.items()}


# the agreement vector's window: at most this many not yet agreed
# episodes are asked about per pass (the rest in later passes)
AGREE_WINDOW = 1024


def run_async(pddpg, scenario_fn: Callable, state, buffers: ReplayBuffer,
              episodes: int, episode_steps: int, chunk: int, seed: int,
              cfg: AsyncConfig, publisher=None, hub=None, timer=None,
              on_episode: Optional[Callable] = None,
              on_burst: Optional[Callable] = None,
              should_stop: Optional[Callable] = None,
              start_episode: int = 0, checkpoint_every: int = 0,
              checkpoint_fn: Optional[Callable] = None,
              fault_plan=None, rollback: bool = False,
              on_recovery: Optional[Callable] = None,
              retry_policy=None,
              scenario_snapshot: Optional[Callable] = None) -> AsyncResult:
    """Drive episodes ``start_episode`` to ``episodes - 1`` through
    ``cfg.actor_threads`` actor threads feeding the learner (this
    thread).  ``scenario_fn(ep) -> (topology, traffic)`` on the device
    supplies episode ``ep``'s scenario, the rank's replica rows under a
    plan (called from actor threads under one lock).  ``on_episode(record,
    ring)`` runs on this thread as each episode drains (``episode``,
    ``actor``, ``policy_version``, ``episodic_return``,
    ``mean_succ_ratio``, ``final_succ_ratio``, ``per_replica_return``);
    ``on_burst(n, state, metrics)`` after each learn burst;
    ``should_stop()`` is polled at every progress point (preemption: the
    actors stop at their next boundary, the learner drains what they
    produced); ``checkpoint_fn(state, ring, drained)`` every
    ``checkpoint_every`` drained episodes, on this thread.
    ``scenario_snapshot()`` (the curriculum's weights, say), when given,
    is taken on this thread for each episode at a pass every rank agrees
    on, once the episodes before it, but for ``2 x cfg.actor_threads``,
    have drained; the actors wait for their episode's and call
    ``scenario_fn(ep, snapshot)``, so that every rank's rows of an
    episode come from one draw.

    The ring and ``state`` are updated in place and returned.  ``info``
    carries the drain-proved accounting: produced == ingested steps,
    bursts, publishes, policy and replay lags, idle fractions and the
    self-healing ledger.

    Under a plan (``pddpg.plan``; the module docstring) every rank calls
    this with its ring shard; an episode drains once it has drained on
    every rank, in the same order on every rank; ``checkpoint_fn`` gets
    the whole state and the gathered ring on every rank; ``state`` is
    returned whole and the ring as the rank's shard.  ``info`` adds ``ring_shards``, ``mesh``,
    ``actor_collectives`` and ``ingest_collectives``.  A tp-only carving
    is refused before anything starts."""
    plan = pddpg.plan
    if plan is not None:
        plan.assert_async_capable()
    from ..serve.fleet import VersionWatcher, WeightPublisher

    mesh = plan.mesh if plan is not None else None
    b_n = pddpg.B
    # this rank's replica rows: a block's and the ring shard's leading dim
    rows_n = pddpg.rows_n
    dev = pddpg.device
    on_card = dev.type == "cuda"
    if episode_steps % chunk != 0:
        raise ValueError(f"chunk ({chunk}) must divide episode_steps "
                         f"({episode_steps})")
    cap = buffers.capacity
    if cap < chunk:
        raise ValueError(
            f"replay capacity per replica ({cap}) must be >= chunk "
            f"({chunk}): a single ingest would wrap past itself")
    n_actors = max(1, int(cfg.actor_threads))
    if episodes - start_episode <= 0:
        return AsyncResult(state=state, buffers=buffers)
    max_stale = (int(cfg.max_staleness) if cfg.max_staleness > 0
                 else 2 * n_actors * rows_n * episode_steps)
    channel = _Channel(max_stale)
    results: deque = deque()
    results_lock = threading.Lock()
    stop_event = threading.Event()
    scenario_lock = threading.Lock()
    guarded = rollback or fault_plan is not None
    replay_ingest = make_replay_ingest(rows_n, cap)
    n_shards = plan.n_devices if plan is not None else 1
    shard = mesh.rank if plan is not None else 0
    counts0 = collective_counts()
    ingest_collectives = 0
    learner_name = threading.current_thread().name

    def recover(episode, site, action, fault=None, attempt=None,
                detail=None):
        if on_recovery is not None:
            on_recovery(episode, site=site, action=action, fault=fault,
                        attempt=attempt, detail=detail)
        else:
            log.warning("recovery: site=%s action=%s fault=%s "
                        "episode=%s %s", site, action, fault, episode,
                        detail or "")

    if publisher is None:
        publisher = WeightPublisher(hub=hub, fault_plan=fault_plan)
    elif fault_plan is not None and publisher.fault_plan is None:
        publisher.fault_plan = fault_plan

    def actor_episodes(aid):
        return range(start_episode + aid, episodes, n_actors)

    supervisor = ActorSupervisor(
        {a: list(actor_episodes(a)) for a in range(n_actors)},
        restart_budget=cfg.restart_budget)
    # the last publish (version, host leaves): a restarted actor adopts it
    latest_pub: List = [None]
    policy_lags: List[int] = []
    ledger = (_FlightLedger(shard) if hub is not None
              and getattr(hub, "series_store", None) is not None else None)
    # per-actor backpressure seconds, each slot written by its actor only
    actor_wait_s = [0.0] * n_actors
    learner_idle_acc = [0.0]
    # the actors' starting weights: a copy taken before the learner moves
    # the live modules (a restarted actor starts here or at the last
    # publish, never at unpublished learner weights)
    template = pddpg.actor_copy(state.actor)
    if plan is not None:
        # between dispatches the state lives in the plan's residency
        plan.place_state(state)
    # episode -> the learner's scenario snapshot; handed out up to
    # ``snap_next`` (the first episode not drained + snap_lead)
    snaps: Dict[int, Any] = {}
    snap_cond = threading.Condition()
    snap_next = [start_episode]
    snap_lead = 2 * n_actors

    def await_snapshot(ep: int, tname: str) -> bool:
        """Wait until episode ``ep``'s snapshot is handed out; False when
        the run stops first."""
        with snap_cond:
            while ep not in snaps:
                if stop_event.is_set():
                    return False
                if hub is not None:
                    hub.note_thread_phase(tname, "scenario_wait")
                    hub.beat(tname)
                snap_cond.wait(0.05)
        return True

    learner_stream = torch.cuda.current_stream(dev) if on_card else None
    if on_card:
        from ..ops.substep import resource_plan

        # the engine's device tables (and the kernel's resource-function
        # plan) are made here, once, not by the first actor on its stream
        resource_plan(pddpg.env.engine, dev)
        # everything the actors read was made on this stream
        learner_stream.synchronize()

    def actor_loop(aid: int):
        tname = f"actor{aid}"
        stream = torch.cuda.Stream(dev) if on_card else None
        ctx = (torch.cuda.stream(stream) if on_card
               else contextlib.nullcontext())
        watcher = None
        ep = -1   # the episode in flight, for the failure report
        try:
            with ctx:
                actor = pddpg.actor_copy(template)
                policy = _ActorPolicy(actor)
                watcher = VersionWatcher(None, policy, hub=hub,
                                         publisher=publisher)
                pub = latest_pub[0]
                if pub is not None:
                    policy.apply_weights(pub[1], pub[0], None)
                draws = pddpg.actor_draws(seed, aid)
                n_chunks = episode_steps // chunk

                def on_wait(waited: float):
                    actor_wait_s[aid] += waited
                    if hub is not None:
                        hub.beat(tname)   # backpressured, not wedged

                while True:
                    if stop_event.is_set():
                        return
                    nxt = supervisor.claim(aid)
                    if nxt is None:
                        return
                    ep = nxt
                    if fault_plan is not None and fault_plan.fire(
                            "actor_die", ep, actor=aid) is not None:
                        raise FaultInjected(
                            f"injected actor death: actor_die@a{aid}:{ep}")
                    snap = ()
                    if scenario_snapshot is not None:
                        if not await_snapshot(ep, tname):
                            return
                        snap = (snaps[ep],)
                    with scenario_lock:
                        topo, traffic = scenario_fn(ep, *snap)
                        if on_card:
                            # samplers made here are read by the next
                            # actor from its own stream
                            stream.synchronize()
                    env_states, obs = pddpg.reset_all(topo, traffic)
                    one_obs = obs_map(obs, lambda x: x[0])
                    chunk_stats, chunks, puts, adopts = [], [], [], []
                    for c in range(n_chunks):
                        if hub is not None:
                            hub.note_thread_phase(tname, "adopt")
                        try:
                            spec = (fault_plan.fire("watcher_stall", ep,
                                                    actor=aid)
                                    if fault_plan is not None else None)
                            if spec is not None:
                                if spec.arg:
                                    time.sleep(float(spec.arg))
                                raise FaultInjected(
                                    f"injected watcher stall: "
                                    f"watcher_stall@a{aid}:{ep}")
                            swapped = watcher.poll_once()
                        except Exception as e:
                            # skip this adoption, act on the current
                            # weights, adopt at the next chunk
                            swapped = False
                            recover(ep, site="watcher", action="skip_adopt",
                                    fault=type(e).__name__,
                                    detail=f"actor {aid}: {e}")
                        if swapped and ledger is not None:
                            adopts.append([round(time.time(), 6),
                                           policy.policy_version])
                        start = ep * episode_steps + c * chunk
                        if hub is not None:
                            hub.note_thread_phase(tname, "dispatch")
                        t_roll = time.time()
                        scratch = pddpg.init_buffers(one_obs, capacity=chunk)
                        with (timer.phase("actor_dispatch") if timer
                              else contextlib.nullcontext()):
                            # the local form issues no collective, so the
                            # actors never take dispatch_lock: taking it
                            # would serialise them with the learner
                            _, scratch, env_states, obs, stats = \
                                pddpg.rollout_episodes(  # gsc-lint: disable=R8 -- the local form issues no collective
                                    None, scratch, env_states, obs, topo,
                                    traffic, start, chunk, actor=actor,
                                    draws=draws, local=True)
                        if ledger is not None:
                            chunks.append([round(t_roll, 6),
                                           round(time.time(), 6),
                                           policy.policy_version])
                        chunk_stats.append(stats)
                        if hub is not None:
                            hub.note_thread_phase(tname, "blocked_put")
                        block = scratch.data
                        if fault_plan is not None and fault_plan.fire(
                                "ring_poison", ep) is not None:
                            block = _poisoned(block)
                        ready = None
                        if on_card:
                            ready = torch.cuda.Event()
                            ready.record(stream)
                        wait0 = actor_wait_s[aid]
                        seq = channel.put(block, rows_n * chunk,
                                          policy.policy_version, ready,
                                          timer=timer, on_wait=on_wait)
                        del block, scratch
                        if not seq:
                            return
                        if ledger is not None:
                            puts.append([round(time.time(), 6),
                                         round(actor_wait_s[aid] - wait0, 6),
                                         rows_n * chunk,
                                         policy.policy_version, seq])
                        if hub is not None:
                            hub.beat(tname)
                    done = None
                    if on_card:
                        done = torch.cuda.Event()
                        done.record(stream)
                    if ledger is not None:
                        ledger.note_actor_episode({
                            "ep": ep, "actor": aid, "shard": shard,
                            "chunks": chunks, "puts": puts,
                            "adopts": adopts})
                    with results_lock:
                        results.append({"episode": ep, "actor": aid,
                                        "policy_version":
                                            policy.policy_version,
                                        "chunk_stats": chunk_stats,
                                        "ready": done})
                    supervisor.complete(aid, ep)
        except BaseException as e:   # supervised by the learner
            supervisor.report_failure(aid, ep, e)
            log.exception("actor %d died", aid)
        finally:
            if watcher is not None:
                watcher.stop()

    threads = [threading.Thread(target=actor_loop, args=(a,),
                                name=f"gsc-actor-{a}", daemon=True)
               for a in range(n_actors)]
    # one burst per B x episode_steps ingested steps, counted on this
    # rank's rows (every rank's share of each step)
    steps_per_burst = rows_n * episode_steps
    bursts = publishes = last_ckpt = 0
    blocks_quarantined = steps_quarantined = 0
    drained: List[Dict] = []
    # collected on this rank, not yet reported: episode -> record
    collected: Dict[int, Dict] = {}
    # episodes not yet reported, in global order (under a plan)
    unagreed = list(range(start_episode, episodes))
    stop_asked = [False]
    guard = None
    pending_verify = None   # (burst index, device flag) awaiting its read
    if rollback:
        guard = RollbackGuard(pddpg.draws)
        guard.init(start_episode - 1, state, buffers)
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    if hub is not None:
        def _idle_probe(slot, acc):
            def probe():
                wall = time.perf_counter() - t_start
                return acc[slot] / wall if wall > 0 else 0.0
            return probe
        for a in range(n_actors):
            hub.live_gauge("actor_idle_frac",
                           _idle_probe(a, actor_wait_s), actor=a)
        hub.live_gauge("learner_idle_frac",
                       _idle_probe(0, learner_idle_acc))
        hub.gauge("replay_ring_shards", n_shards)

    def wait_ready(ev):
        if ev is not None:
            learner_stream.wait_event(ev)

    def allowance(ingested: int) -> int:
        return int(ingested * cfg.learn_ratio // steps_per_burst)

    @contextlib.contextmanager
    def whole_state():
        """The full learner state for the block's duration (gathered from
        the plan's residency, a collective of the mp group, and sliced
        back after)."""
        if plan is not None:
            plan.gather_state(state)
        try:
            yield
        finally:
            if plan is not None:
                plan.place_state(state)

    def maybe_publish():
        nonlocal publishes
        if cfg.publish_bursts <= 0 or bursts % cfg.publish_bursts != 0:
            return
        from ..serve.fleet import host_leaves, leaves_finite

        # copies: on the CPU ``host_leaves`` shares the live parameters'
        # memory, which the next bursts update in place
        with pddpg.dispatch_lock, whole_state():
            leaves = [np.array(l, copy=True)
                      for l in host_leaves(state.actor)]
        if leaves_finite(leaves):
            publisher.publish(leaves, meta={"burst": bursts,
                                            "episodes": len(drained)},
                              verified=True)
            latest_pub[0] = (publisher.version, leaves)
            publishes += 1
            if ledger is not None:
                ledger.note_publish(time.time(), publisher.version)
        else:
            log.warning("non-finite actor parameters at burst %d: publish "
                        "skipped so a poisoned state never reaches the "
                        "actors", bursts)
            if hub is not None:
                hub.counter("async_publish_skipped_total")

    def do_rollback(episode, detail):
        nonlocal pending_verify
        tag, _, _ = guard.restore(state, buffers)
        pending_verify = None
        recover(episode, site="learner_state", action="rollback",
                fault="non_finite_state",
                detail=f"{detail}; restored last-verified snapshot "
                       f"(tag {tag})")
        if hub is not None:
            hub.counter("async_rollbacks_total")

    def verify_pending():
        """The last burst's ``state_finite`` flag, read one burst late:
        finite promotes the live state to the guard's snapshot, else the
        snapshot is restored and the run goes on."""
        nonlocal pending_verify
        if guard is None or pending_verify is None:
            return
        b_idx, flag = pending_verify
        pending_verify = None
        if float(flag) > 0.0:
            guard.promote(b_idx, state, buffers, pending_empty=True)
        else:
            do_rollback(len(drained),
                        f"learn-burst {b_idx} landed non-finite")

    def check_stop():
        if should_stop is not None and not stop_asked[0] and should_stop():
            stop_asked[0] = True
            stop_event.set()

    def collect():
        """Move every finished episode's record off the actors' queue
        (the learner's stream waits for its last chunk)."""
        while True:
            check_stop()
            with results_lock:
                if not results:
                    return
                rec = results.popleft()
            wait_ready(rec.pop("ready"))
            collected[rec["episode"]] = rec

    def chunk_records(eps: List[int]) -> Dict[int, List[Dict]]:
        """Each episode's per-chunk stats (``replica_stats`` of the
        chunk's [T, B] numbers): the process's own without a plan, every
        rank's gathered into global replica order under one (one gather
        for all of ``eps``, under ``dispatch_lock``)."""
        got = {k: torch.cat([c[k] for ep in eps
                             for c in collected[ep]["chunk_stats"]]).t()
               for k in "rse"}                    # [rows, eps x steps]
        if plan is not None:
            with pddpg.dispatch_lock:
                got = plan.gather_replica_rows(got, b_n)
        out = {}
        for i, ep in enumerate(eps):
            out[ep] = []
            for c in range(episode_steps // chunk):
                lo = i * episode_steps + c * chunk
                r, s_, e = (got[k][:, lo:lo + chunk].t().contiguous()
                            for k in "rse")
                out[ep].append(replica_stats(r, s_, e))
        return out

    def report(eps: List[int]):
        """Drain ``eps`` (collected on this rank; on every rank under a
        plan), in this order."""
        if not eps:
            return
        stats_of = chunk_records(eps)
        for ep in eps:
            snaps.pop(ep, None)
            rec = collected.pop(ep)
            rec.pop("chunk_stats")
            stats = stats_of[ep]
            rec["episodic_return"] = sum(float(s["episodic_return"])
                                         for s in stats)
            rec["mean_succ_ratio"] = (sum(float(s["mean_succ_ratio"])
                                          for s in stats) / len(stats))
            rec["final_succ_ratio"] = float(stats[-1]["final_succ_ratio"])
            rec["per_replica_return"] = sum(
                s["per_replica_return"] for s in stats).tolist()
            drained.append(rec)
            if on_episode is not None:
                on_episode(rec, buffers)

    def maybe_checkpoint():
        nonlocal last_ckpt
        if not (checkpoint_every and checkpoint_fn is not None
                and len(drained) - last_ckpt >= checkpoint_every):
            return
        last_ckpt = len(drained)
        with pddpg.dispatch_lock, whole_state():
            ring = (plan.gather_buffers(buffers, b_n) if plan is not None
                    else buffers)
            checkpoint_fn(state, ring, len(drained))

    actors_alive = lambda: any(t.is_alive() for t in threads)  # noqa: E731

    def spawn_actor(aid: int, suffix: str = ""):
        t = threading.Thread(target=actor_loop, args=(aid,),
                             name=f"gsc-actor-{aid}{suffix}", daemon=True)
        threads.append(t)
        t.start()

    def supervise():
        while True:
            fail = supervisor.pop_failure()
            if fail is None:
                return
            aid, at_ep, exc = fail
            if stop_event.is_set():
                supervisor.degrade(aid, exc)
                continue
            if supervisor.restarts[aid] < supervisor.restart_budget:
                n = supervisor.note_restart(aid)
                recover(at_ep, site="actor", action="restart",
                        fault=type(exc).__name__, attempt=n,
                        detail=f"actor {aid} died at episode {at_ep}; "
                               f"restarting from its episode counter "
                               f"({n}/{supervisor.restart_budget})")
                if hub is not None:
                    hub.counter("actor_restarts_total")
                spawn_actor(aid, suffix=f"-r{n}")
            else:
                alive = supervisor.degrade(aid, exc)
                detail = (f"actor {aid} exhausted its restart budget "
                          f"({supervisor.restart_budget}); fleet "
                          f"degrades to {alive} actor(s)")
                if cfg.max_staleness <= 0 and alive > 0:
                    new_cap = 2 * alive * rows_n * episode_steps
                    channel.set_max_outstanding(new_cap)
                    detail += f"; staleness cap re-derived to {new_cap}"
                recover(at_ep, site="actor", action="degrade",
                        fault=type(exc).__name__, detail=detail)
                if hub is not None:
                    hub.counter("actor_degraded_total")

    def fleet_done() -> bool:
        """True once every actor has exited with nothing produced left
        queued and no episode left unrun (or the run is stopping); an
        actor is respawned for orphaned episodes, and a fleet past its
        restart budget raises."""
        if actors_alive() or channel.outstanding():
            return False
        supervise()   # a failure queued just now may restart
        if actors_alive() or channel.outstanding():
            return False
        if supervisor.unrun() and not stop_event.is_set():
            cand = [a for a in range(n_actors) if a not in supervisor.dead]
            if cand:
                recover(len(drained), site="actor", action="restart",
                        fault=None,
                        detail=f"actor {cand[0]} respawned to drain "
                               f"{supervisor.unrun()} orphaned episode(s)")
                spawn_actor(cand[0], suffix="-orphans")
                return False
            raise RuntimeError(
                f"async fleet exhausted: every actor is past its restart "
                f"budget ({supervisor.restart_budget}) with "
                f"{supervisor.unrun()} episode(s) unrun"
            ) from supervisor.errors[-1]
        with results_lock:
            return not results

    def ingest_queued() -> bool:
        """Fold every queued block into the ring; True when any was
        popped."""
        nonlocal blocks_quarantined, steps_quarantined, ingest_collectives
        # pop everything queued first: popping releases the actors'
        # backpressure
        items = []
        item = channel.get_nowait()
        while item is not None:
            items.append(item)
            item = channel.get_nowait()
        for block, steps, version, seq, ready in items:
            wait_ready(ready)
            if on_card:
                for leaf in block.values():
                    leaf.record_stream(learner_stream)
            if guarded and float(all_finite(list(block.values()))) <= 0.0:
                # quarantine: the ring never holds a NaN; the pop
                # already counted the steps as ingested
                blocks_quarantined += 1
                steps_quarantined += int(steps)
                recover(len(drained), site="replay",
                        action="quarantine", fault="non_finite_block",
                        detail=f"seq={seq} shard={shard} steps={steps} "
                               f"version={version}")
                if hub is not None:
                    hub.counter("replay_quarantined_total")
                    hub.event("replay_quarantine", seq=int(seq),
                              shard=shard, steps=int(steps),
                              policy_version=int(version))
                check_stop()
                continue
            if hub is not None:
                hub.note_thread_phase("learner", "ingest")
            t_ing = time.time()
            before = collective_counts().get(learner_name, 0)
            with (timer.phase("replay_ingest") if timer
                  else contextlib.nullcontext()), pddpg.dispatch_lock:
                replay_ingest(buffers, block)
            ingest_collectives += (collective_counts().get(learner_name, 0)
                                   - before)
            lag = publisher.version - version
            policy_lags.append(lag)
            outstanding = channel.outstanding()
            if ledger is not None:
                ledger.note_ingest(t_ing, time.time(), steps, version,
                                   lag, seq)
            if hub is not None:
                hub.gauge("policy_lag", lag)
                hub.gauge("replay_lag", outstanding)
                hub.observe("policy_lag", lag)
                hub.observe("replay_lag", outstanding)
                hub.series("policy_lag", lag)
                hub.series("replay_lag", outstanding)
                if n_shards > 1:
                    # per-shard ingest heartbeat: a cold shard names its
                    # rank
                    hub.counter("replay_shard_ingest_total", shard=shard)
                    hub.gauge("replay_shard_ingest_seq", seq, shard=shard)
                    hub.beat(f"replay_shard{shard}")
                hub.beat("learner")
            check_stop()
        return bool(items)

    def learn() -> None:
        """One learn burst (its rollback bookkeeping, retry and
        hooks)."""
        nonlocal bursts, pending_verify
        verify_pending()
        b_idx = bursts
        if fault_plan is not None and fault_plan.fire(
                "nan_grads", b_idx) is not None:
            # burst-keyed: the state entering this burst; the deferred
            # flag catches it one burst later
            poison_tree(state.actor)
        if hub is not None:
            hub.note_thread_phase("learner", "learn_burst")
        t_burst = time.time()

        def dispatch_burst(b_idx=b_idx):
            if fault_plan is not None and fault_plan.fire(
                    "learner_transient", b_idx) is not None:
                raise TransientDispatchError(
                    f"injected transient at learn-burst {b_idx}")
            with (timer.phase("learn_dispatch") if timer
                  else contextlib.nullcontext()), pddpg.dispatch_lock, \
                    whole_state():
                return pddpg.learn_burst(state, buffers)

        if guarded:
            _, last_metrics = call_with_retry(
                dispatch_burst, retry_policy or RetryPolicy(),
                on_retry=lambda attempt, exc, delay: recover(
                    len(drained), site="learner", action="retry",
                    fault=type(exc).__name__, attempt=attempt,
                    detail=f"learn-burst {b_idx}: {exc} "
                           f"(backoff {delay:.2f}s)"))
        else:
            _, last_metrics = dispatch_burst()
        bursts += 1
        if guard is not None:
            flag = last_metrics.get("state_finite")
            if flag is not None:
                pending_verify = (b_idx, flag)
        if ledger is not None:
            ledger.note_burst(t_burst, time.time(), bursts)
        if hub is not None:
            hub.beat("learner")
        if cfg.throttle_s:
            time.sleep(cfg.throttle_s)
        if on_burst is not None:
            on_burst(bursts, state, last_metrics)

    def agree():
        """The pass's agreement across ranks: (the fewest steps any rank
        has ingested, whether any rank asked to stop, whether every
        rank's fleet is done, the episodes drained on every rank in
        global order); without a plan, this process's own."""
        done = fleet_done()
        window = unagreed[:AGREE_WINDOW]
        got = ([channel.ingested_steps, 0 if stop_asked[0] else 1,
                1 if done else 0]
               + [1 if ep in collected else 0 for ep in window])
        if mesh is not None:
            if hub is not None:
                # a learner waiting here waits for another rank
                hub.note_thread_phase("learner", "agree")
            got = mesh.agree_min(got)
        return (got[0], got[1] == 0, got[2] == 1,
                [ep for ep, ok in zip(window, got[3:]) if ok])

    def hand_out_snapshots():
        """Episodes up to the first one not drained + ``snap_lead`` get
        the scenario snapshot as it stands (every rank makes this call
        at the same point of the same pass, on equal numbers)."""
        first = unagreed[0] if unagreed else episodes
        upto = min(episodes, first + snap_lead)
        if scenario_snapshot is None or snap_next[0] >= upto:
            return
        snap = scenario_snapshot()
        with snap_cond:
            for ep in range(snap_next[0], upto):
                snaps[ep] = snap
            snap_next[0] = upto
            snap_cond.notify_all()

    def idle_wait():
        if hub is not None:
            hub.note_thread_phase("learner", "idle")
            hub.beat("learner")
        t0 = time.perf_counter()
        channel.wait_for_data(cfg.idle_wait_s)
        waited = time.perf_counter() - t0
        learner_idle_acc[0] += waited
        if timer is not None:
            timer.add("learner_idle", waited)

    # the first episodes' snapshots (the actors wait for theirs)
    hand_out_snapshots()
    try:
        while True:
            supervise()
            check_stop()
            progressed = ingest_queued()
            collect()
            # one agreement, then the pass's collectives in the order
            # every rank derives from it
            ingested, stop, all_done, agreed = agree()
            if stop:
                stop_event.set()
            if agreed:
                report(agreed)
                done_set = set(agreed)
                unagreed[:] = [ep for ep in unagreed if ep not in done_set]
                maybe_checkpoint()
            learned = bursts < allowance(ingested)
            if learned:
                learn()
                maybe_publish()
            hand_out_snapshots()
            # the exit reads agreed values only, so every rank leaves in
            # the same pass
            if all_done and not learned and not agreed:
                break
            if not (progressed or learned or agreed):
                idle_wait()
    finally:
        stop_event.set()
        with snap_cond:
            snap_cond.notify_all()
        channel.stop()
        for t in threads:
            t.join(timeout=30.0)
    # with rollback on, the returned state is always verified
    verify_pending()
    if plan is not None:
        # the whole learner state on every rank, as it entered
        plan.gather_state(state)
    if on_card:
        learner_stream.synchronize()
    wall = time.perf_counter() - t_start
    idle_s = learner_idle_acc[0]
    if timer is not None:
        idle_s = (timer.summary().get("learner_idle")
                  or {}).get("total_s", idle_s)
    lag_sorted = sorted(policy_lags)
    pct = lambda q: (lag_sorted[min(int(q * len(lag_sorted)),  # noqa: E731
                                    len(lag_sorted) - 1)]
                     if lag_sorted else 0)
    actor_fracs = [round(w / wall, 4) if wall > 0 else 0.0
                   for w in actor_wait_s]
    info = {
        "actors": n_actors,
        "episodes_drained": len(drained),
        "produced_steps": channel.produced_steps,
        "ingested_steps": channel.ingested_steps,
        "transitions_lost": channel.produced_steps - channel.ingested_steps,
        "bursts": bursts,
        "publishes": publishes,
        "published_version": publisher.version,
        "max_staleness": max_stale,
        "max_replay_lag": channel.max_observed_lag,
        "policy_lag_max": max(policy_lags) if policy_lags else 0,
        "policy_lag_mean": (round(float(np.mean(policy_lags)), 4)
                            if policy_lags else 0.0),
        "policy_lag_p50": pct(0.50),
        "policy_lag_p99": pct(0.99),
        "wall_s": round(wall, 4),
        "learner_idle_s": round(idle_s, 4),
        "learner_idle_frac": round(idle_s / wall, 4) if wall > 0 else 0.0,
        "actor_idle_fracs": actor_fracs,
        "actor_idle_frac": max(actor_fracs) if actor_fracs else 0.0,
        "actor_restarts": supervisor.total_restarts(),
        "actors_degraded": len(supervisor.dead),
        "blocks_quarantined": blocks_quarantined,
        "steps_quarantined": steps_quarantined,
        "rollbacks": guard.rollbacks if guard is not None else 0,
        "ring_shards": n_shards,
        "mesh": plan.describe() if plan is not None else None,
        # collectives issued from the actor threads and by the ingests:
        # 0 by design (parallel.mesh raises on the first from an actor)
        "actor_collectives": sum(
            n - counts0.get(k, 0) for k, n in collective_counts().items()
            if k.startswith("gsc-actor-")),
        "ingest_collectives": ingest_collectives,
    }
    if hub is not None:
        hub.drop_live_gauge("learner_idle_frac")
        hub.gauge("learner_idle_frac", info["learner_idle_frac"])
        hub.series("learner_idle_frac", info["learner_idle_frac"])
        for a, frac in enumerate(actor_fracs):
            hub.drop_live_gauge("actor_idle_frac", actor=a)
            hub.gauge("actor_idle_frac", frac, actor=a)
            hub.series("actor_idle_frac", frac, actor=a)
        hub.gauge("actor_policy_version", publisher.version)
        hub.gauge("replay_ring_bytes", buffer_nbytes(buffers))
        if ledger is not None:
            ledger.flush_deferred(hub)
    return AsyncResult(state=state, buffers=buffers, episodes=drained,
                       info=info)
