"""Episode driver: the topology schedule, mixed batches and per-episode
host traffic.

The port of ``gsc_tpu.env.driver.EpisodeDriver`` (with its
``EpisodePrefetcher``).  The training
networks of a ``SchedulerConfig`` (GraphML files, or topologies given
directly) switch every ``period`` episodes in turn, and test mode always
takes the inference network (``topology_for``).  Each topology carries its
schedule position as ``topo_id``, which the replay records.  Traffic is
sampled on the host with the port's numpy traffic path (byte-equal to the
JAX package's), following the simulator config's trace (``trace_path``)
where it names one, at one capacity for every network of the run:
``traffic_for`` seeds episode ``ep`` with ``base_seed + ep`` (the
single-env trainer's seeds), ``replica_traffic`` replica ``r`` with
``base_seed + 1000 * ep + r`` (the JAX replica trainer's host-traffic
seeds, ``train_parallel`` with ``device_traffic=False``).

``topo_mix`` (``topology.scenarios``) fills the replica axis with a
mixture instead: a registry mix becomes mix entries and a round-robin
``MixPlan`` per replica count (``mix_plan``, memoized per B, with
``mix_traffic`` its host traffic), a ``factory:`` mix a ``FactorySpec``
whose ``ScenarioFactory`` is built on first use (``factory_on(device)``).
``num_topo_ids`` / ``topo_id_names`` name the learn ledger's segments:
the mix entries, the factory's families, else the schedule.
``EpisodeDriver.single`` makes a one-network schedule, whose training and
inference network are the same.  A simulator config's ``force_link_cap`` /
``force_node_cap`` apply where a GraphML network is read, as in the JAX
package; a built-in network refuses them (``refuse_force_caps``).

``EpisodeDriver.prefetcher`` samples episodes ahead of the training loop
on a daemon thread (:class:`EpisodePrefetcher`).  The thread builds host
data only (CPU tensors from numpy): it never draws from the trainer's
random source and never copies to the card, so the main thread moves
each episode to the device on the stream its kernels use, and the
sequence equals serial ``episode`` calls (traffic is seeded by the
episode index alone).
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Callable, List, Optional, Sequence

import torch

from ..config.schema import SchedulerConfig, ServiceConfig, SimConfig
from ..sim.state import TrafficSchedule, stack_traffic
from ..sim.traffic import TraceEvents, generate_traffic, traffic_capacity
from ..topology import scenarios
from ..topology.compiler import (Topology, TopologyBucket,
                                 check_dt_quantization,
                                 load_topology_cached)
from ..topology.factory import is_factory_mix, parse_factory


def _node_index(name: str) -> int:
    """A trace's node column -> node index ('popN' or a bare integer)."""
    s = str(name)
    return int(s[3:]) if s.startswith("pop") else int(s)


def refuse_force_caps(sim_cfg: SimConfig, network: str) -> None:
    """Raise ValueError when ``sim_cfg`` forces capacities: they apply to
    GraphML networks only, and the built-in ``network`` would silently
    keep its own."""
    if sim_cfg.force_link_cap is not None \
            or sim_cfg.force_node_cap is not None:
        raise ValueError(
            f"force_link_cap={sim_cfg.force_link_cap}, force_node_cap="
            f"{sim_cfg.force_node_cap}: forced capacities apply to GraphML "
            f"networks (a scheduler yaml's), not to the built-in network "
            f"{network!r}")


class EpisodeDriver:
    """The (topology, traffic) of every episode, following the schedule."""

    def __init__(self, scheduler: SchedulerConfig, sim_cfg: SimConfig,
                 service: ServiceConfig, episode_steps: int,
                 max_nodes: int = 24, max_edges: int = 37,
                 base_seed: int = 0,
                 topologies: Optional[Sequence[Topology]] = None,
                 inference_topology: Optional[Topology] = None,
                 topo_mix: Optional[str] = None,
                 registry: Optional[scenarios.ScenarioRegistry] = None):
        self.scheduler = scheduler
        self.sim_cfg = sim_cfg
        self.service = service
        self.episode_steps = episode_steps
        self.base_seed = base_seed
        caps = dict(force_link_cap=sim_cfg.force_link_cap,
                    force_node_cap=sim_cfg.force_node_cap, seed=base_seed)
        if topologies is None:
            topologies = [
                load_topology_cached(p, max_nodes=max_nodes,
                                     max_edges=max_edges, topo_id=i, **caps)
                for i, p in enumerate(scheduler.training_network_files)]
        self.topologies: List[Topology] = [
            t if int(t.topo_id) == i
            else t.replace(topo_id=torch.tensor(i, dtype=torch.int32))
            for i, t in enumerate(topologies)]
        if inference_topology is None:
            inference_topology = load_topology_cached(
                scheduler.inference_network, max_nodes=max_nodes,
                max_edges=max_edges, **caps)
        self.inference_topology = inference_topology
        for i, t in enumerate(self.topologies + [self.inference_topology]):
            check_dt_quantization(t, sim_cfg.dt, name=f"topology[{i}]")
        self.trace = (TraceEvents.from_csv(sim_cfg.trace_path, _node_index)
                      if sim_cfg.trace_path else None)
        # one traffic capacity for every network of the run
        max_ing = max(int(t.is_ingress.sum()) for t in
                      self.topologies + [self.inference_topology])
        self.capacity = traffic_capacity(sim_cfg, max_ing, episode_steps)
        # mixed batches: registry entries compiled into one bucket now, a
        # factory spec parsed now and its sampler built on first use
        self.topo_mix = topo_mix
        self.registry = registry or scenarios.DEFAULT_REGISTRY
        self.bucket = TopologyBucket(self.topologies[0].max_nodes,
                                     self.topologies[0].max_edges)
        self._mix_entries = None
        self._mix_plans = {}
        self.factory_spec = None
        self._factories = {}
        if topo_mix and is_factory_mix(topo_mix):
            self.factory_spec = parse_factory(topo_mix)
        elif topo_mix:
            self._mix_entries = scenarios.build_mix_entries(
                topo_mix, self.registry, self.bucket,
                schedule_topos=self.topologies,
                schedule_names=self._schedule_names(), dt=sim_cfg.dt)

    @classmethod
    def single(cls, topology: Topology, sim_cfg: SimConfig,
               service: ServiceConfig, episode_steps: int, name: str,
               base_seed: int = 0,
               topo_mix: Optional[str] = None) -> "EpisodeDriver":
        """A schedule of one built-in network ``name``, trained and
        inferred on; refuses forced capacities."""
        refuse_force_caps(sim_cfg, name)
        sched = SchedulerConfig(training_network_files=(name,),
                                inference_network=name)
        return cls(sched, sim_cfg, service, episode_steps,
                   max_nodes=topology.max_nodes, max_edges=topology.max_edges,
                   base_seed=base_seed, topologies=[topology],
                   inference_topology=topology, topo_mix=topo_mix)

    # ------------------------------------------------------------ mix mode
    def factory_on(self, device):
        """The ``ScenarioFactory`` of a ``factory:`` mix on ``device``
        (built once per device); None without one."""
        if self.factory_spec is None:
            return None
        key = str(device)
        if key not in self._factories:
            from ..topology.factory import ScenarioFactory
            self._factories[key] = ScenarioFactory(
                self.factory_spec, self.sim_cfg, self.service,
                self.episode_steps, max_nodes=self.bucket.max_nodes,
                max_edges=self.bucket.max_edges, device=device)
        return self._factories[key]

    @property
    def scenario_factory(self):
        """The factory on the CPU (``factory_on`` for another device)."""
        return self.factory_on("cpu")

    def mix_plan(self, num_replicas: int) -> scenarios.MixPlan:
        """The round-robin ``MixPlan`` of ``num_replicas`` (memoized: the
        stacked topology is the same object every episode)."""
        if not self.topo_mix:
            raise ValueError("driver has no topo_mix configured")
        if self.factory_spec is not None:
            raise ValueError(
                "a factory mix samples scenarios on device per episode — "
                "no host MixPlan exists (use driver.scenario_factory)")
        plan = self._mix_plans.get(num_replicas)
        if plan is None:
            plan = self._mix_plans[num_replicas] = scenarios.plan_mix(
                self._mix_entries, num_replicas, self.bucket, self.sim_cfg,
                self.episode_steps)
        return plan

    def mix_traffic(self, episode: int,
                    plan: scenarios.MixPlan) -> TrafficSchedule:
        """[B]-stacked host traffic of one mixed episode, replica r seeded
        ``base_seed + 1000 * episode + r``."""
        return scenarios.mix_traffic_host(
            plan, self.sim_cfg, self.service, self.episode_steps,
            seed_for=lambda r: self.base_seed + 1000 * episode + r,
            default_trace=self.trace)

    def topology_for(self, episode: int, test_mode: bool = False) -> Topology:
        """Switch every ``period`` episodes, cycling the training list;
        the inference network in test mode."""
        if test_mode:
            return self.inference_topology
        index = (episode // self.scheduler.period) % len(self.topologies)
        return self.topologies[index]

    def _schedule_names(self) -> List[str]:
        """Schedule position -> file basename (positional names for a
        driver built from a topology list of another length)."""
        files = list(self.scheduler.training_network_files or [])
        if len(files) == len(self.topologies):
            return [os.path.basename(p) for p in files]
        return [f"topology{i}" for i in range(len(self.topologies))]

    def topology_name_for(self, episode: int, test_mode: bool = False) -> str:
        """The name of the network ``topology_for`` picks."""
        if test_mode:
            return os.path.basename(self.scheduler.inference_network or
                                    "inference")
        index = (episode // self.scheduler.period) % len(self.topologies)
        return self._schedule_names()[index]

    def traffic_for(self, episode: int, topo: Topology,
                    seed: Optional[int] = None) -> TrafficSchedule:
        """Episode ``episode``'s traffic on ``topo``, seeded ``base_seed +
        episode`` unless ``seed`` is given."""
        seed = self.base_seed + episode if seed is None else seed
        return generate_traffic(self.sim_cfg, self.service, topo,
                                self.episode_steps, seed, trace=self.trace,
                                capacity=self.capacity)

    def episode(self, episode: int, test_mode: bool = False,
                seed: Optional[int] = None):
        """(topology, traffic) of one episode, on the host."""
        topo = self.topology_for(episode, test_mode)
        return topo, self.traffic_for(episode, topo, seed)

    def replica_traffic(self, episode: int, replicas: int
                        ) -> TrafficSchedule:
        """[B]-stacked traffic on episode ``episode``'s network, replica r
        seeded ``base_seed + 1000 * episode + r``."""
        topo = self.topology_for(episode)
        return stack_traffic([
            self.traffic_for(episode, topo,
                             seed=self.base_seed + 1000 * episode + r)
            for r in range(replicas)])

    @property
    def num_topo_ids(self) -> int:
        """How many ``topo_id`` values the episodes stamp into the replay
        (the learn ledger's segment axis): the factory's families, the
        mix entries, else the schedule's length."""
        if self.factory_spec is not None:
            return self.factory_spec.num_families
        if self._mix_entries is not None:
            return len(self._mix_entries)
        return len(self.topologies)

    @property
    def topo_id_names(self) -> List[str]:
        """``topo_id`` -> name, aligned with :attr:`num_topo_ids`."""
        if self.factory_spec is not None:
            return list(self.factory_spec.families)
        if self._mix_entries is not None:
            return [e.name for e in self._mix_entries]
        return self._schedule_names()

    def prefetcher(self, start: int, stop: int, test_mode: bool = False,
                   depth: int = 2, heartbeat: Optional[Callable] = None,
                   before_episode: Optional[Callable] = None
                   ) -> "EpisodePrefetcher":
        """A background double buffer over :meth:`episode` for episodes
        ``start..stop-1``.  ``heartbeat`` runs in the producer after every
        staged episode; ``before_episode(ep, stop_event)`` before each
        episode's sampling (the fault-injection hook)."""
        return EpisodePrefetcher(self, start, stop, test_mode=test_mode,
                                 depth=depth, heartbeat=heartbeat,
                                 before_episode=before_episode)


class PrefetchInterrupted(RuntimeError):
    """The prefetcher was interrupted on purpose (watchdog escalation):
    the consumer restarts it from its episode counter."""


class EpisodePrefetcher:
    """A daemon thread runs the driver's per-episode sampling ``depth``
    episodes ahead of the training loop, through a bounded queue; the
    sequence equals serial ``driver.episode(ep, test_mode)`` calls, with
    the driver's own topology objects."""

    _DONE = "done"
    _ERROR = "error"

    def __init__(self, driver: EpisodeDriver, start: int, stop: int,
                 test_mode: bool = False, depth: int = 2,
                 heartbeat: Optional[Callable] = None,
                 before_episode: Optional[Callable] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.driver = driver
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop_flag = threading.Event()
        self._interrupted: Optional[str] = None
        self._args = (start, stop, test_mode, heartbeat, before_episode)
        self._thread = threading.Thread(
            target=self._produce, name="gsc-episode-prefetch", daemon=True)
        self._thread.start()

    @property
    def queue_depth(self) -> int:
        """Episodes currently staged (approximate)."""
        return self._queue.qsize()

    def is_alive(self) -> bool:
        """Producer-thread liveness (a watchdog probe)."""
        return self._thread.is_alive()

    def _produce(self):
        start, stop, test_mode, heartbeat, before_episode = self._args
        try:
            for ep in range(start, stop):
                if before_episode is not None:
                    # gets the stop flag, so an injected slow stage ends
                    # the moment close() abandons this producer
                    before_episode(ep, self._stop_flag)
                if self._stop_flag.is_set():
                    return
                item = self.driver.episode(ep, test_mode)
                if heartbeat is not None:
                    heartbeat()
                # bounded put, polled so close() can abandon a full queue
                while not self._stop_flag.is_set():
                    try:
                        self._queue.put((ep, item), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop_flag.is_set():
                    return
        except BaseException as e:  # surfaced on the consumer's next get()
            self._queue.put((self._ERROR, e))
        else:
            self._queue.put((self._DONE, None))

    def interrupt(self, reason: str):
        """Fail the consumer's next (or currently blocked) ``get`` with a
        :class:`PrefetchInterrupted` (the watchdog's escalation, from the
        watchdog thread); ``close()`` stops the producer."""
        self._interrupted = reason
        try:   # wakes a consumer blocked on an empty queue
            self._queue.put_nowait((self._ERROR,
                                    PrefetchInterrupted(reason)))
        except queue.Full:
            pass

    def get(self, episode: int):
        """(topo, traffic) of ``episode``, on the host; episodes are
        consumed in order."""
        if self._interrupted is not None:
            raise PrefetchInterrupted(self._interrupted)
        tag, item = self._queue.get()
        if tag == self._ERROR:
            if isinstance(item, PrefetchInterrupted):
                raise item
            raise RuntimeError("episode prefetch thread failed") from item
        if tag == self._DONE:
            raise RuntimeError(
                f"prefetcher exhausted before episode {episode}")
        if tag != episode:
            raise RuntimeError(
                f"out-of-order prefetch consumption: asked for episode "
                f"{episode}, next staged is {tag}")
        return item

    def close(self):
        """Stop the producer; safe at any point."""
        self._stop_flag.set()
        try:
            while True:  # unblock a producer waiting on a full queue
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
