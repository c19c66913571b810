"""Episode driver: the topology schedule and per-episode host traffic.

The port of ``gsc_tpu.env.driver.EpisodeDriver`` without mixed-topology
batches, the scenario factory, traces and the prefetcher.  The training
networks of a ``SchedulerConfig`` (GraphML files, or topologies given
directly) switch every ``period`` episodes in turn, and test mode always
takes the inference network (``topology_for``).  Each topology carries its
schedule position as ``topo_id``, which the replay records.  Traffic is
sampled on the host with the port's numpy traffic path (byte-equal to the
JAX package's) at one capacity for every network of the run:
``traffic_for`` seeds episode ``ep`` with ``base_seed + ep`` (the
single-env trainer's seeds), ``replica_traffic`` replica ``r`` with
``base_seed + 1000 * ep + r`` (the JAX replica trainer's host-traffic
seeds, ``train_parallel`` with ``device_traffic=False``).
``EpisodeDriver.single`` makes a one-network schedule, whose training and
inference network are the same.  A simulator config's ``force_link_cap`` /
``force_node_cap`` apply where a GraphML network is read, as in the JAX
package; a built-in network refuses them (``refuse_force_caps``).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch

from ..config.schema import SchedulerConfig, ServiceConfig, SimConfig
from ..sim.state import TrafficSchedule
from ..sim.traffic import generate_traffic, traffic_capacity
from ..topology.compiler import (Topology, check_dt_quantization,
                                 load_topology_cached)


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
                 inference_topology: Optional[Topology] = None):
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
        # one traffic capacity for every network of the run
        max_ing = max(int(t.is_ingress.sum()) for t in
                      self.topologies + [self.inference_topology])
        self.capacity = traffic_capacity(sim_cfg, max_ing, episode_steps)

    @classmethod
    def single(cls, topology: Topology, sim_cfg: SimConfig,
               service: ServiceConfig, episode_steps: int, name: str,
               base_seed: int = 0) -> "EpisodeDriver":
        """A schedule of one built-in network ``name``, trained and
        inferred on; refuses forced capacities."""
        refuse_force_caps(sim_cfg, name)
        sched = SchedulerConfig(training_network_files=(name,),
                                inference_network=name)
        return cls(sched, sim_cfg, service, episode_steps,
                   max_nodes=topology.max_nodes, max_edges=topology.max_edges,
                   base_seed=base_seed, topologies=[topology],
                   inference_topology=topology)

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
                                self.episode_steps, seed,
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
        per = [self.traffic_for(episode, topo,
                                seed=self.base_seed + 1000 * episode + r)
               for r in range(replicas)]
        return TrafficSchedule(**{f: torch.stack([getattr(t, f) for t in per])
                                  for f in TrafficSchedule._RANKS})
