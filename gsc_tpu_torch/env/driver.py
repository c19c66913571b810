"""Episode driver: one built-in network and per-episode host traffic.

The port of the part of ``gsc_tpu.env.driver.EpisodeDriver`` that
replica-parallel training on one network needs: ``traffic_for`` samples
one ``TrafficSchedule`` from a seed on the host with the port's numpy traffic
path (byte-equal to the JAX package's) at a capacity fixed for the run,
and ``replica_traffic`` stacks one schedule per replica with seed
``base_seed + 1000 * episode + r``, the JAX trainer's host-traffic seeds
(``train_parallel`` with ``device_traffic=False``).  The topology
schedule, GraphML reading and traffic sampled on the device are not
ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch

from ..config.schema import ServiceConfig, SimConfig
from ..sim.state import TrafficSchedule
from ..sim.traffic import generate_traffic, traffic_capacity
from ..topology.compiler import Topology


class EpisodeDriver:
    """One network and its traffic per episode."""

    def __init__(self, topology: Topology, sim_cfg: SimConfig,
                 service: ServiceConfig, episode_steps: int,
                 base_seed: int = 0):
        self.topology = topology
        self.sim_cfg = sim_cfg
        self.service = service
        self.episode_steps = episode_steps
        self.base_seed = base_seed
        self.capacity = traffic_capacity(
            sim_cfg, int(topology.is_ingress.sum()), episode_steps)

    def traffic_for(self, seed: int) -> TrafficSchedule:
        """One episode's traffic drawn with ``seed``."""
        return generate_traffic(self.sim_cfg, self.service, self.topology,
                                self.episode_steps, seed,
                                capacity=self.capacity)

    def replica_traffic(self, episode: int, replicas: int
                        ) -> TrafficSchedule:
        """[B]-stacked traffic, replica r seeded ``base_seed + 1000 *
        episode + r``."""
        per = [self.traffic_for(self.base_seed + 1000 * episode + r)
               for r in range(replicas)]
        return TrafficSchedule(**{f: torch.stack([getattr(t, f) for t in per])
                                  for f in TrafficSchedule._RANKS})
