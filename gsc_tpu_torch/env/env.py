"""The RL environment: reset/step over the batched simulator.

The port of ``gsc_tpu.env.env.ServiceCoordEnv``.  ``EnvState`` carries a
leading [B] dim of env replicas; ``topo`` and ``traffic`` are shared by
every replica or carry the same [B].  With ``SimConfig.prediction`` the
observations show the upcoming interval's ingress traffic
(``sim.predictor.predict_ingress_traffic``) in place of the last one's;
``engine`` replaces the simulator (``sim.dummy.DummyEngine``).  The
observation is a ``GraphObs`` in graph mode and the flat [B, N*F] vector
(``obs_dim``) with ``AgentConfig.graph_mode`` false, under either
controller: with ``controller: per_flow`` the engine's intervals expire
idle instances (kernel #2's ``gc`` switch) in both modes, as the JAX
engine does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..config.schema import AgentConfig, EnvLimits, ServiceConfig, SimConfig
from ..sim.engine import SimEngine
from ..sim.state import SimState, TrafficSchedule
from ..topology.compiler import Topology
from ..utils.tree import TensorTree
from .actions import action_to_schedule, derive_placement, post_process_action
from .observations import flat_obs, graph_obs
from .rewards import compute_reward, reward_constants


@dataclass
class EnvState(TensorTree):
    """Per-replica environment state, leading dim [B]."""

    sim: SimState
    step: torch.Tensor        # [B] i32 steps taken this episode
    ewma_flows: torch.Tensor  # [B] f32 EWMA of flow success


class ServiceCoordEnv:
    """``reset(topo, traffic, batch)`` -> (EnvState, obs)
    ``step(state, topo, traffic, action)`` -> (EnvState, obs, reward, done, info)

    ``action`` is the flat [B, A] scheduling tensor in [0, 1] after
    agent-side post-processing (``process_action``)."""

    def __init__(self, service: ServiceConfig, sim_cfg: SimConfig,
                 agent: AgentConfig, limits: EnvLimits,
                 engine: Optional[SimEngine] = None):
        self.service = service
        self.sim_cfg = sim_cfg
        self.agent = agent
        self.limits = limits
        self.engine = engine if engine is not None else SimEngine(
            service, sim_cfg, limits)
        self.tables = self.engine.tables
        self.min_delay, self.diameter = reward_constants(
            agent, [service.sf_list[n].processing_delay_mean
                    for n in service.sf_names])

    def process_action(self, action: torch.Tensor) -> torch.Tensor:
        """Agent-side action post-processing (threshold + renormalise)."""
        return post_process_action(action, self.limits.max_nodes,
                                   self.agent.schedule_threshold)

    def _masked_schedule(self, action: torch.Tensor,
                         topo: Topology) -> torch.Tensor:
        """Flat action -> [B, N, C, S, N] schedule with padded src/dst
        entries zeroed, so WRR never picks a padded destination."""
        sched = action_to_schedule(action, self.limits.scheduling_shape)
        m = topo.node_mask.to(sched.dtype)
        return sched * m[..., :, None, None, None] * m[..., None, None, None, :]

    def _obs(self, state: SimState, topo: Topology,
             traffic: TrafficSchedule):
        b = state.batch
        topo = topo.expand(b)
        node_cap = traffic.expand(b).node_cap
        idx = state.run_idx.clamp(0, node_cap.shape[1] - 1).long()
        cap_now = node_cap[torch.arange(b, device=idx.device), idx]
        override = None
        if self.sim_cfg.prediction:
            from ..sim.predictor import predict_ingress_traffic
            override = predict_ingress_traffic(
                traffic, state.run_idx, self.sim_cfg.run_duration,
                self.limits.max_nodes)
        if self.agent.graph_mode:
            return graph_obs(state.metrics, topo, cap_now,
                             self.tables.chain_sf,
                             self.agent.observation_space,
                             self.limits.num_sfcs, self.limits.max_sfs,
                             ingress_override=override)
        return flat_obs(state.metrics, topo, cap_now, self.tables.chain_sf,
                        self.agent.observation_space,
                        ingress_override=override)

    def obs_dim(self) -> int:
        """Length of the flat observation: one padded node vector per
        observation component."""
        return self.limits.max_nodes * len(self.agent.observation_space)

    def reset(self, topo: Topology, traffic: TrafficSchedule,
              batch: int = 1):
        """New episode: fresh simulator state and the observation of the
        empty network."""
        dev = topo.node_cap.device
        sim = self.engine.init(batch, dev)
        state = EnvState(sim=sim,
                         step=torch.zeros(batch, dtype=torch.int32, device=dev),
                         ewma_flows=torch.ones(batch, device=dev))
        return state, self._obs(sim, topo, traffic)

    def step(self, state: EnvState, topo: Topology, traffic: TrafficSchedule,
             action: torch.Tensor, noise: Optional[torch.Tensor] = None):
        b = state.sim.batch
        topo_b = topo.expand(b)
        active_rows = traffic.expand(b).ingress_active
        schedule = self._masked_schedule(action, topo_b)
        run = state.sim.run_idx.clamp(0, active_rows.shape[1] - 1).long()
        active_ing = (topo_b.is_ingress & topo_b.node_mask
                      & active_rows[torch.arange(b, device=run.device), run])
        placement = derive_placement(
            schedule, self.tables.chain_sf, self.tables.chain_len,
            active_ing, self.limits.sf_pool)
        sim, metrics = self.engine.apply(state.sim, topo, traffic, schedule,
                                         placement, noise)
        reward, ewma, info = compute_reward(
            self.agent, metrics, placement, topo_b.node_mask,
            self.limits.sf_pool, self.min_delay, self.diameter,
            state.ewma_flows)
        step = state.step + 1
        done = step >= self.agent.episode_steps
        info["run_generated"] = metrics.run_generated
        info["run_processed"] = metrics.run_processed
        info["run_dropped"] = metrics.run_dropped
        info["placement"] = placement
        info["schedule"] = schedule
        state = EnvState(sim=sim, step=step, ewma_flows=ewma)
        return state, self._obs(sim, topo, traffic), reward, done, info
