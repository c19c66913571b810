"""DDPG agent: the actor and the greedy inference policy.

The port of the serving part of ``gsc_tpu.agents.ddpg.DDPG``: building and
initialising the actor (from an explicit ``torch.Generator``) and
``greedy_action`` (actor forward, clamp to [0, 1], then the env's
threshold + renormalise post-processing).  The critic, replay and the
learn burst are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config.schema import AgentConfig
from ..device import resolve_device
from ..env.env import ServiceCoordEnv
from ..env.observations import GraphObs
from ..models.nets import Actor


class DDPG:
    def __init__(self, env: ServiceCoordEnv, agent: AgentConfig,
                 gnn_impl: Optional[str] = None, device=None):
        self.env = env
        self.agent = agent
        self.device = resolve_device(device)
        self.action_dim = env.limits.action_dim
        self.actor = Actor(agent, self.action_dim,
                           gnn_impl=gnn_impl or agent.gnn_impl)

    def init(self, generator: torch.Generator) -> Actor:
        """Draw the actor's parameters from ``generator`` (on the CPU, so a
        seed gives the same weights on every device) and move the actor to
        the agent's device."""
        self.actor.reset_parameters(generator)
        self.actor.to(self.device)
        return self.actor

    @torch.inference_mode()
    def greedy_action(self, obs: GraphObs) -> torch.Tensor:
        """The greedy policy: [..., A] actions for a (batched) observation."""
        a = self.actor(obs)
        a = torch.clamp(a, 0.0, 1.0)
        return self.env.process_action(a)
