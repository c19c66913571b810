"""Actor and critic networks (graph mode, monolithic heads).

The port of ``gsc_tpu.models.nets.Actor`` and ``QNetwork`` with the
monolithic heads: GNN embedding of the padded network graph, concatenated
with the flattened action mask (and, for the critic, the action), through
an MLP (Linear -> ReLU between layers, plain last layer).  The actor's
output is multiplied by the mask so padded (src, dst) entries are exactly
zero; the critic returns Q [..., 1].  The factored heads are not ported
yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..config.schema import AgentConfig
from ..env.observations import GraphObs
from .gnn import GNNEmbedder
from .init import lecun_normal_

# action dims at or above which the JAX package switches to its factored
# head; the port carries the monolithic head only
FACTORED_HEAD_THRESHOLD = 16384


class MLP(nn.Module):
    """Linear/ReLU stack with a plain last layer."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        dims = [in_features, *features]
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, dims[i], dims[i + 1])
            for i in range(len(features)))

    def reset_parameters(self, generator: torch.Generator):
        for lin in self.layers:
            lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def _check_monolithic(agent: AgentConfig, action_dim: int):
    if agent.factored_head or (agent.factored_head is None
                               and action_dim >= FACTORED_HEAD_THRESHOLD):
        raise ValueError(
            f"action dim {action_dim} needs the factored head, which the "
            "port does not carry yet")


def _embedder(agent: AgentConfig, gnn_impl: str) -> GNNEmbedder:
    return GNNEmbedder(
        in_features=len(agent.observation_space), hidden=agent.gnn_features,
        num_layers=agent.gnn_num_layers, num_iter=agent.gnn_num_iter,
        mean_aggr=agent.gnn_aggr == "mean", impl=gnn_impl)


class Actor(nn.Module):
    """Policy network: embedding ++ mask -> MLP -> action_dim, masked."""

    def __init__(self, agent: AgentConfig, action_dim: int,
                 gnn_impl: str = "dense"):
        super().__init__()
        _check_monolithic(agent, action_dim)
        self.action_dim = action_dim
        self.gnn_impl = gnn_impl
        self.embedder = _embedder(agent, gnn_impl)
        self.mlp = MLP(agent.gnn_features + action_dim,
                       tuple(agent.actor_hidden_layer_nodes) + (action_dim,))

    def reset_parameters(self, generator: torch.Generator):
        self.embedder.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, obs: GraphObs) -> torch.Tensor:
        emb = self.embedder(obs.nodes, obs.edge_index, obs.edge_mask,
                            obs.node_mask)
        h = torch.cat([emb, obs.mask.to(emb.dtype)], dim=-1)
        return self.mlp(h) * obs.mask


class QNetwork(nn.Module):
    """Critic Q(s, a): embedding ++ mask ++ action -> MLP -> [..., 1]."""

    def __init__(self, agent: AgentConfig, action_dim: int,
                 gnn_impl: str = "dense"):
        super().__init__()
        _check_monolithic(agent, action_dim)
        self.action_dim = action_dim
        self.gnn_impl = gnn_impl
        self.embedder = _embedder(agent, gnn_impl)
        self.mlp = MLP(agent.gnn_features + 2 * action_dim,
                       tuple(agent.critic_hidden_layer_nodes) + (1,))

    def reset_parameters(self, generator: torch.Generator):
        self.embedder.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, obs: GraphObs, action: torch.Tensor) -> torch.Tensor:
        emb = self.embedder(obs.nodes, obs.edge_index, obs.edge_mask,
                            obs.node_mask)
        h = torch.cat([emb, obs.mask.to(emb.dtype), action.to(emb.dtype)],
                      dim=-1)
        return self.mlp(h)


def scale_action(action: torch.Tensor, low: float = 0.0,
                 high: float = 1.0) -> torch.Tensor:
    """[low, high] -> [-1, 1]."""
    return 2.0 * (action - low) / (high - low) - 1.0


def unscale_action(scaled: torch.Tensor, low: float = 0.0,
                   high: float = 1.0) -> torch.Tensor:
    """[-1, 1] -> [low, high]."""
    return low + 0.5 * (scaled + 1.0) * (high - low)
