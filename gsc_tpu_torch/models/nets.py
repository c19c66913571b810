"""Actor and critic networks (graph mode, monolithic heads).

The port of ``gsc_tpu.models.nets.Actor`` and ``QNetwork`` with the
monolithic heads: GNN embedding of the padded network graph, concatenated
with the flattened action mask (and, for the critic, the action), through
an MLP (Linear -> ReLU between layers, plain last layer).  The actor's
output is multiplied by the mask so padded (src, dst) entries are exactly
zero; the critic returns Q [..., 1].  The factored heads are not ported
yet.

Mixed precision (``AgentConfig.precision``): the embedder computes in the
policy's ``gnn_dtype`` and the MLPs in its ``mlp_dtype``, with parameters
kept as f32 masters; both networks' outputs (actions, Q-values) leave in
f32.  The "f32" policy runs the f32 code verbatim.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import AgentConfig
from ..env.observations import GraphObs
from ..ops.gat import compute_dtype_of
from .gnn import GNNEmbedder
from .init import lecun_normal_

# action dims at or above which the JAX package switches to its factored
# head; the port carries the monolithic head only
FACTORED_HEAD_THRESHOLD = 16384


class MLP(nn.Module):
    """Linear/ReLU stack with a plain last layer.  ``dtype`` is the
    compute dtype (``PrecisionPolicy.mlp_dtype``; None = f32 verbatim).  A
    low-precision layer computes as flax's ``nn.Dense(dtype=...)`` with
    the JAX package's f32-accumulating ``dot_general``: input and weight
    rounded to the dtype and multiplied in f32 (each product exact, the
    sum f32), the product rounded to the dtype, then the bias rounded to
    the dtype added in it (a second rounding), ReLU in the dtype."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype: Optional[str] = None):
        super().__init__()
        self.dtype = compute_dtype_of(dtype)
        dims = [in_features, *features]
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, dims[i], dims[i + 1])
            for i in range(len(features)))

    def reset_parameters(self, generator: torch.Generator):
        for lin in self.layers:
            lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.dtype
        for i, lin in enumerate(self.layers):
            if cd is None:
                x = lin(x)
            else:
                y = F.linear(x.to(cd).float(), lin.weight.to(cd).float())
                x = y.to(cd) + lin.bias.to(cd)
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
        mean_aggr=agent.gnn_aggr == "mean", impl=gnn_impl,
        compute_dtype=agent.precision_policy.gnn_dtype)


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
                       tuple(agent.actor_hidden_layer_nodes) + (action_dim,),
                       dtype=agent.precision_policy.mlp_dtype)

    def reset_parameters(self, generator: torch.Generator):
        self.embedder.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, obs: GraphObs) -> torch.Tensor:
        emb = self.embedder(obs.nodes, obs.edge_index, obs.edge_mask,
                            obs.node_mask)
        h = torch.cat([emb, obs.mask.to(emb.dtype)], dim=-1)
        out = self.mlp(h) * obs.mask
        # actions leave in f32 whatever the compute dtype (a bf16 output
        # times an f32 mask already promotes, as in JAX; a replayed bf16
        # mask keeps bf16 until here)
        return out if self.mlp.dtype is None else out.float()


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
                       tuple(agent.critic_hidden_layer_nodes) + (1,),
                       dtype=agent.precision_policy.mlp_dtype)

    def reset_parameters(self, generator: torch.Generator):
        self.embedder.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, obs: GraphObs, action: torch.Tensor) -> torch.Tensor:
        emb = self.embedder(obs.nodes, obs.edge_index, obs.edge_mask,
                            obs.node_mask)
        h = torch.cat([emb, obs.mask.to(emb.dtype), action.to(emb.dtype)],
                      dim=-1)
        q = self.mlp(h)
        # Q-values leave in f32: TD targets and losses stay full precision
        return q if self.mlp.dtype is None else q.float()


def scale_action(action: torch.Tensor, low: float = 0.0,
                 high: float = 1.0) -> torch.Tensor:
    """[low, high] -> [-1, 1]."""
    return 2.0 * (action - low) / (high - low) - 1.0


def unscale_action(scaled: torch.Tensor, low: float = 0.0,
                   high: float = 1.0) -> torch.Tensor:
    """[-1, 1] -> [low, high]."""
    return low + 0.5 * (scaled + 1.0) * (high - low)
