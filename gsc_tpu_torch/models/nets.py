"""Actor and critic networks.

The port of ``gsc_tpu.models.nets.Actor`` and ``QNetwork``.  Flat mode
(``AgentConfig.graph_mode`` false): plain MLPs over the flat observation
[..., N*F] (the actor: hidden layers and an ``action_dim`` output, no
mask multiply; the critic: hidden layers and one output over the
observation joined with the action), as in the JAX package.  Graph mode,
the monolithic heads: GNN embedding of the padded network graph, concatenated
with the flattened action mask (and, for the critic, the action), through
an MLP (Linear -> ReLU between layers, plain last layer).  The factored
heads (``use_factored_head``: on by default at action dims >= 16384, where
a monolithic output layer of hidden x N*C*S*N' weights no longer fits)
score the [src, sfc, sf, dst] schedule as a bilinear form between
per-node embeddings: the actor maps each source node's embedding (with
the pooled graph context) through its hidden stack to per-(sfc, sf)
queries and each destination's embedding to a key, logits[n,c,s,m] =
<q[n,c,s], k[m]>; the critic contracts the action against the keys over
the destination axis, joins those per-source features to the node
embeddings through a per-node ``src`` layer, mean-pools, and scores
[pooled embedding, pooled features] with its MLP.  Parameters scale with
C*S*hidden*key_dim, not N^2.  In graph mode the actor's output is
multiplied by the mask so padded (src, dst) entries are exactly zero; the
critic returns Q [..., 1].  The bilinear products are plain ``torch.einsum`` products.

Mixed precision (``AgentConfig.precision``): the embedder computes in the
policy's ``gnn_dtype`` and the dense layers in its ``mlp_dtype``, with
parameters kept as f32 masters; the bilinear products take operands in
that dtype and accumulate in f32, as the JAX package's
``preferred_element_type=jnp.float32`` einsums do; both networks' outputs
(actions, Q-values) leave in f32.  The "f32" policy runs the f32 code
verbatim.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import AgentConfig
from ..ops.gat import compute_dtype_of
from .gnn import GNNEmbedder, masked_mean_pool
from .init import lecun_normal_

# action dims (N * C * S * N') from which the factored heads take over by
# default (the JAX package's threshold)
FACTORED_HEAD_THRESHOLD = 16384


def use_factored_head(agent: AgentConfig, action_dim: int) -> bool:
    """Whether the networks of ``agent`` at ``action_dim`` take the
    factored heads: ``agent.factored_head`` when it is set (in graph
    mode), else from the threshold."""
    if agent.factored_head is not None:
        return agent.factored_head and agent.graph_mode
    return agent.graph_mode and action_dim >= FACTORED_HEAD_THRESHOLD


def _check_sched_shape(sched_shape, action_dim: int) -> Tuple[int, ...]:
    if sched_shape is None:
        raise ValueError(
            "factored action head needs sched_shape=(N, C, S, N') "
            "(see EnvLimits.scheduling_shape)")
    n, c, s, n2 = sched_shape
    if n * c * s * n2 != action_dim:
        raise ValueError(f"sched_shape {sched_shape} does not factor "
                         f"action dim {action_dim}")
    return n, c, s, n2


def _dense(lin: nn.Linear, x: torch.Tensor, cd) -> torch.Tensor:
    """One dense layer in compute dtype ``cd`` (None = f32 verbatim), as
    flax's ``nn.Dense(dtype=...)`` with the JAX package's f32-accumulating
    ``dot_general`` computes it: input and weight rounded to the dtype and
    multiplied in f32 (each product exact, the sum f32), the product
    rounded to the dtype, then the bias rounded to the dtype added in it
    (a second rounding)."""
    if cd is None:
        return lin(x)
    y = F.linear(x.to(cd).float(), lin.weight.to(cd).float())
    return y.to(cd) + lin.bias.to(cd)


def _linear(fan_in: int, fan_out: int) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, fan_in, fan_out)


def _reset_linear(lin: nn.Linear, generator: torch.Generator):
    lecun_normal_(lin.weight, lin.in_features, generator)
    nn.init.zeros_(lin.bias)


class MLP(nn.Module):
    """Linear/ReLU stack with a plain last layer.  ``dtype`` is the
    compute dtype (``PrecisionPolicy.mlp_dtype``; None = f32 verbatim);
    each layer computes as ``_dense``, ReLU in the dtype."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype: Optional[str] = None):
        super().__init__()
        self.dtype = compute_dtype_of(dtype)
        dims = [in_features, *features]
        self.out_features = dims[-1]
        self.layers = nn.ModuleList(
            _linear(dims[i], dims[i + 1]) for i in range(len(features)))

    def reset_parameters(self, generator: torch.Generator):
        for lin in self.layers:
            _reset_linear(lin, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            x = _dense(lin, x, self.dtype)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def _flat_obs_dim(obs_dim: Optional[int]) -> int:
    if obs_dim is None:
        raise ValueError("flat mode (graph_mode false) needs obs_dim, the "
                         "flat observation's length (ServiceCoordEnv."
                         "obs_dim)")
    return obs_dim


def _embedder(agent: AgentConfig, gnn_impl: str,
              pool: bool = True) -> GNNEmbedder:
    return GNNEmbedder(
        in_features=len(agent.observation_space), hidden=agent.gnn_features,
        num_layers=agent.gnn_num_layers, num_iter=agent.gnn_num_iter,
        mean_aggr=agent.gnn_aggr == "mean", impl=gnn_impl,
        compute_dtype=agent.precision_policy.gnn_dtype, pool=pool)


def _bilinear(spec: str, a: torch.Tensor, b: torch.Tensor, cd
              ) -> torch.Tensor:
    """``torch.einsum(spec, a, b)``; under a compute dtype the operands are
    rounded to it and the products accumulate in f32 (an f32 result)."""
    if cd is None:
        return torch.einsum(spec, a, b)
    return torch.einsum(spec, a.to(cd).float(), b.to(cd).float())


class Actor(nn.Module):
    """Policy network.  Flat mode: MLP over the [..., obs_dim] flat
    observation -> action_dim, unmasked.  Graph mode: the monolithic head
    (embedding ++ mask -> MLP -> action_dim) or, per
    ``use_factored_head``, the factored head over ``sched_shape`` = (N,
    C, S, N'); masked either way."""

    def __init__(self, agent: AgentConfig, action_dim: int,
                 gnn_impl: str = "dense",
                 sched_shape: Optional[Tuple[int, int, int, int]] = None,
                 obs_dim: Optional[int] = None):
        super().__init__()
        self.action_dim = action_dim
        self.gnn_impl = gnn_impl
        self.graph_mode = agent.graph_mode
        self.factored = use_factored_head(agent, action_dim)
        mdt = agent.precision_policy.mlp_dtype
        if not self.graph_mode:
            self.mlp = MLP(_flat_obs_dim(obs_dim),
                           tuple(agent.actor_hidden_layer_nodes)
                           + (action_dim,), dtype=mdt)
            return
        hidden = agent.gnn_features
        self.embedder = _embedder(agent, gnn_impl, pool=not self.factored)
        if self.factored:
            self.sched_shape = _check_sched_shape(sched_shape, action_dim)
            _, c, s, _ = self.sched_shape
            g = agent.factored_key_dim
            self.mlp = MLP(2 * hidden, tuple(agent.actor_hidden_layer_nodes),
                           dtype=mdt)
            self.query = _linear(self.mlp.out_features, c * s * g)
            self.key = _linear(hidden, g)
        else:
            self.mlp = MLP(hidden + action_dim,
                           tuple(agent.actor_hidden_layer_nodes)
                           + (action_dim,), dtype=mdt)

    def reset_parameters(self, generator: torch.Generator):
        if self.graph_mode:
            self.embedder.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        if self.factored:
            _reset_linear(self.query, generator)
            _reset_linear(self.key, generator)

    def forward(self, obs) -> torch.Tensor:
        if not self.graph_mode:
            # the flat observation straight through the MLP; actions leave
            # in f32 whatever the compute dtype
            return self.mlp(obs).float()
        emb = self.embedder(obs.nodes, obs.edge_index, obs.edge_mask,
                            obs.node_mask)
        cd = self.mlp.dtype
        if self.factored:
            n, c, s, _ = self.sched_shape
            pooled = masked_mean_pool(emb, obs.node_mask)
            # per-source hidden stack over [node embedding, pooled graph]
            h = torch.cat([emb, pooled.to(emb.dtype)[..., None, :]
                           .expand(emb.shape[:-1] + pooled.shape[-1:])],
                          dim=-1)
            h = torch.relu(self.mlp(h))
            q = _dense(self.query, h, cd)                # [.., N, C*S*G]
            k = _dense(self.key, emb, cd)                # [.., N', G]
            q = q.reshape(q.shape[:-2] + (n, c, s, k.shape[-1]))
            out = _bilinear("...ncsg,...mg->...ncsm", q, k, cd)
            out = out.reshape(out.shape[:-4] + (self.action_dim,))
            return (out * obs.mask).float()
        h = torch.cat([emb, obs.mask.to(emb.dtype)], dim=-1)
        out = self.mlp(h) * obs.mask
        # actions leave in f32 whatever the compute dtype (a bf16 output
        # times an f32 mask already promotes, as in JAX; a replayed bf16
        # mask keeps bf16 until here)
        return out if cd is None else out.float()


class QNetwork(nn.Module):
    """Critic Q(s, a) -> [..., 1].  Flat mode: MLP over [obs, action].
    Graph mode: the monolithic head (embedding ++ mask ++ action -> MLP)
    or, per ``use_factored_head``, the factored head over ``sched_shape``
    (which reads the mask only through node validity, as the JAX
    package's does)."""

    def __init__(self, agent: AgentConfig, action_dim: int,
                 gnn_impl: str = "dense",
                 sched_shape: Optional[Tuple[int, int, int, int]] = None,
                 obs_dim: Optional[int] = None):
        super().__init__()
        self.action_dim = action_dim
        self.gnn_impl = gnn_impl
        self.graph_mode = agent.graph_mode
        self.factored = use_factored_head(agent, action_dim)
        mdt = agent.precision_policy.mlp_dtype
        head = tuple(agent.critic_hidden_layer_nodes) + (1,)
        if not self.graph_mode:
            self.mlp = MLP(_flat_obs_dim(obs_dim) + action_dim, head,
                           dtype=mdt)
            return
        hidden = agent.gnn_features
        self.embedder = _embedder(agent, gnn_impl, pool=not self.factored)
        if self.factored:
            self.sched_shape = _check_sched_shape(sched_shape, action_dim)
            _, c, s, _ = self.sched_shape
            g = agent.factored_key_dim
            self.key = _linear(hidden, g)
            self.src = _linear(hidden + c * s * g, hidden)
            self.mlp = MLP(2 * hidden, head, dtype=mdt)
        else:
            self.mlp = MLP(hidden + 2 * action_dim, head, dtype=mdt)

    def reset_parameters(self, generator: torch.Generator):
        if self.graph_mode:
            self.embedder.reset_parameters(generator)
        if self.factored:
            _reset_linear(self.key, generator)
            _reset_linear(self.src, generator)
        self.mlp.reset_parameters(generator)

    def forward(self, obs, action: torch.Tensor) -> torch.Tensor:
        if not self.graph_mode:
            # [obs, action] with the action in the observation's dtype (a
            # replayed bf16 observation takes a bf16 action), Q in f32
            return self.mlp(torch.cat([obs, action.to(obs.dtype)],
                                      dim=-1)).float()
        emb = self.embedder(obs.nodes, obs.edge_index, obs.edge_mask,
                            obs.node_mask)
        cd = self.mlp.dtype
        if self.factored:
            n, c, s, n2 = self.sched_shape
            pooled = masked_mean_pool(emb, obs.node_mask)
            a4 = action.reshape(action.shape[:-1] + (n, c, s, n2))
            k = _dense(self.key, emb, cd)                # [.., N', G]
            # per-source action features: the action against the keys
            a_enc = _bilinear("...ncsm,...mg->...ncsg", a4, k, cd)
            z = torch.cat([emb, a_enc.reshape(a_enc.shape[:-3] + (-1,))
                           .to(emb.dtype)], dim=-1)
            z = torch.relu(_dense(self.src, z, cd))
            h = torch.cat([pooled, masked_mean_pool(z, obs.node_mask)],
                          dim=-1)
        else:
            h = torch.cat([emb, obs.mask.to(emb.dtype),
                           action.to(emb.dtype)], dim=-1)
        q = self.mlp(h)
        # Q-values leave in f32: TD targets and losses stay full precision
        return q if cd is None else q.float()


def scale_action(action: torch.Tensor, low: float = 0.0,
                 high: float = 1.0) -> torch.Tensor:
    """[low, high] -> [-1, 1]."""
    return 2.0 * (action - low) / (high - low) - 1.0


def unscale_action(scaled: torch.Tensor, low: float = 0.0,
                   high: float = 1.0) -> torch.Tensor:
    """[-1, 1] -> [low, high]."""
    return low + 0.5 * (scaled + 1.0) * (high - low)
