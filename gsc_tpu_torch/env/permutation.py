"""Node-permutation augmentation: the ``shuffle_nodes`` protocol.

The port of ``gsc_tpu.env.permutation``.  With ``shuffle_nodes`` on, each
step the observation's node order is shuffled by a fresh random
permutation, and the agent's action, produced in the shuffled frame, is
mapped back through the inverse permutation (source and destination
axes) before the simulator sees it.  Padded nodes permute like any other;
the action mask travels with the permuted observation.

Every function takes a permutation ``perm`` [..., N] whose leading dims
are the tensor's own (one permutation per replica) or none.  The
permutations come from an explicit ``torch.Generator``: ``ShuffleOps``
draws them from the one it is handed, and tests pass their own in.
With ``shuffle_nodes`` off every ``ShuffleOps`` method is the identity,
so the rollouts call them unconditionally.  Both observation modes: a
graph observation's action mask travels with it, a flat observation's
mask is the env's (``action_mask`` of the topology), permuted by
``step_mask``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config.schema import AgentConfig, EnvLimits
from .observations import GraphObs


def random_permutation(generator: torch.Generator, n: int,
                       batch: Optional[int] = None) -> torch.Tensor:
    """A uniform random node permutation [n] (or [batch, n]) on the
    generator's device."""
    shape = (n,) if batch is None else (batch, n)
    return torch.rand(shape, generator=generator,
                      device=generator.device).argsort(-1)


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inverse[perm[j]] = j."""
    return perm.argsort(-1)


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` indexed by ``idx`` [..., N] along ``dim`` (negative), the
    leading dims of ``idx`` matching those of ``x``."""
    lead = idx.dim() - 1
    shape = [1] * x.dim()
    shape[:lead] = idx.shape[:lead]
    shape[dim] = idx.shape[-1]
    idx = idx.long().reshape(shape)
    target = list(x.shape)
    target[dim] = idx.shape[dim]
    return x.gather(dim, idx.expand(target))


def permute_flat_obs(obs: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The same node order on every stacked component vector of a flat
    observation [..., F*N]."""
    n = perm.shape[-1]
    v = obs.reshape(obs.shape[:-1] + (-1, n))
    return _take(v, perm[..., None, :] if perm.dim() > 1 else perm,
                 -1).reshape(obs.shape)


def _permute_mask(mask: torch.Tensor, perm: torch.Tensor, num_sfcs: int,
                  max_sfs: int) -> torch.Tensor:
    n = perm.shape[-1]
    m4 = mask.reshape(mask.shape[:-1] + (n, num_sfcs, max_sfs, n))
    m4 = _take(_take(m4, perm, -4), perm, -1)
    return m4.reshape(mask.shape)


def permute_graph_obs(obs: GraphObs, perm: torch.Tensor, num_sfcs: int,
                      max_sfs: int) -> GraphObs:
    """Node rows permuted, edges relabelled (the new id of node u is
    inv[u]) and the action mask permuted on both node axes."""
    inv = inverse_permutation(perm)
    lead = perm.dim() - 1
    ei = obs.edge_index.long()
    flat = ei.reshape(ei.shape[:lead] + (-1,))
    relabelled = _take(inv, flat, -1) if lead else inv[flat]
    return GraphObs(
        nodes=_take(obs.nodes, perm, -2),
        node_mask=_take(obs.node_mask, perm, -1),
        edge_index=relabelled.reshape(ei.shape).to(obs.edge_index.dtype),
        edge_mask=obs.edge_mask,
        mask=_permute_mask(obs.mask, perm, num_sfcs, max_sfs),
    )


def reverse_action_permutation(action: torch.Tensor, perm: torch.Tensor,
                               scheduling_shape: Tuple[int, int, int, int]
                               ) -> torch.Tensor:
    """An action produced in the permuted frame back in the original node
    order, on the source and destination axes."""
    inv = inverse_permutation(perm)
    a = action.reshape(action.shape[:-1] + tuple(scheduling_shape))
    a = _take(_take(a, inv, -4), inv, -1)
    return a.reshape(action.shape)


class ShuffleOps:
    """The per-step ``shuffle_nodes`` protocol shared by the single-env
    and replica rollouts: observations live in a per-step permuted frame
    (one permutation per replica), actions map back through the inverse
    before the env sees them.  Graph and flat observations."""

    def __init__(self, agent: AgentConfig, limits: EnvLimits):
        self.agent = agent
        self.limits = limits
        self.on = agent.shuffle_nodes
        self.n = limits.max_nodes

    def _draw(self, source, batch: int) -> torch.Tensor:
        # a torch.Generator, or a random source that carries one (Draws)
        generator = getattr(source, "generator", source)
        if not isinstance(generator, torch.Generator):
            raise ValueError("shuffle_nodes draws its permutations from an "
                             "explicit torch.Generator; pass one")
        rows = getattr(source, "rows", None)
        if rows is None:
            return random_permutation(generator, self.n, batch)
        # one rank of a mesh: the permutations of every replica, its rows
        lo, hi, total = rows
        if batch != hi - lo:
            raise ValueError(f"{batch} permutations on a rank that holds "
                             f"rows {lo}:{hi}")
        return random_permutation(generator, self.n, total)[lo:hi]

    def init_perm(self, batch: int, device, source=None) -> torch.Tensor:
        """[B, N] permutations of the first step (the identity when off),
        drawn from ``source``: a ``torch.Generator`` or a random source
        carrying one as ``generator`` (``agents.ddpg.Draws``)."""
        if not self.on:
            return torch.arange(self.n, device=device).expand(batch, self.n)
        return self._draw(source, batch)

    def permute_obs(self, obs, perm: torch.Tensor):
        if not self.on:
            return obs
        if self.agent.graph_mode:
            return permute_graph_obs(obs, perm, self.limits.num_sfcs,
                                     self.limits.max_sfs)
        return permute_flat_obs(obs, perm)

    def step_mask(self, obs, mask, perm):
        """Action mask in the current frame: graph mode the obs's (it
        travels with the permuted obs); flat mode the env's ``mask``,
        permuted on both node axes when shuffling."""
        if self.agent.graph_mode:
            return obs.mask
        if not self.on:
            return mask
        return _permute_mask(mask, perm, self.limits.num_sfcs,
                             self.limits.max_sfs)

    def env_action(self, action: torch.Tensor,
                   perm: torch.Tensor) -> torch.Tensor:
        """The action in the simulator's frame."""
        if not self.on:
            return action
        return reverse_action_permutation(action, perm,
                                          self.limits.scheduling_shape)

    def advance(self, next_obs, perm: torch.Tensor, source=None):
        """A fresh permutation (from ``source``, as ``init_perm``) and the
        next observation in its frame."""
        if not self.on:
            return next_obs, perm
        next_perm = self._draw(source, perm.shape[0])
        return self.permute_obs(next_obs, next_perm), next_perm
