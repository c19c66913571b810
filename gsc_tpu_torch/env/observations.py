"""Graph and flat observations.

The port of ``gsc_tpu.env.observations``.  Three node-feature
vectors, each max-normalised as ``clip(x / (max(x) + 1e-3), 0, 1)``:

- ``ingress_traffic``: per-node requested traffic of each chain's first SF
  (or ``ingress_override``: the traffic predictor's upcoming traffic);
- ``node_load``: processed traffic / node capacity, 1 where the node has
  zero capacity;
- ``node_cap``: max-normalised raw capacity.

``graph_obs`` returns the node feature matrix, the directed edge index and
the flattened action mask (graph mode); ``flat_obs`` the [..., N*F]
concatenation of the feature vectors, one vector per component (flat
mode, ``AgentConfig.graph_mode`` false).  Every tensor may carry leading
batch dims.  ``obs_map`` applies a function to every tensor of an
observation of either mode.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..topology.compiler import Topology
from ..utils.tree import TensorTree
from .actions import action_mask


@dataclass
class GraphObs(TensorTree):
    """Graph observation (shapes per graph, after any leading dims)."""

    nodes: torch.Tensor       # [N, F] node features
    node_mask: torch.Tensor   # [N] bool
    edge_index: torch.Tensor  # [2, 2E] directed (both ways per undirected edge)
    edge_mask: torch.Tensor   # [2E] bool
    mask: torch.Tensor        # [A] flattened action mask


def _maxnorm(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x / (x.amax(dim=-1, keepdim=True) + 1e-3), 0.0, 1.0)


def node_features(metrics, topo: Topology, node_cap_now: torch.Tensor,
                  chain_sf: np.ndarray, observation_space: Tuple[str, ...],
                  ingress_override: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """[..., N, F] feature matrix, columns in ``observation_space`` order;
    ``ingress_override`` [..., N] replaces the observed ingress traffic."""
    cols = []
    for comp in observation_space:
        if comp == "ingress_traffic":
            if ingress_override is not None:
                ing = ingress_override
            else:
                ing = torch.zeros_like(node_cap_now)
                for c in range(chain_sf.shape[0]):
                    # run_requested is position-indexed; the chain entry
                    # is 0
                    ing = ing + metrics.run_requested[..., c, 0]
            cols.append(_maxnorm(ing))
        elif comp == "node_load":
            usage = metrics.run_processed_traffic.sum(dim=-1)
            util = torch.where(node_cap_now > 0,
                               usage / node_cap_now.clamp(min=1e-30),
                               torch.ones((), device=usage.device))
            util = torch.where(topo.node_mask, util,
                               torch.zeros((), device=usage.device))
            cols.append(_maxnorm(util))
        elif comp == "node_cap":
            cols.append(_maxnorm(torch.where(
                topo.node_mask, node_cap_now,
                torch.zeros((), device=node_cap_now.device))))
        else:
            raise ValueError(f"Unknown observation component {comp!r}")
    return torch.stack(cols, dim=-1)


def flat_obs(metrics, topo: Topology, node_cap_now: torch.Tensor,
             chain_sf: np.ndarray, observation_space: Tuple[str, ...],
             ingress_override: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """[..., N * F]: the selected node vectors one after the other (the
    feature matrix transposed and flattened)."""
    feats = node_features(metrics, topo, node_cap_now, chain_sf,
                          observation_space, ingress_override)
    return feats.transpose(-1, -2).reshape(feats.shape[:-2] + (-1,))


def obs_map(obs, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``fn`` over every tensor of a graph observation, or over a flat
    one."""
    return obs.map(fn) if isinstance(obs, GraphObs) else fn(obs)


def graph_obs(metrics, topo: Topology, node_cap_now: torch.Tensor,
              chain_sf: np.ndarray, observation_space: Tuple[str, ...],
              num_sfcs: int, max_sfs: int,
              ingress_override: Optional[torch.Tensor] = None) -> GraphObs:
    feats = node_features(metrics, topo, node_cap_now, chain_sf,
                          observation_space, ingress_override)
    edge_index, edge_mask = topo.directed_edge_index()
    return GraphObs(
        nodes=torch.where(topo.node_mask[..., None], feats,
                          torch.zeros((), device=feats.device)),
        node_mask=topo.node_mask,
        edge_index=edge_index,
        edge_mask=edge_mask,
        mask=action_mask(topo.node_mask, num_sfcs, max_sfs),
    )
