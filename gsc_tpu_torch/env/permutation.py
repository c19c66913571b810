"""Node-permutation augmentation: the ``ShuffleOps`` protocol.

The port of ``gsc_tpu.env.permutation.ShuffleOps`` for ``shuffle_nodes``
off, the default: every method is the identity, so the rollout calls them
unconditionally as the JAX package's does.  Shuffling itself is not ported
(ROADMAP Queue 1); asking for it raises.
"""
from __future__ import annotations

import torch

from ..config.schema import AgentConfig, EnvLimits


class ShuffleOps:
    """Per-step shuffle protocol with ``shuffle_nodes`` off."""

    def __init__(self, agent: AgentConfig, limits: EnvLimits):
        if agent.shuffle_nodes:
            raise NotImplementedError(
                "shuffle_nodes is not ported yet (ROADMAP Queue 1); run "
                "with shuffle_nodes: false")
        self.n = limits.max_nodes

    def init_perm(self, batch: int, device) -> torch.Tensor:
        return torch.arange(self.n, device=device).expand(batch, self.n)

    def permute_obs(self, obs, perm):
        return obs

    def step_mask(self, obs, mask, perm):
        """Action mask in the current frame (graph mode: the obs's)."""
        return obs.mask

    def env_action(self, action, perm):
        return action

    def advance(self, next_obs, perm):
        return next_obs, perm
