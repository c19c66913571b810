"""The greedy policy as a batched serving surface.

The port of ``gsc_tpu.serve.policy``.  ``ObsTemplate`` owns the contract
between host requests and device batches: a request is a ``GraphObs`` of
host (numpy) arrays for one graph; the template validates it, and stacks
``k <= bucket`` requests into ``[bucket, ...]`` arrays, padding by
repeating the last real request.  ``GreedyServePolicy`` runs
``DDPG.greedy_action`` on one such bucket as one eager batched call; rows
never interact, so an answer does not depend on its batch-mates.  There is
no ahead-of-time export: the server warms each bucket once at start, so
the kernel build and the first launch happen before any request.  The
template's leaves are the env's f32 observations under every precision
policy: a bf16 actor casts its inputs inside.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..env.observations import GraphObs

_FIELDS = tuple(f.name for f in dataclasses.fields(GraphObs))


class ObsTemplate:
    """Flatten/stack/pad contract between host requests and batches."""

    def __init__(self, sample_obs: GraphObs):
        self.leaves: List[np.ndarray] = self._leaves(sample_obs)
        self.leaf_shapes: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(x.shape) for x in self.leaves)
        self.leaf_dtypes: Tuple[str, ...] = tuple(
            str(x.dtype) for x in self.leaves)

    @staticmethod
    def _leaves(obs: GraphObs) -> List[np.ndarray]:
        out = []
        for name in _FIELDS:
            v = getattr(obs, name)
            out.append(v.cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v))
        return out

    def flatten(self, obs: GraphObs) -> List[np.ndarray]:
        """One request -> host leaf list (validated against the template)."""
        if not isinstance(obs, GraphObs):
            raise ValueError(f"request is {type(obs).__name__}, the serving "
                             "template wants a GraphObs")
        out = self._leaves(obs)
        for i, arr in enumerate(out):
            if tuple(arr.shape) != self.leaf_shapes[i] or \
                    str(arr.dtype) != self.leaf_dtypes[i]:
                raise ValueError(
                    f"request obs leaf {_FIELDS[i]} is {arr.shape}/"
                    f"{arr.dtype}, template wants {self.leaf_shapes[i]}/"
                    f"{self.leaf_dtypes[i]}")
        return out

    def stack_pad(self, requests: Sequence[List[np.ndarray]],
                  batch: int) -> List[np.ndarray]:
        """Stack ``len(requests) <= batch`` flattened requests into bucket
        arrays ``[batch, ...]``; padding rows repeat the last request."""
        k = len(requests)
        if not 0 < k <= batch:
            raise ValueError(f"{k} requests into a bucket of {batch}")
        out = []
        for i in range(len(self.leaves)):
            arr = np.empty((batch,) + self.leaf_shapes[i], self.leaf_dtypes[i])
            for j in range(batch):
                arr[j] = requests[min(j, k - 1)][i]
            out.append(arr)
        return out


class GreedyServePolicy:
    """``DDPG.greedy_action`` over one bucket of stacked requests."""

    def __init__(self, ddpg, sample_obs: GraphObs):
        self.ddpg = ddpg
        self.template = ObsTemplate(sample_obs)

    def run_batch(self, leaves: Sequence[np.ndarray]) -> np.ndarray:
        """Bucket arrays -> actions [bucket, A] as a host array."""
        dev = self.ddpg.device
        obs = GraphObs(**{name: torch.from_numpy(x).to(dev)
                          for name, x in zip(_FIELDS, leaves)})
        return self.ddpg.greedy_action(obs).cpu().numpy()

    def warm(self, batch: int) -> np.ndarray:
        """One call at bucket ``batch`` on the template's own sample."""
        return self.run_batch(self.template.stack_pad([self.template.leaves],
                                                      batch))
