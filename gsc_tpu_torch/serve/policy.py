"""The greedy policy as a batched serving surface.

The port of ``gsc_tpu.serve.policy``.  ``ObsTemplate`` owns the contract
between host requests and device batches: a request is a ``GraphObs`` of
host (numpy) arrays for one graph, or in flat mode (``graph_mode`` false)
one flat observation array, of the template's kind; the template
validates it, and stacks
``k <= bucket`` requests into ``[bucket, ...]`` arrays, padding by
repeating the last real request.  ``GreedyServePolicy`` runs
``DDPG.greedy_action`` on one such bucket as one eager batched call; rows
never interact, so an answer does not depend on its batch-mates.  There is
no ahead-of-time export: the server warms each bucket once at start, so
the kernel build and the first launch happen before any request.  The
template's leaves are the env's f32 observations under every precision
policy: a bf16 actor casts its inputs inside.

Served weights are swappable.  The policy holds its own copy of the
agent's actor and, once a swap has happened, a spare one: a published
version is staged into the spare (checked leaf by leaf against the
served state dict, in its order), then :meth:`GreedyServePolicy.swap`
exchanges the two references, which the server does under the batcher's
flush lock, between two dispatches.  With ``stream`` (a
``torch.cuda.Stream``, one per fleet worker) every dispatch and every
staging copy runs on that stream, so a staged version is complete, in
stream order, before the first batch that reads it.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..env.observations import GraphObs

_FIELDS = tuple(f.name for f in dataclasses.fields(GraphObs))
# the one leaf of a flat observation
_FLAT_FIELDS = ("obs",)
# the cost ledger's name of a bucket's batched policy call
POLICY_FN_PREFIX = "serve_policy_b"


def policy_fn_name(batch: int) -> str:
    return f"{POLICY_FN_PREFIX}{batch}"


class ObsTemplate:
    """Flatten/stack/pad contract between host requests and batches."""

    def __init__(self, sample_obs):
        self.graph = isinstance(sample_obs, GraphObs)
        self.fields = _FIELDS if self.graph else _FLAT_FIELDS
        self.leaves: List[np.ndarray] = self._leaves(sample_obs)
        self.leaf_shapes: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(x.shape) for x in self.leaves)
        self.leaf_dtypes: Tuple[str, ...] = tuple(
            str(x.dtype) for x in self.leaves)

    def _leaves(self, obs) -> List[np.ndarray]:
        vals = ([getattr(obs, name) for name in _FIELDS] if self.graph
                else [obs])
        return [v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v) for v in vals]

    def flatten(self, obs) -> List[np.ndarray]:
        """One request -> host leaf list (validated against the template)."""
        if isinstance(obs, GraphObs) != self.graph:
            raise ValueError(
                f"request is {type(obs).__name__}, the serving template "
                f"wants {'a GraphObs' if self.graph else 'a flat array'}")
        out = self._leaves(obs)
        for i, arr in enumerate(out):
            if tuple(arr.shape) != self.leaf_shapes[i] or \
                    str(arr.dtype) != self.leaf_dtypes[i]:
                raise ValueError(
                    f"request obs leaf {self.fields[i]} is {arr.shape}/"
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
    """``DDPG.greedy_action`` over one bucket of stacked requests, with
    the served actor swappable between dispatches."""

    def __init__(self, ddpg, sample_obs, stream=None):
        self.ddpg = ddpg
        self.template = ObsTemplate(sample_obs)
        self.stream = stream
        if stream is not None:
            # the agent's weights were written on the caller's stream
            stream.wait_stream(torch.cuda.current_stream(stream.device))
        with self._on_stream():
            self.actor = copy.deepcopy(ddpg.actor)
        self._spare = None

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def leaves(self) -> List[np.ndarray]:
        """The served weights as host arrays, in state-dict order (the
        layout :class:`~gsc_tpu_torch.serve.fleet.WeightPublisher`
        writes)."""
        with self._on_stream():
            return [v.detach().cpu().numpy()
                    for v in self.actor.state_dict().values()]

    def stage(self, leaves: Sequence[np.ndarray], version=None):
        """An actor holding ``leaves`` (the spare, loaded on the policy's
        stream), ready for :meth:`swap`.  A leaf count, shape or dtype
        that differs from the served weights raises and leaves them
        untouched."""
        served = self.actor.state_dict()
        # an actor of the other observation mode differs in its leaves
        actor = (f"served actor (graph_mode "
                 f"{str(self.template.graph).lower()})")
        if len(leaves) != len(served):
            raise ValueError(
                f"hot-swap version {version} has {len(leaves)} leaves, the "
                f"{actor} has {len(served)}")
        for i, (new, (name, cur)) in enumerate(zip(leaves, served.items())):
            new = np.asarray(new)
            want = str(cur.dtype).removeprefix("torch.")
            if tuple(new.shape) != tuple(cur.shape) or str(new.dtype) != want:
                raise ValueError(
                    f"hot-swap version {version} leaf {i} ({name}) is "
                    f"{new.shape}/{new.dtype}, the {actor} wants "
                    f"{tuple(cur.shape)}/{want}")
        with self._on_stream():
            spare = self._spare if self._spare is not None \
                else copy.deepcopy(self.actor)
            spare.load_state_dict(
                {name: torch.from_numpy(np.array(new))
                 for name, new in zip(served, leaves)})
        return spare

    def swap(self, actor) -> None:
        """Serve ``actor`` (from :meth:`stage`); the old one becomes the
        spare.  The caller holds the flush lock."""
        self._spare, self.actor = self.actor, actor

    def run_batch(self, leaves: Sequence[np.ndarray]) -> np.ndarray:
        """Bucket arrays -> actions [bucket, A] as a host array."""
        dev = self.ddpg.device
        with self._on_stream():
            xs = [torch.from_numpy(x).to(dev) for x in leaves]
            obs = (GraphObs(**dict(zip(_FIELDS, xs))) if self.template.graph
                   else xs[0])
            actions = self.ddpg.greedy_action(obs, actor=self.actor)
            # the answer leaves the card once per flush, by design: the
            # batcher hands its clients host arrays
            return actions.cpu().numpy()  # gsc-lint: disable=R1 -- the flush's one copy to the host

    def warm(self, batch: int) -> np.ndarray:
        """One call at bucket ``batch`` on the template's own sample."""
        return self.run_batch(self.template.stack_pad([self.template.leaves],
                                                      batch))
