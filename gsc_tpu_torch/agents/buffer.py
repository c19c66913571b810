"""Replay ring buffer on the device.

The port of ``gsc_tpu.agents.buffer``: a transition is a nested dict of
tensors (graph observations as ``GraphObs``), stored in one ring whose
leaves carry a leading [capacity] axis, or per-replica shards whose leaves
carry [B, capacity] (the replica-parallel learner's layout).  As in the
JAX package, leaves of two or more dims per transition are stored
flattened to one dim and restored to their shapes when a batch is read
(``restore_batch``); ``buffer_sample`` draws a uniform batch from one
ring.  Unlike the JAX package, ``buffer_add`` writes in
place and returns the same buffer: the ring is the largest resident of a
training run, and nothing reads an older version of it.  Leaves may mix
dtypes (under the bf16 policy the float obs, next_obs and action leaves
are bf16 beside f32 reward and done); ``buffer_add`` casts on write and
``buffer_nbytes`` counts each leaf at its storage dtype.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..env.observations import GraphObs


def _flatten_tree(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict / GraphObs -> {dotted name: tensor}."""
    out = {}
    if isinstance(tree, GraphObs):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(GraphObs)}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_tree(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: torch.as_tensor(tree)}


def _unflatten_tree(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """{dotted name: tensor} -> nested dict, with ``obs`` and ``next_obs``
    as ``GraphObs``."""
    tree: Dict[str, Any] = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    for key in ("obs", "next_obs"):
        if isinstance(tree.get(key), dict) and \
                set(tree[key]) == {f.name for f in dataclasses.fields(GraphObs)}:
            tree[key] = GraphObs(**tree[key])
    return tree


@dataclass
class ReplayBuffer:
    """Ring buffer: ``data`` leaves [*lead, capacity, ...] with ``lead`` =
    () for one ring or (B,) for per-replica shards; ``pos`` / ``size``
    i32 of shape ``lead``; ``shapes`` the per-transition shape of each
    flattened leaf (None for leaves stored as they are)."""

    data: Dict[str, torch.Tensor]
    pos: torch.Tensor
    size: torch.Tensor
    shapes: Dict[str, Optional[Tuple[int, ...]]]

    @property
    def capacity(self) -> int:
        return next(iter(self.data.values())).shape[self.pos.dim()]


def transition_shapes(example: Any) -> Dict[str, Optional[Tuple[int, ...]]]:
    """Per-leaf storage spec of an example transition."""
    return {k: tuple(v.shape) if v.dim() >= 2 else None
            for k, v in _flatten_tree(example).items()}


def flatten_transition(item: Any, lead: int = 0) -> Dict[str, torch.Tensor]:
    """Flatten the leaves of a transition (with ``lead`` leading batch
    dims) that have two or more dims of their own."""
    return {k: v.reshape(v.shape[:lead] + (-1,)) if v.dim() - lead >= 2
            else v for k, v in _flatten_tree(item).items()}


def restore_batch(shapes, flat: Dict[str, torch.Tensor],
                  lead: int = 1) -> Dict[str, Any]:
    """Reshape a sampled batch's flattened leaves back to their
    per-transition shapes (``lead`` leading batch dims) and rebuild the
    nested transition."""
    out = {k: v if shapes.get(k) is None
           else v.reshape(v.shape[:lead] + shapes[k]) for k, v in flat.items()}
    return _unflatten_tree(out)


def buffer_init(example: Any, capacity: int, lead: Tuple[int, ...] = (),
                device=None) -> ReplayBuffer:
    """Allocate zeros from an example transition (one transition, no
    batch dim): leaves [*lead, capacity, ...]."""
    flat = flatten_transition(example)
    dev = device if device is not None else next(iter(flat.values())).device
    data = {k: torch.zeros(tuple(lead) + (capacity,) + tuple(v.shape),
                           dtype=v.dtype, device=dev)
            for k, v in flat.items()}
    return ReplayBuffer(
        data=data, pos=torch.zeros(lead, dtype=torch.int32, device=dev),
        size=torch.zeros(lead, dtype=torch.int32, device=dev),
        shapes=transition_shapes(example))


def buffer_add(buf: ReplayBuffer, item: Any) -> ReplayBuffer:
    """Insert one transition per ring at ``pos`` (items carry the rings'
    lead dims), in place; returns ``buf``."""
    lead = buf.pos.dim()
    cap = buf.capacity
    flat = flatten_transition(item, lead)
    pos = buf.pos.long()
    for k, d in buf.data.items():
        x = flat[k].to(d.dtype)
        if lead == 0:
            d[pos] = x
        else:
            d[torch.arange(d.shape[0], device=d.device), pos] = x
    buf.pos = (buf.pos + 1) % cap
    buf.size = torch.clamp(buf.size + 1, max=cap)
    return buf


def buffer_sample(buf: ReplayBuffer, draws, batch_size: int) -> Dict[str, Any]:
    """Uniform sample of ``batch_size`` transitions of one ring (slot
    indices from ``draws.slots``), restored to their shapes."""
    idx = draws.slots(batch_size, buf.size)
    return restore_batch(buf.shapes, {k: d[idx] for k, d in buf.data.items()})


def buffer_nbytes(buf: ReplayBuffer) -> int:
    """Replay storage in bytes, summed per leaf from its storage dtype
    (never an assumed element size: bf16 leaves count 2 bytes beside f32
    reward and done)."""
    return sum(d.numel() * d.element_size() for d in buf.data.values())
