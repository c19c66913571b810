"""Dataclasses of tensors: the port's stand-in for flax ``struct`` pytrees."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


class TensorTree:
    """Mixin for dataclasses whose fields are tensors, nested trees or None."""

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """A copy with ``fn`` applied to every tensor leaf."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, TensorTree):
                v = v.map(fn)
            elif isinstance(v, torch.Tensor):
                v = fn(v)
            out[f.name] = v
        return type(self)(**out)

    def to(self, device) -> "TensorTree":
        return self.map(lambda t: t.to(device))

    def replace(self, **kw) -> "TensorTree":
        return dataclasses.replace(self, **kw)

    def expand(self, batch: int) -> "TensorTree":
        """A view with a leading [batch] dim on every field that lacks one
        (``_RANKS`` gives each field's unbatched rank; fields that already
        carry the batch dim are kept)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor) and v.dim() == self._RANKS[f.name]:
                v = v.unsqueeze(0).expand((batch,) + tuple(v.shape))
            out[f.name] = v
        return type(self)(**out)

    def rows(self, lo: int, hi: int) -> "TensorTree":
        """Rows ``lo`` to ``hi - 1`` of the leading [batch] dim of every
        field that carries one; fields without it are shared and kept."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor) and v.dim() > self._RANKS[f.name]:
                v = v[lo:hi]
            out[f.name] = v
        return type(self)(**out)
