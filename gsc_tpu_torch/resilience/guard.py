"""Divergence guardrails: an on-device all-finite flag and rollback
snapshots.

The port of ``gsc_tpu.resilience.guard``.  One NaN gradient poisons the
learner state for good; the guard is two pieces:

- :func:`all_finite` — one f32 flag (1.0 / 0.0) on the device over every
  float tensor of the learner state (the four networks and both Adam
  states' moments), in a few launches: ``torch._foreach_mul`` by zero
  turns every finite entry into 0 and every NaN or inf into NaN,
  ``torch._foreach_norm`` reduces each tensor, and one ``isfinite`` over
  the stacked norms decides.  ``DDPG.rollout_episode`` flags the state
  entering an episode and the learn burst the updated state; the trainer
  reads both with the episode's other metrics at the drain.
- :class:`RollbackGuard` — the trainer's last-good snapshot.  The
  pipelined loop drains episode k after it has dispatched episode k+1,
  so a snapshot taken at a dispatch boundary is a candidate until its
  episode drains finite (:meth:`~RollbackGuard.promote`); on a
  violation the trainer restores ``last_good``.

A snapshot (:func:`tree_copy`) is a device clone of the networks, the
targets, both Adam states (their ``step`` tensors included), the replay
and the ``Draws`` generator's state; :func:`tree_restore` copies one back
into the live objects in place, so every tensor keeps its identity (an
Adam ``step`` stays the tensor it was) and the restored run continues as
the snapshot's run would have.  It costs two replay copies on the device,
as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

_NETS = ("actor", "critic", "target_actor", "target_critic")
_OPTS = (("actor_opt", "actor"), ("critic_opt", "critic"))


def learner_tensors(state) -> List[torch.Tensor]:
    """Every float tensor of the learner state: the networks' parameters
    and buffers, and both Adam states' moments (not their step counts)."""
    out = []
    for net in _NETS:
        out += [t for t in getattr(state, net).state_dict().values()
                if t.is_floating_point()]
    for opt_name, _ in _OPTS:
        for st in getattr(state, opt_name).state.values():
            out += [v for k, v in st.items()
                    if k != "step" and torch.is_tensor(v)
                    and v.is_floating_point()]
    return out


@torch.no_grad()
def all_finite(tensors) -> torch.Tensor:
    """0-d f32 flag on the tensors' device: 1.0 when every entry of every
    tensor is finite.  ``tensors`` is a list of tensors or a learner
    state."""
    if not isinstance(tensors, (list, tuple)):
        tensors = learner_tensors(tensors)
    tensors = [t.detach() for t in tensors if t.is_floating_point()]
    if not tensors:
        return torch.ones(())
    norms = torch._foreach_norm(torch._foreach_mul(tensors, 0.0))
    return torch.isfinite(torch.stack(norms)).all().to(torch.float32)


@torch.no_grad()
def poison_tree(module: torch.nn.Module) -> torch.nn.Module:
    """NaN every float parameter of ``module`` in place (the ``nan_grads``
    fault: the effect of a NaN gradient update)."""
    for p in module.parameters():
        if p.is_floating_point():
            p.mul_(float("nan"))
    return module


@dataclass
class Snapshot:
    """Device clones of a learner state, a replay and a random source."""

    nets: Dict[str, Dict[str, torch.Tensor]]
    opts: Dict[str, List[Optional[Dict[str, Any]]]]
    buffer: Optional[Dict[str, Any]]
    draws: Optional[torch.Tensor]


def _clone(v):
    return v.clone() if torch.is_tensor(v) else v


@torch.no_grad()
def tree_copy(state, buffer=None, draws=None) -> Snapshot:
    """Clone ``state`` (networks, targets, Adam states), ``buffer`` (a
    replay ring or shards) and ``draws``' generator state."""
    nets = {n: {k: v.clone() for k, v in getattr(state, n).state_dict()
                .items()} for n in _NETS}
    opts = {}
    for opt_name, net in _OPTS:
        opt = getattr(state, opt_name)
        opts[opt_name] = [
            ({k: _clone(v) for k, v in opt.state[p].items()}
             if p in opt.state else None)
            for p in getattr(state, net).parameters()]
    buf = None
    if buffer is not None:
        buf = {"data": {k: d.clone() for k, d in buffer.data.items()},
               "pos": buffer.pos.clone(), "size": buffer.size.clone()}
    gen = draws.generator.get_state() if draws is not None else None
    return Snapshot(nets=nets, opts=opts, buffer=buf, draws=gen)


@torch.no_grad()
def tree_restore(snap: Snapshot, state, buffer=None, draws=None) -> None:
    """Copy ``snap`` back into the live ``state``, ``buffer`` and
    ``draws`` in place."""
    for n in _NETS:
        live = getattr(state, n).state_dict()
        for k, v in snap.nets[n].items():
            live[k].copy_(v)
    for opt_name, net in _OPTS:
        opt = getattr(state, opt_name)
        for p, saved in zip(getattr(state, net).parameters(),
                            snap.opts[opt_name]):
            if saved is None:
                opt.state.pop(p, None)
                continue
            live = opt.state.get(p)
            if live and set(live) == set(saved):
                for k, v in saved.items():
                    if torch.is_tensor(v):
                        live[k].copy_(v)
                    else:
                        live[k] = v
            else:
                opt.state[p] = {k: _clone(v) for k, v in saved.items()}
    if buffer is not None and snap.buffer is not None:
        for k, d in buffer.data.items():
            d.copy_(snap.buffer["data"][k])
        buffer.pos = snap.buffer["pos"].clone()
        buffer.size = snap.buffer["size"].clone()
    if draws is not None and snap.draws is not None:
        draws.generator.set_state(snap.draws)


class RollbackGuard:
    """The last-good snapshot with deferred promotion (see the module
    docstring).  ``draws`` is the trainer's random source, snapshotted
    and restored with the state."""

    def __init__(self, draws=None):
        self.draws = draws
        # (episode_tag, snapshot): "the state after all episodes <= tag"
        self.last_good: Optional[Tuple[int, Snapshot]] = None
        self._candidate: Optional[Tuple[int, Snapshot]] = None
        self.rollbacks = 0

    def _snap(self, state, buffer) -> Snapshot:
        return tree_copy(state, buffer, self.draws)

    def init(self, episode_tag: int, state, buffer):
        """Seed ``last_good`` with the initial (finite) state, so a
        violation in the first episode has a target."""
        self.last_good = (episode_tag, self._snap(state, buffer))

    def stage(self, episode_tag: int, state, buffer):
        """Candidate at a dispatch boundary: the state after episode
        ``episode_tag``, not yet drained.  Taken before any fault
        injection."""
        self._candidate = (episode_tag, self._snap(state, buffer))

    def promote(self, drained_episode: int, state, buffer,
                pending_empty: bool):
        """Episode ``drained_episode`` drained finite: its candidate
        becomes ``last_good``; with nothing in flight the live state is
        the verified one and is snapshotted directly."""
        c = self._candidate
        if c is not None and c[0] == drained_episode:
            self.last_good = c
            self._candidate = None
        elif pending_empty:
            self.last_good = (drained_episode, self._snap(state, buffer))
            self._candidate = None

    def restore(self, state, buffer) -> Tuple[int, Any, Any]:
        """Copy ``last_good`` into ``state``, ``buffer`` and the random
        source in place; returns (tag, state, buffer).  ``last_good``
        stays for a later rollback."""
        self.rollbacks += 1
        self._candidate = None   # a descendant of the poisoned state
        tag, snap = self.last_good
        tree_restore(snap, state, buffer, self.draws)
        return tag, state, buffer


@torch.no_grad()
def materialize(snap: Snapshot, state, buffer):
    """A new (state, buffer) pair holding ``snap``: deep copies of the
    live objects with the snapshot copied in (for a checkpoint of the
    verified state while the live one is already further)."""
    import copy

    new_state = copy.deepcopy(state)
    new_buffer = copy.deepcopy(buffer) if buffer is not None else None
    tree_restore(snap, new_state, new_buffer)
    return new_state, new_buffer
