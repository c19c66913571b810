"""The learning-signal ledger: per-topology |TD|, Q moments, layer norms
and replay fill, computed on the device inside the learn burst.

The port of ``gsc_tpu.obs.learning``.

**Device half** (on the learner's tensors; nothing here reads a value
back to the host):

- :func:`learn_signal` — one gradient step's signal: |TD-error| summed
  and counted per ``topo_idx`` (a one-hot contraction over the static
  ``num_topos``, so the sums do not depend on the order of atomics), the Q
  distribution's moments (mean, population std, min, max) and per-layer
  parameter and gradient norms (``torch._foreach_norm`` over each list,
  squares summed per layer through a fixed [layers, tensors] matrix).
  Layers carry the JAX package's names: the network, then the flax
  top-level module (``actor/GNNEmbedder_0``, ``critic/MLP_0``,
  ``actor/query``; ``utils.convert.flax_module_name``), so ``obs_report``
  and ``curves.json`` read the same.
- :func:`td_segments` — the per-topology |TD| part alone, for the steps
  of a burst whose moments and norms the last step overwrites;
  :func:`accumulate_signal` adds the TD sums over the burst and keeps the
  last step's moments and norms, :func:`zero_learn_signal` is the empty
  accumulator.
- :func:`replay_stats` — replay size, fill and mean age in env steps.

The signal only reads tensors the update has already made (the TD
residual, the gradients, the updated parameters), so a run with the
ledger on and one with it off update the learner identically.

**Host half**, after the drain has read the episode's values:
:func:`emit_learn_signal` (one ``learn_signal`` event and the gauges
``td_abs_mean`` overall and per ``topology``, ``q_*``,
``grad_norm{layer}``, ``param_norm{layer}``, ``replay_fill``) and
:class:`LearnLedger`, the observer's facade that keeps the topo-id ->
name mapping and hands the trainer its :class:`LearnLedgerSpec`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import upload
from ..utils.convert import flax_module_name


@dataclass(frozen=True)
class LearnLedgerSpec:
    """``num_topos`` sizes the TD segment axis: topo ids are schedule
    positions, clipped into ``[0, num_topos)``."""

    num_topos: int = 1

    @classmethod
    def for_topos(cls, num_topos: Optional[int]) -> "LearnLedgerSpec":
        """The spec of a run over ``num_topos`` topo ids (at least one)."""
        return cls(num_topos=max(int(num_topos or 1), 1))


_GROUPS: Dict[Tuple, Tuple[List[str], torch.Tensor]] = {}


def _layer_matrix(trees: Mapping[str, Mapping[str, torch.Tensor]]
                  ) -> Tuple[List[str], torch.Tensor, List[torch.Tensor]]:
    """(layer names in order of first appearance, the [layers, tensors]
    0/1 matrix on the tensors' device, the flat tensor list) of
    ``{net: {param name: tensor}}``; the names and matrix are built once
    per parameter layout."""
    names, tensors = [], []
    for net, params in trees.items():
        for pname, t in params.items():
            names.append(f"{net}/{flax_module_name(pname)}")
            tensors.append(t)
    dev = tensors[0].device
    key = (tuple(names), str(dev))
    hit = _GROUPS.get(key)
    if hit is None:
        layers = list(dict.fromkeys(names))
        m = np.zeros((len(layers), len(names)), np.float32)
        for j, n in enumerate(names):
            m[layers.index(n), j] = 1.0
        hit = _GROUPS[key] = (layers, upload(m, torch.float32, dev))
    return hit[0], hit[1], tensors


def layer_norms(trees: Mapping[str, Mapping[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """Per-layer global norms of ``{net: {param name: tensor}}`` (device
    scalars)."""
    layers, m, tensors = _layer_matrix(trees)
    sq = torch.stack(torch._foreach_norm([t.detach().float()
                                          for t in tensors])) ** 2
    norms = torch.sqrt(m @ sq)
    return {name: norms[i] for i, name in enumerate(layers)}


def td_segments(spec: LearnLedgerSpec, topo_idx: torch.Tensor,
                td: torch.Tensor) -> Dict[str, torch.Tensor]:
    """|TD| summed and counted per topology over one batch."""
    k = max(spec.num_topos, 1)
    seg = torch.clamp(topo_idx.long(), 0, k - 1)
    # [batch, k]; F.one_hot would read the ids' range into Python
    onehot = (seg[:, None] == torch.arange(k, device=seg.device)).to(
        td.dtype)
    return {"td_abs_sum": td.detach().abs() @ onehot,
            "td_count": onehot.sum(0)}


def learn_signal(spec: LearnLedgerSpec, topo_idx: torch.Tensor,
                 td: torch.Tensor, q: torch.Tensor,
                 params: Mapping[str, Mapping[str, torch.Tensor]],
                 grads: Mapping[str, Mapping[str, torch.Tensor]]) -> Dict:
    """One gradient step's signal: ``td`` the critic residual ``q -
    target``, ``q`` the critic's values, ``params`` the updated parameters
    and ``grads`` the gradients, each as ``{"actor": {name: tensor},
    "critic": {...}}``."""
    q = q.detach()
    return {**td_segments(spec, topo_idx, td),
            "q_mean": q.mean(), "q_std": q.std(unbiased=False),
            "q_min": q.min(), "q_max": q.max(),
            "param_norms": layer_norms(params),
            "grad_norms": layer_norms(grads)}


def zero_learn_signal(spec: LearnLedgerSpec, device=None) -> Dict:
    """The burst's empty accumulator (TD sums only: moments and norms are
    the last step's)."""
    k = max(spec.num_topos, 1)
    return {"td_abs_sum": torch.zeros(k, device=device),
            "td_count": torch.zeros(k, device=device)}


def accumulate_signal(acc: Dict, sig: Dict) -> Dict:
    """TD sums added over the burst; moments and norms keep ``sig``'s
    (the last step's, as the loss metrics do)."""
    return {**sig,
            "td_abs_sum": acc["td_abs_sum"] + sig["td_abs_sum"],
            "td_count": acc["td_count"] + sig["td_count"]}


def replay_stats(buffer) -> Dict[str, torch.Tensor]:
    """Replay size, fill and mean insertion age in env steps, on the
    device; one ring (``size`` []) or replica shards (``size`` [B])."""
    size = buffer.size
    s = size.to(torch.float32)
    return {"size": size, "fill": s / max(buffer.capacity, 1),
            "age_mean_steps": torch.clamp(s - 1.0, min=0.0) / 2.0}


# ----------------------------------------------------------------- host
def _scalar(v) -> Optional[float]:
    try:
        return round(float(np.asarray(v.detach().cpu() if hasattr(
            v, "detach") else v)), 6)
    except (TypeError, ValueError):
        return None


def _host(v) -> np.ndarray:
    return np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)


def emit_learn_signal(hub, episode: int, signal: Optional[Dict] = None,
                      replay: Optional[Dict] = None,
                      segment_names: Optional[Sequence[str]] = None
                      ) -> Optional[Dict]:
    """One episode's learn signal into the hub: gauges and one
    ``learn_signal`` event.  Called from the drain."""
    if hub is None or (signal is None and replay is None):
        return None
    fields: Dict = {"episode": episode}
    if signal is not None:
        sums = _host(signal["td_abs_sum"]).astype(np.float64)
        counts = _host(signal["td_count"]).astype(np.float64)
        total = counts.sum()
        td_mean = (round(float(sums.sum() / total), 6) if total > 0
                   else None)
        per_topo = {}
        for i in range(sums.shape[0]):
            if counts[i] > 0:
                name = (str(segment_names[i]) if segment_names is not None
                        and i < len(segment_names) else f"topo{i}")
                per_topo[name] = round(float(sums[i] / counts[i]), 6)
        q = {k: _scalar(signal[k])
             for k in ("q_mean", "q_std", "q_min", "q_max")}
        grad_norms = {k: _scalar(v)
                      for k, v in (signal.get("grad_norms") or {}).items()}
        param_norms = {k: _scalar(v)
                       for k, v in (signal.get("param_norms") or {}).items()}
        fields.update(td_abs_mean=td_mean, per_topology_td=per_topo, **q,
                      grad_norms=grad_norms, param_norms=param_norms)
        if td_mean is not None:
            hub.gauge("td_abs_mean", td_mean)
        for name, v in per_topo.items():
            hub.gauge("td_abs_mean", v, topology=name)
        for k, v in q.items():
            if v is not None:
                hub.gauge(k, v)
        for name, v in grad_norms.items():
            if v is not None:
                hub.gauge("grad_norm", v, layer=name)
        for name, v in param_norms.items():
            if v is not None:
                hub.gauge("param_norm", v, layer=name)
    if replay is not None:
        fill = _host(replay["fill"]).astype(np.float64)
        fields["replay"] = {
            "size": _host(replay["size"]).tolist(),
            "fill": round(float(fill.mean()), 6),
            "age_mean_steps": round(float(
                _host(replay["age_mean_steps"]).mean()), 3),
        }
        hub.gauge("replay_fill", float(fill.mean()))
    return hub.event("learn_signal", **fields)


class LearnLedger:
    """The observer-owned facade: hands the trainer its static spec,
    remembers the topo-id -> name mapping, emits per-episode signals."""

    def __init__(self, hub):
        self.hub = hub
        self.segment_names: Optional[List[str]] = None
        self.episodes = 0

    def spec(self, num_topos: int,
             names: Optional[Sequence[str]] = None) -> LearnLedgerSpec:
        if names:
            self.segment_names = [str(n) for n in names]
        return LearnLedgerSpec.for_topos(num_topos)

    def episode(self, episode: int, signal: Optional[Dict] = None,
                replay: Optional[Dict] = None) -> Optional[Dict]:
        self.episodes += 1
        return emit_learn_signal(self.hub, episode, signal=signal,
                                 replay=replay,
                                 segment_names=self.segment_names)
