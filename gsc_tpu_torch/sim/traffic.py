"""Host-side traffic pre-generation -> TrafficSchedule tensors.

The port's own copy of ``gsc_tpu.sim.traffic``: the whole episode's
traffic (arrival times, rates, sizes, TTLs, SFC and egress choices,
per-interval ingress activity and node capacity, and for link faults the
per-interval edge capacity) is sampled on the host into one dense sorted
schedule that the engine consumes.

The flows come from the native sampler (``gsc_tpu_torch.native``, C++
built with g++ at first use), as in the JAX package; its build failing
raises.  ``GSC_TPU_NO_NATIVE=1`` picks the numpy loop below instead, the
plain path, as it does in the JAX package.  Either way the per-interval
means (the MMPP chain) are drawn first from numpy's generator, and one
seed gives byte-equal schedules to the JAX package's same path.  The two
paths draw in different orders, so they agree with each other only where
nothing is random (deterministic arrivals and sizes, one TTL, one SFC,
one egress).

- deterministic vs Poisson arrivals: inter-arrival = mean or Exp(mean);
  first flow at t=0;
- dr ~ Normal(dr_mean, dr_stdev); size = shape (deterministic) or
  Pareto(shape)+1; joint rejection-resampling of negatives;
- duration = size/dr * 1000 ms;
- SFC, egress and TTL are uniform choices;
- MMPP: per-ingress two-state Markov chain switching with probability
  ``switch_p`` at every ``run_duration`` boundary; the arrival mean
  follows the current state.  Initial state: ``init_state``, or random
  per ingress with ``rand_init_state``;
- trace: rows (time, node, inter_arrival_mean[, cap]) set a node's
  arrival mean from that time on; 'None' deactivates the ingress (it
  restarts at the start of the next interval a later row activates); a
  cap raises the node's capacity from that interval on;
- faults (``topology.scenarios.TopoFault``): node faults zero rows of the
  per-interval node capacities, link faults those of the per-interval
  edge capacities (``EdgeCapSchedule.edge_cap_t``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.schema import ServiceConfig, SimConfig
from ..native import generate_flows_native, native_disabled
from ..topology.compiler import Topology
from .state import TrafficSchedule, attach_edge_cap


def traffic_capacity(cfg: SimConfig, num_ingress: int, episode_steps: int,
                     pad_factor: float = 1.6) -> int:
    """Static upper bound on flows per episode (fixed shapes across
    episodes), rounded up to a multiple of 64."""
    horizon = episode_steps * cfg.run_duration
    mean = cfg.inter_arrival_mean
    if cfg.use_states:
        mean = min(s.inter_arr_mean for s in cfg.states)
    expected = horizon / max(mean, 1e-6) * max(num_ingress, 1)
    cap = int(expected * pad_factor) + 8 * max(num_ingress, 1)
    return ((cap + 63) // 64) * 64


class TraceEvents:
    """A parsed trace CSV (time,node,inter_arrival_mean[,cap])."""

    def __init__(self, rows: Sequence[Tuple[float, int, Optional[float],
                                            Optional[float]]]):
        # each row: (time, node index, inter_arrival_mean or None, cap or None)
        self.rows = sorted(rows, key=lambda r: r[0])

    @classmethod
    def from_csv(cls, path: str, node_name_to_idx) -> "TraceEvents":
        import csv

        rows = []
        with open(path) as f:
            for rec in csv.DictReader(f):
                t = float(rec["time"])
                idx = node_name_to_idx(rec["node"])
                mean_raw = rec.get("inter_arrival_mean")
                mean = (None if mean_raw in (None, "", "None")
                        else float(mean_raw))
                cap = rec.get("cap")
                cap = None if cap in (None, "", "None") else float(cap)
                rows.append((t, idx, mean, cap))
        return cls(rows)


def _mmpp_interval_means(cfg: SimConfig, ing_idx: np.ndarray, steps: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Per-(interval, ingress) arrival means of the two-state chain: the
    state switches at the end of every interval with the current state's
    probability."""
    names = [s.name for s in cfg.states]
    means = {s.name: s.inter_arr_mean for s in cfg.states}
    switch = {s.name: s.switch_p for s in cfg.states}
    n_ing = len(ing_idx)
    if cfg.rand_init_state:
        cur = [names[rng.integers(len(names))] for _ in range(n_ing)]
    else:
        cur = [cfg.init_state] * n_ing
    out = np.zeros((steps, n_ing), np.float64)
    for t in range(steps):
        out[t] = [means[c] for c in cur]
        cur = [(names[1 - names.index(c)] if rng.random() < switch[c]
                else c) for c in cur]
    return out


def generate_traffic(cfg: SimConfig, service: ServiceConfig, topo: Topology,
                     episode_steps: int, seed: int,
                     trace: Optional[TraceEvents] = None,
                     capacity: Optional[int] = None, faults: Sequence = (),
                     with_edge_cap: bool = False) -> TrafficSchedule:
    """Sample one episode of traffic for one (unbatched) topology.
    ``faults`` (``TopoFault``s) zero node or link capacities from their
    interval on; ``with_edge_cap`` attaches the edge table even without a
    link fault, so that the schedules of a mixed batch stack."""
    rng = np.random.default_rng(seed)
    n = topo.max_nodes
    node_cap = topo.node_cap.cpu().numpy()
    node_mask = topo.node_mask.cpu().numpy()
    ing_mask = topo.is_ingress.cpu().numpy() & node_mask
    eg_idx = np.nonzero(topo.is_egress.cpu().numpy() & node_mask)[0]
    ing_idx = np.nonzero(ing_mask)[0]
    sfc_ids = np.arange(len(service.sfc_names))
    horizon = episode_steps * cfg.run_duration

    means = np.full((episode_steps, n), np.nan)
    if cfg.use_states and len(ing_idx):
        means[:, ing_idx] = _mmpp_interval_means(cfg, ing_idx, episode_steps,
                                                 rng)
    else:
        means[:, ing_idx] = cfg.inter_arrival_mean
    caps = np.broadcast_to(node_cap, (episode_steps, n)).copy()
    if trace is not None:
        for (t0, node, mean, cap) in trace.rows:
            k0 = min(int(t0 // cfg.run_duration), episode_steps)
            if node in ing_idx:
                means[k0:, node] = np.nan if mean is None else mean
            if cap is not None:
                caps[k0:, node] = cap
    active = ~np.isnan(means)

    edge_cap_t = None
    if faults or with_edge_cap:
        from ..topology.scenarios import apply_faults
        caps, edge_cap_t = apply_faults(topo, caps, episode_steps, faults,
                                        with_edge_cap)

    cap_f = capacity if capacity is not None else traffic_capacity(
        cfg, len(ing_idx), episode_steps)

    if not native_disabled():
        flows = generate_flows_native(
            seed=seed, means=means, run_duration=cfg.run_duration,
            dr_mean=cfg.flow_dr_mean, dr_stdev=cfg.flow_dr_stdev,
            size_shape=cfg.flow_size_shape,
            det_arrival=cfg.deterministic_arrival,
            det_size=cfg.deterministic_size,
            ttl_choices=np.asarray(cfg.ttl_choices), n_sfcs=len(sfc_ids),
            egress_nodes=eg_idx, capacity=cap_f)
        return _schedule(flows, np.arange(len(flows[0])), cap_f, active,
                         caps, edge_cap_t)

    times: List[float] = []
    ingress: List[int] = []
    drs: List[float] = []
    durs: List[float] = []
    ttls: List[float] = []
    sfcs: List[int] = []
    egs: List[int] = []

    def sample_dr_size() -> Tuple[float, float]:
        while True:
            dr = rng.normal(cfg.flow_dr_mean, cfg.flow_dr_stdev)
            if cfg.deterministic_size:
                size = cfg.flow_size_shape
            else:
                size = rng.pareto(cfg.flow_size_shape) + 1
            if dr >= 0.0 and size >= 0.0:
                return float(dr), float(size)

    for node in ing_idx:
        t = 0.0
        while t < horizon:
            k = int(t // cfg.run_duration)
            mean = means[k, node]
            if math.isnan(mean):
                # deactivated: jump to the next interval a later trace
                # row activates, if any
                nxt = np.nonzero(active[k:, node])[0]
                if len(nxt) == 0:
                    break
                t = float((k + nxt[0]) * cfg.run_duration)
                continue
            # flow generated first, then the inter-arrival sleep
            dr, size = sample_dr_size()
            dur = (size / dr) * 1000.0 if dr > 0 else 0.0
            times.append(t)
            ingress.append(int(node))
            drs.append(dr)
            durs.append(dur)
            ttls.append(float(cfg.ttl_choices[rng.integers(len(cfg.ttl_choices))]))
            sfcs.append(int(sfc_ids[rng.integers(len(sfc_ids))]))
            egs.append(int(eg_idx[rng.integers(len(eg_idx))]) if len(eg_idx) else -1)
            if cfg.deterministic_arrival:
                t += mean
            else:
                t += rng.exponential(mean)

    order = np.argsort(np.asarray(times, np.float64), kind="stable")
    if len(order) > cap_f:
        order = order[:cap_f]
    return _schedule((times, ingress, drs, durs, ttls, sfcs, egs), order,
                     cap_f, active, caps, edge_cap_t)


def _schedule(flows, order: np.ndarray, cap_f: int, active: np.ndarray,
              caps: np.ndarray, edge_cap_t) -> TrafficSchedule:
    """Pad the flow records (times, ingress, drs, durs, ttls, sfcs, egs),
    taken in ``order``, to ``cap_f`` slots as float32 / int32."""
    f = len(order)

    def pad_f(vals, fill, dtype):
        out = np.full(cap_f, fill, dtype)
        if f:
            out[:f] = np.asarray(vals, dtype)[order]
        return torch.from_numpy(out)

    times, ingress, drs, durs, ttls, sfcs, egs = flows
    return attach_edge_cap(TrafficSchedule(
        arr_time=pad_f(times, np.inf, np.float32),
        arr_ingress=pad_f(ingress, 0, np.int32),
        arr_dr=pad_f(drs, 0.0, np.float32),
        arr_duration=pad_f(durs, 0.0, np.float32),
        arr_ttl=pad_f(ttls, 0.0, np.float32),
        arr_sfc=pad_f(sfcs, 0, np.int32),
        arr_egress=pad_f(egs, -1, np.int32),
        ingress_active=torch.from_numpy(active),
        node_cap=torch.from_numpy(caps.astype(np.float32)),
    ), edge_cap_t)
