"""Host-side traffic pre-generation -> TrafficSchedule tensors.

The port's own copy of the numpy path of ``gsc_tpu.sim.traffic``: the
whole episode's traffic (arrival times, rates, sizes, TTLs, SFC and
egress choices, per-interval ingress activity and node capacity) is
sampled on the host with numpy into one dense sorted schedule that the
engine consumes.  The random draws come in the same order as the JAX
package's numpy path, so one seed gives byte-equal schedules.

- deterministic vs Poisson arrivals: inter-arrival = mean or Exp(mean);
  first flow at t=0;
- dr ~ Normal(dr_mean, dr_stdev); size = shape (deterministic) or
  Pareto(shape)+1; joint rejection-resampling of negatives;
- duration = size/dr * 1000 ms;
- SFC, egress and TTL are uniform choices.

The MMPP, trace and fault options of the JAX package are not ported.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config.schema import ServiceConfig, SimConfig
from ..topology.compiler import Topology
from .state import TrafficSchedule


def traffic_capacity(cfg: SimConfig, num_ingress: int, episode_steps: int,
                     pad_factor: float = 1.6) -> int:
    """Static upper bound on flows per episode (fixed shapes across
    episodes), rounded up to a multiple of 64."""
    horizon = episode_steps * cfg.run_duration
    mean = cfg.inter_arrival_mean
    expected = horizon / max(mean, 1e-6) * max(num_ingress, 1)
    cap = int(expected * pad_factor) + 8 * max(num_ingress, 1)
    return ((cap + 63) // 64) * 64


def generate_traffic(cfg: SimConfig, service: ServiceConfig, topo: Topology,
                     episode_steps: int, seed: int,
                     capacity: Optional[int] = None) -> TrafficSchedule:
    """Sample one episode of traffic for one (unbatched) topology."""
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
    means[:, ing_idx] = cfg.inter_arrival_mean
    caps = np.broadcast_to(node_cap, (episode_steps, n)).copy()
    active = ~np.isnan(means)

    cap_f = capacity if capacity is not None else traffic_capacity(
        cfg, len(ing_idx), episode_steps)

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
            mean = means[int(t // cfg.run_duration), node]
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
    f = len(order)
    if f > cap_f:
        order = order[:cap_f]
        f = cap_f

    def pad_f(vals, fill, dtype):
        out = np.full(cap_f, fill, dtype)
        if f:
            out[:f] = np.asarray(vals, dtype)[order]
        return torch.from_numpy(out)

    return TrafficSchedule(
        arr_time=pad_f(times, np.inf, np.float32),
        arr_ingress=pad_f(ingress, 0, np.int32),
        arr_dr=pad_f(drs, 0.0, np.float32),
        arr_duration=pad_f(durs, 0.0, np.float32),
        arr_ttl=pad_f(ttls, 0.0, np.float32),
        arr_sfc=pad_f(sfcs, 0, np.int32),
        arr_egress=pad_f(egs, -1, np.int32),
        ingress_active=torch.from_numpy(active),
        node_cap=torch.from_numpy(caps.astype(np.float32)),
    )
