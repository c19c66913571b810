"""Simulator state: dataclasses of tensors.

The port of ``gsc_tpu.sim.state``.  Where the JAX package vmaps one
replica's state, every tensor here carries a written-out leading batch dim
[B] of env replicas: ``FlowTable`` is [B, M] flow slots, ``SimMetrics``
holds [B]-shaped counters, and ``SimState`` the per-(node, SF) bookkeeping,
schedule, in-flight edge load and capacity-release rings of each replica.
``TrafficSchedule`` is shared by all replicas or carries its own [B] dim.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..utils.tree import TensorTree

# Flow phases.
PH_FREE = 0     # slot unused
PH_DECIDE = 1   # at a node, waiting for a next-node decision this substep
PH_HOP = 2      # traversing an edge (timer = remaining hop delay)
PH_PROC = 3     # processing at an SF (timer = startup wait + processing delay)

# Drop reasons.
DROP_TTL = 0
DROP_DECISION = 1
DROP_LINK_CAP = 2
DROP_NODE_CAP = 3
DROP_REASONS = ("TTL", "DECISION", "LINK_CAP", "NODE_CAP")

_I32 = torch.int32
_F32 = torch.float32


@dataclass
class FlowTable(TensorTree):
    """Preallocated flow slots [B, M]."""

    phase: torch.Tensor      # i32 PH_*
    sfc: torch.Tensor        # i32
    position: torch.Tensor   # i32 index into the SFC chain; == chain_len -> to egress
    node: torch.Tensor       # i32 current node
    dest: torch.Tensor       # i32 decided destination node (while forwarding)
    hop_next: torch.Tensor   # i32 node at the end of the in-flight hop
    egress: torch.Tensor     # i32 egress node id or -1
    dr: torch.Tensor         # f32 data rate
    duration: torch.Tensor   # f32 flow duration in ms
    ttl: torch.Tensor        # f32 remaining TTL in ms
    e2e: torch.Tensor        # f32 accumulated end-to-end delay
    pend_path: torch.Tensor  # f32 path delay of the in-flight path, credited on arrival
    timer: torch.Tensor      # f32 remaining time in current phase

    @classmethod
    def empty(cls, batch: int, max_flows: int, device) -> "FlowTable":
        zi = lambda: torch.zeros(batch, max_flows, dtype=_I32, device=device)
        zf = lambda: torch.zeros(batch, max_flows, dtype=_F32, device=device)
        return cls(phase=zi(), sfc=zi(), position=zi(), node=zi(), dest=zi(),
                   hop_next=zi(), egress=zi() - 1, dr=zf(), duration=zf(),
                   ttl=zf(), e2e=zf(), pend_path=zf(), timer=zf())


@dataclass
class SimMetrics(TensorTree):
    """Counters.  ``run_*`` fields reset at the start of every control
    interval; the rest accumulate over the episode.  Shapes below are per
    replica, after the leading [B]."""

    generated: torch.Tensor          # [] i32
    processed: torch.Tensor          # [] i32
    dropped: torch.Tensor            # [] i32
    active: torch.Tensor             # [] i32
    drop_reasons: torch.Tensor       # [4] i32 (TTL, DECISION, LINK_CAP, NODE_CAP)
    sum_proc_delay: torch.Tensor     # [] f32
    num_proc_delay: torch.Tensor     # [] i32
    sum_path_delay: torch.Tensor     # [] f32
    num_path_delay: torch.Tensor     # [] i32
    sum_e2e: torch.Tensor            # [] f32 (over processed flows)
    run_generated: torch.Tensor      # [] i32
    run_processed: torch.Tensor      # [] i32
    run_dropped: torch.Tensor        # [] i32
    run_dropped_per_node: torch.Tensor   # [N] i32
    run_e2e_sum: torch.Tensor        # [] f32
    run_e2e_max: torch.Tensor        # [] f32
    run_path_delay_sum: torch.Tensor  # [] f32
    run_requested: torch.Tensor      # [N,C,S_pos] f32
    run_requested_node: torch.Tensor  # [N] f32
    run_processed_traffic: torch.Tensor  # [N,P] f32
    run_flow_counts: torch.Tensor    # [N,C,S_pos,N] i32 (WRR state)
    run_max_node_usage: torch.Tensor  # [N] f32
    run_passed_traffic: torch.Tensor  # [E] f32

    _RUN_FIELDS = ("run_generated", "run_processed", "run_dropped",
                   "run_dropped_per_node", "run_e2e_sum", "run_e2e_max",
                   "run_path_delay_sum", "run_requested",
                   "run_requested_node", "run_processed_traffic",
                   "run_flow_counts", "run_max_node_usage",
                   "run_passed_traffic")

    @classmethod
    def zeros(cls, batch: int, n: int, c: int, s: int, e: int, p: int,
              device) -> "SimMetrics":
        i = lambda *shape: torch.zeros((batch,) + shape, dtype=_I32,
                                       device=device)
        f = lambda *shape: torch.zeros((batch,) + shape, dtype=_F32,
                                       device=device)
        return cls(
            generated=i(), processed=i(), dropped=i(), active=i(),
            drop_reasons=i(4), sum_proc_delay=f(), num_proc_delay=i(),
            sum_path_delay=f(), num_path_delay=i(), sum_e2e=f(),
            run_generated=i(), run_processed=i(), run_dropped=i(),
            run_dropped_per_node=i(n), run_e2e_sum=f(), run_e2e_max=f(),
            run_path_delay_sum=f(), run_requested=f(n, c, s),
            run_requested_node=f(n), run_processed_traffic=f(n, p),
            run_flow_counts=i(n, c, s, n), run_max_node_usage=f(n),
            run_passed_traffic=f(e),
        )

    def reset_run(self) -> "SimMetrics":
        """Per-interval reset of the ``run_*`` counters."""
        return self.replace(**{k: torch.zeros_like(getattr(self, k))
                               for k in self._RUN_FIELDS})

    def avg_e2e(self) -> torch.Tensor:
        """Cumulative end-to-end delay over the processed flows."""
        return torch.where(self.processed > 0,
                           self.sum_e2e / self.processed.clamp(min=1),
                           torch.zeros_like(self.sum_e2e))

    def run_avg_e2e(self) -> torch.Tensor:
        return torch.where(self.run_processed > 0,
                           self.run_e2e_sum / self.run_processed.clamp(min=1),
                           torch.zeros_like(self.run_e2e_sum))


@dataclass
class TrafficSchedule(TensorTree):
    """Pre-generated per-episode traffic, sorted by arrival time.  Fields
    are [F] / [T, N] for a schedule shared by every replica, or carry a
    leading [B]."""

    arr_time: torch.Tensor     # [F] f32, ascending (inf for padding)
    arr_ingress: torch.Tensor  # [F] i32
    arr_dr: torch.Tensor       # [F] f32
    arr_duration: torch.Tensor  # [F] f32
    arr_ttl: torch.Tensor      # [F] f32
    arr_sfc: torch.Tensor      # [F] i32
    arr_egress: torch.Tensor   # [F] i32 (-1: none)
    ingress_active: torch.Tensor  # [T, N] bool per control interval
    node_cap: torch.Tensor     # [T, N] f32 per control interval

    _RANKS = {"arr_time": 1, "arr_ingress": 1, "arr_dr": 1,
              "arr_duration": 1, "arr_ttl": 1, "arr_sfc": 1,
              "arr_egress": 1, "ingress_active": 2, "node_cap": 2}

    @property
    def capacity(self) -> int:
        return self.arr_time.shape[-1]


@dataclass
class SimState(TensorTree):
    """Complete per-episode simulator state, leading dim [B]."""

    t: torch.Tensor            # [] f32 current sim time (ms)
    run_idx: torch.Tensor      # [] i32 control intervals completed
    flows: FlowTable           # [M] slots
    cursor: torch.Tensor       # [] i32 next unconsumed traffic record
    node_load: torch.Tensor    # [N,P] f32 current processed load
    sf_available: torch.Tensor  # [N,P] bool placed or still draining
    sf_startup: torch.Tensor   # [N,P] f32 startup_time of the instance
    sf_last_active: torch.Tensor  # [N,P] f32 last time the instance had load
    placed: torch.Tensor       # [N,P] bool current placement action
    schedule: torch.Tensor     # [N,C,S,N] f32 current scheduling weights
    edge_used: torch.Tensor    # [E] f32 in-flight dr per undirected edge
    rel_node: torch.Tensor     # [H,N*P] f32 node-load release ring
    rel_edge: torch.Tensor     # [H,E] f32 edge-load release ring
    metrics: SimMetrics
    truncated_arrivals: torch.Tensor  # [] i32 arrivals admitted late

    @property
    def batch(self) -> int:
        return self.t.shape[0]


def init_state(batch: int, max_flows: int, n: int, c: int, s: int, e: int,
               horizon: int, p: Optional[int] = None,
               device="cpu") -> SimState:
    if p is None:
        p = s
    zf = lambda *shape: torch.zeros((batch,) + shape, dtype=_F32,
                                    device=device)
    zb = lambda *shape: torch.zeros((batch,) + shape, dtype=torch.bool,
                                    device=device)
    return SimState(
        t=zf(),
        run_idx=torch.zeros(batch, dtype=_I32, device=device),
        flows=FlowTable.empty(batch, max_flows, device),
        cursor=torch.zeros(batch, dtype=_I32, device=device),
        node_load=zf(n, p), sf_available=zb(n, p), sf_startup=zf(n, p),
        sf_last_active=zf(n, p), placed=zb(n, p),
        schedule=zf(n, c, s, n), edge_used=zf(e),
        rel_node=zf(horizon, n * p), rel_edge=zf(horizon, e),
        metrics=SimMetrics.zeros(batch, n, c, s, e, p, device),
        truncated_arrivals=torch.zeros(batch, dtype=_I32, device=device),
    )
