"""Per-flow control: a host-driven controller over the engine.

The port of ``gsc_tpu.sim.perflow``.  Instead of one (placement,
schedule) action per control interval, an external algorithm decides each
waiting flow's next node.  ``SimEngine.apply_substep(state, ...,
ext_decisions)`` parks a flow that reaches a decision point in the DECIDE
phase until a decision comes (at the next substep).  Two ways to drive it:

- ``PerFlowController`` (this module): a host loop that advances substeps
  until flows wait, hands them over as a ``PendingFlows`` record with the
  network view, and applies the caller's decisions.  It drives one
  replica (B = 1), and the record's fields have no batch dim.  Polling the
  flows' phase every substep is a device-to-host read on the card: it is
  the algorithm's interface, as in the JAX loop.
- ``SimEngine.apply_per_flow(state, topo, traffic, decide_fn)``: a policy
  on the device (``local_decisions``: process where the flow is), called
  before every substep, one kernel launch each.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..topology.compiler import Topology
from .engine import SimEngine
from .state import PH_DECIDE, SimState, TrafficSchedule


@dataclass
class PendingFlows:
    """Flows waiting for an external decision and the network view.

    Per-flow fields are [K] over the waiting flows; network-view fields are
    full-size ([N]/[E]/[N, P]) snapshots at the current substep."""

    slots: np.ndarray      # [K] flow-table slot indices
    node: np.ndarray       # [K] current node
    sfc: np.ndarray        # [K]
    position: np.ndarray   # [K] chain position
    sf: np.ndarray         # [K] SF id needed next (chain_sf[sfc, position])
    dr: np.ndarray         # [K]
    ttl: np.ndarray        # [K]
    egress: np.ndarray     # [K] egress node (-1: none)
    t: float               # current sim time (ms)
    node_cap: np.ndarray       # [N] current interval node capacities
    node_remaining: np.ndarray  # [N] cap minus current processed load
    edge_cap: np.ndarray       # [E]
    edge_remaining: np.ndarray  # [E] cap minus in-flight dr
    sf_available: np.ndarray   # [N, P] bool: SF placed or still draining
    path_delay: np.ndarray     # [N, N] all-pairs shortest path delay (ms)
    network_stats: dict        # in_network/processed/dropped totals

    def __len__(self):
        return len(self.slots)


def local_decisions(state: SimState) -> torch.Tensor:
    """The local per-flow policy, on the state's device: every deciding
    flow processes at its current node, [B, M] i32 (-1: no decision)."""
    f = state.flows
    return torch.where(f.phase == PH_DECIDE, f.node, -1).to(torch.int32)


def _host(t: torch.Tensor) -> np.ndarray:
    """Replica 0 of a batched tensor, on the host."""
    return t[0].detach().cpu().numpy()


class PerFlowController:
    """Host-side per-flow control loop over one replica.  ``generator``
    draws the processing-delay noise of each substep where the delays are
    stochastic; ``writer`` (a ``TestModeWriter`` with
    ``write_flow_actions``) logs every decision."""

    def __init__(self, engine: SimEngine, topo: Topology,
                 traffic: TrafficSchedule, writer=None, episode: int = 0,
                 generator: Optional[torch.Generator] = None):
        if not engine.det_proc and generator is None:
            raise ValueError("stochastic processing delays need a "
                             "generator for their noise")
        self.engine = engine
        self.topo = topo.expand(1)
        self.traffic = traffic.expand(1)
        self.device = self.topo.node_cap.device
        self._none = torch.full((1, engine.M), -1, dtype=torch.int32,
                                device=self.device)
        self.writer = writer
        self.episode = episode
        self.generator = generator

    def _step(self, state: SimState, decisions: torch.Tensor) -> SimState:
        noise = self.engine.draw_noise(1, self.generator, self.device,
                                       substeps=1)
        return self.engine.apply_substep(
            state, self.topo, self.traffic, decisions,
            None if noise is None else noise[:, 0])

    def _network_view(self, state: SimState):
        """Current-interval capacity snapshot: (node_cap, node_remaining,
        edge_cap, edge_remaining)."""
        caps = _host(self.traffic.node_cap)
        node_cap = caps[min(int(state.run_idx[0]), caps.shape[0] - 1)]
        node_rem = node_cap - _host(state.node_load).sum(axis=-1)
        edge_cap = _host(self.topo.edge_cap)
        edge_rem = edge_cap - _host(state.edge_used)
        return node_cap, node_rem, edge_cap, edge_rem

    def _waiting_slots(self, state: SimState) -> np.ndarray:
        """Slot indices of flows parked in DECIDE that need an SF (egress
        routing stays automatic); reads the flow arrays only."""
        f = state.flows
        waiting = _host(f.phase) == PH_DECIDE
        chain_len = self.engine.tables.chain_len[_host(f.sfc)]
        return np.nonzero(waiting & (_host(f.position) < chain_len))[0]

    def _pending(self, state: SimState) -> PendingFlows:
        f = state.flows
        tables = self.engine.tables
        slots = self._waiting_slots(state)
        sfc_all = _host(f.sfc)
        pos_all = _host(f.position)
        chain_len = tables.chain_len[sfc_all]
        sfc = sfc_all[slots]
        pos = pos_all[slots]
        node_cap, node_rem, edge_cap, edge_rem = self._network_view(state)
        m = state.metrics
        return PendingFlows(
            slots=slots, node=_host(f.node)[slots], sfc=sfc, position=pos,
            sf=tables.chain_sf[sfc, np.minimum(pos, chain_len[slots] - 1)],
            dr=_host(f.dr)[slots], ttl=_host(f.ttl)[slots],
            egress=_host(f.egress)[slots],
            t=float(state.t[0]),
            node_cap=node_cap, node_remaining=node_rem,
            edge_cap=edge_cap, edge_remaining=edge_rem,
            sf_available=_host(state.sf_available),
            path_delay=_host(self.topo.path_delay),
            network_stats={
                "total_flows": int(m.generated[0]),
                "successful_flows": int(m.processed[0]),
                "dropped_flows": int(m.dropped[0]),
                "in_network_flows": int(m.active[0]),
            })

    def run_until_decision(self, state: SimState, max_substeps: int = 10_000
                           ) -> tuple[SimState, PendingFlows]:
        """Advance substeps until at least one flow waits for a decision or
        the budget of substeps is spent."""
        for _ in range(max_substeps):
            if len(self._waiting_slots(state)):
                return state, self._pending(state)
            state = self._step(state, self._none)
        return state, self._pending(state)

    def decide(self, state: SimState, pending: PendingFlows,
               destinations: np.ndarray) -> SimState:
        """Apply the algorithm's decisions (a destination node per pending
        flow; -1 leaves a flow waiting) and advance one substep."""
        dec = np.full(self.engine.M, -1, np.int32)
        dec[pending.slots] = destinations
        if self.writer is not None:
            self._log_decisions(pending, destinations)
        return self._step(state, torch.from_numpy(dec)[None].to(self.device))

    def _log_decisions(self, pending: PendingFlows,
                       destinations: np.ndarray) -> None:
        # the pending record holds the deciding state's network view
        node_rem = pending.node_remaining
        edge_cap = pending.edge_cap
        edge_rem = pending.edge_remaining
        adj = _host(self.topo.adj_edge_id)
        for i, slot in enumerate(pending.slots):
            dest = int(destinations[i])
            cur = int(pending.node[i])
            if dest < 0:
                dst_repr, next_rem, lcap, lrem = "None", -1, -1, -1
            elif dest == cur:
                dst_repr, next_rem = dest, node_rem[dest]
                lcap = lrem = "inf"  # same node: no link
            else:
                eid = int(adj[cur, dest])
                dst_repr, next_rem = dest, node_rem[dest]
                lcap = edge_cap[eid] if eid >= 0 else -1
                lrem = edge_rem[eid] if eid >= 0 else -1
            self.writer.write_flow_action(
                self.episode, pending.t, int(slot),
                float(pending.ttl[i]), float(pending.ttl[i]), cur, dst_repr,
                node_rem[cur], next_rem, lcap, lrem)
