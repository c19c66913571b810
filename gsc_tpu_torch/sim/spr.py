"""Shortest-path-routing (SPR) per-flow heuristic: the example algorithm
of per-flow control, on the host.

The port of ``gsc_tpu.sim.spr``.  Decision rule per waiting flow (given
``PendingFlows``):

1. If the current node has ``dr`` worth of remaining capacity, process
   HERE (destination = current node; the engine's place-on-decision
   installs the SF if absent).
2. Otherwise pick the node with remaining capacity that minimises the
   shortest-path delay from the current node, preferring nodes where the
   SF is already available (no startup delay, no placement churn);
   unreachable nodes and nodes whose path exceeds the flow's TTL are
   excluded.
3. If no node qualifies, stay put: the engine then tries to process at
   the current node and records the NODE_CAP drop.

Host numpy on the ``PendingFlows`` network view; the on-device analogue is
``SimEngine.apply_per_flow`` with a policy on the device.
"""
from __future__ import annotations

import numpy as np

from .perflow import PendingFlows, PerFlowController
from .state import SimState


class ShortestPathAlgo:
    """Greedy nearest-capable-node per-flow algorithm (see module doc).

    ``prefer_running=True`` picks among the nodes where the needed SF is
    already available whenever one is reachable, and falls back to empty
    nodes only when none is."""

    def __init__(self, prefer_running: bool = True):
        self.prefer_running = prefer_running

    def decide(self, pending: PendingFlows) -> np.ndarray:
        """[K] destination node per pending flow (>= 0 always: rule 3 keeps
        an undecidable flow at its current node rather than parking it
        forever with -1)."""
        from ..topology.compiler import INF_DELAY

        k = len(pending)
        out = np.empty(k, np.int32)
        # decisions of one batch land in the same substep, so each routed
        # flow reserves its dr on a working copy
        node_rem = pending.node_remaining.copy()
        avail = pending.sf_available
        pd = pending.path_delay
        for i in range(k):
            cur = int(pending.node[i])
            sf = int(pending.sf[i])
            dr = float(pending.dr[i])
            fits = node_rem >= dr
            if fits[cur]:
                out[i] = cur
                node_rem[cur] -= dr
                continue
            # unreachable and padded pairs carry the finite INF_DELAY
            reach = (pd[cur] < INF_DELAY) & (pd[cur] <= pending.ttl[i])
            cand = fits & reach
            if self.prefer_running and (cand & avail[:, sf]).any():
                cand = cand & avail[:, sf]
            if cand.any():
                delays = np.where(cand, pd[cur], np.inf)
                out[i] = int(np.argmin(delays))
                node_rem[out[i]] -= dr
            else:
                out[i] = cur  # rule 3: the NODE_CAP drop
        return out


def run_spr_episode(controller: PerFlowController, state: SimState,
                    num_substeps: int, algo: ShortestPathAlgo = None
                    ) -> SimState:
    """Drive ``PerFlowController`` with ``ShortestPathAlgo`` until the
    simulated time reaches ``num_substeps`` engine substeps."""
    algo = algo or ShortestPathAlgo()
    dt = controller.engine.dt

    def substeps(st):
        return int(round(float(st.t[0]) / dt))

    while substeps(state) < num_substeps:
        state, pending = controller.run_until_decision(
            state, max_substeps=num_substeps - substeps(state))
        if not len(pending):
            break  # the budget ran out with nothing waiting
        if substeps(state) < num_substeps:
            state = controller.decide(state, pending, algo.decide(pending))
        else:
            break
    return state
