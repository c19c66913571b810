"""A fake simulator backend: the canned-metrics engine.

The port of ``gsc_tpu.sim.dummy``.  ``DummyEngine`` keeps ``SimEngine``'s
``init``/``apply`` signatures and shapes but fabricates the same metrics
every interval instead of simulating: 10 generated, 8 processed, 2
dropped (node capacity), 20 ms average end-to-end delay, requested
traffic 1 at every real ingress, processed traffic 0.5 wherever an SF is
placed.  It is a drop-in engine for ``ServiceCoordEnv(engine=...)``, on
the card and on the CPU, with no kernel: the RL stack runs without the
simulator.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..topology.compiler import Topology
from .engine import SimEngine
from .state import SimMetrics, SimState, TrafficSchedule


class DummyEngine(SimEngine):
    """Canned-state fake with the SimEngine contract."""

    GENERATED = 10
    PROCESSED = 8
    DROPPED = 2
    AVG_E2E = 20.0

    def apply(self, state: SimState, topo: Topology, traffic: TrafficSchedule,
              schedule: torch.Tensor, placement: torch.Tensor,
              noise: Optional[torch.Tensor] = None
              ) -> Tuple[SimState, SimMetrics]:
        b = state.batch
        topo = topo.expand(b)
        m = state.metrics.reset_run()
        full = lambda v, like: torch.full_like(like, v)
        # canned traffic at the real ingress nodes, so that observations
        # are not empty
        ing = (topo.is_ingress & topo.node_mask).to(torch.float32)  # [B, N]
        req = torch.zeros_like(m.run_requested)
        req[:, :, :, 0] = ing[:, :, None]      # each chain's entry point
        e2e = self.AVG_E2E * self.PROCESSED
        reasons = m.drop_reasons.clone()
        reasons[:, 3] += self.DROPPED
        m = m.replace(
            generated=m.generated + self.GENERATED,
            processed=m.processed + self.PROCESSED,
            dropped=m.dropped + self.DROPPED,
            drop_reasons=reasons,
            run_generated=full(self.GENERATED, m.run_generated),
            run_processed=full(self.PROCESSED, m.run_processed),
            run_dropped=full(self.DROPPED, m.run_dropped),
            run_e2e_sum=full(e2e, m.run_e2e_sum),
            run_e2e_max=full(self.AVG_E2E, m.run_e2e_max),
            sum_e2e=m.sum_e2e + e2e,
            run_requested=req, run_requested_node=ing,
            run_processed_traffic=placement.to(torch.float32) * 0.5)
        state = state.replace(t=state.t + self.cfg.run_duration,
                              run_idx=state.run_idx + 1, placed=placement,
                              schedule=schedule, metrics=m)
        return state, m
