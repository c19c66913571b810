"""Debug utilities: simulator invariant checks and the profiler.

The port of ``gsc_tpu.utils.debug``.  ``check_invariants`` reads one
replica's ``SimState`` on the host and lists the conservation laws it
breaks (non-negative loads, link usage within capacity, flow phases and
positions in range, generated = processed + dropped + active, drop
reasons summing to drops, WRR counts below 2^24, late arrivals).
``Profiler`` wraps ``torch.profiler`` (CPU and, with a card, CUDA
activity) and writes a Chrome trace to ``<log_dir>/trace.json``.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from ..sim.state import PH_DECIDE, PH_FREE, PH_HOP, PH_PROC, SimState
from ..topology.compiler import Topology


def _np(t, replica: int):
    return np.asarray(t[replica].detach().cpu())


def check_invariants(state: SimState, topo: Topology,
                     chain_len: np.ndarray, tol: float = 1e-3,
                     replica: int = 0) -> List[str]:
    """The invariants replica ``replica`` of ``state`` violates (empty:
    healthy); ``topo`` is shared or carries the batch dim."""
    errs = []
    f = state.flows
    m = state.metrics
    phase = _np(f.phase, replica)
    t_of = (lambda x: np.asarray(x.detach().cpu())) \
        if topo.edge_cap.dim() == 1 else (lambda x: _np(x, replica))
    edge_cap, edge_mask = t_of(topo.edge_cap), t_of(topo.edge_mask)
    edge_used = _np(state.edge_used, replica)
    if (_np(state.node_load, replica) < -tol).any():
        errs.append("negative node_load")
    if (edge_used < -tol).any():
        errs.append("negative edge_used")
    if ((edge_used > edge_cap + tol) & edge_mask).any():
        errs.append("edge_used exceeds edge capacity")
    if not np.isin(phase, [PH_FREE, PH_DECIDE, PH_HOP, PH_PROC]).all():
        errs.append("invalid flow phase")
    active = phase != PH_FREE
    pos = _np(f.position, replica)[active]
    cl = np.asarray(chain_len)[_np(f.sfc, replica)[active]]
    if (pos < 0).any() or (pos > cl).any():
        errs.append("flow position outside chain")
    nodes = _np(f.node, replica)[active]
    if len(nodes) and (nodes >= topo.max_nodes).any():
        errs.append("flow at out-of-range node")
    if (_np(f.ttl, replica)[active] < -tol).any():
        errs.append("active flow with negative TTL")
    gen, proc = int(m.generated[replica]), int(m.processed[replica])
    drop, act = int(m.dropped[replica]), int(m.active[replica])
    if gen != proc + drop + act:
        errs.append(f"metrics mismatch: generated={gen} != "
                    f"processed+dropped+active={proc + drop + act}")
    if act != int(active.sum()):
        errs.append(f"active count mismatch: metrics={act} "
                    f"table={int(active.sum())}")
    if drop != int(_np(m.drop_reasons, replica).sum()):
        errs.append("drop_reasons do not sum to dropped")
    if int(_np(m.run_flow_counts, replica).max()) >= 2 ** 24:
        errs.append("run_flow_counts >= 2^24 (f32 one-hot dots lose "
                    "integer exactness)")
    trunc = int(state.truncated_arrivals[replica])
    if trunc > 0:
        errs.append(
            f"{trunc} arrivals admitted late (flow-table slot exhaustion)")
    return errs


class Profiler:
    """A ``torch.profiler`` session over a ``with`` block; the Chrome
    trace goes to ``<log_dir>/trace.json``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._prof = None

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    @property
    def trace_path(self) -> str:
        return os.path.join(self.log_dir, "trace.json")

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof.export_chrome_trace(self.trace_path)
            self._prof = None
        return False
