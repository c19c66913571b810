"""Phase timing of the training loop, and the test-mode CSV telemetry
with the reference writer's files and headers.

``PhaseTimer``, ``phase_span`` and ``episode_span`` port
``gsc_tpu.utils.telemetry.PhaseTimer`` and ``gsc_tpu.obs.trace``'s two
spans: host wall time per
named phase of the episode loop (``host_sample``, ``host_sample_wait``,
``dispatch``, ``drain``), each span also a ``torch.profiler`` range and
the hub's last-phase record (what a stall event reports being stuck in).

``TestModeWriter`` ports ``gsc_tpu.utils.telemetry.TestModeWriter``: greedy evaluation
(``Trainer.evaluate(telemetry=True)``) writes one row set per control
interval to ``placements.csv``, ``node_metrics.csv``, ``metrics.csv``,
``run_flows.csv``, ``runtimes.csv``, ``drop_reasons.csv``,
``rl_state.csv`` (no header) and, when asked, ``scheduling.csv`` and
``flow_actions.csv`` (one row per per-flow decision, written by
``sim.perflow.PerFlowController`` through ``write_flow_action``).  Values
arrive as host arrays of one replica, so each cell is written as the JAX
package writes it.
"""
from __future__ import annotations

import csv
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional, Sequence

import numpy as np

from ..sim.state import DROP_REASONS


class PhaseTimer:
    """Host wall seconds per named phase, accumulated under a lock."""

    def __init__(self):
        self._total: Dict[str, float] = {}   # guarded-by: self._lock
        self._count: Dict[str, int] = {}     # guarded-by: self._lock
        self._lock = threading.Lock()

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        with self._lock:
            self._total[name] = self._total.get(name, 0.0) + seconds
            self._count[name] = self._count.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{phase: {total_s, count, mean_ms}} over everything recorded."""
        with self._lock:
            totals = dict(self._total)
            counts = dict(self._count)
        return {
            name: {"total_s": round(t, 4), "count": counts[name],
                   "mean_ms": round(1e3 * t / max(counts[name], 1), 3)}
            for name, t in sorted(totals.items())
        }


@contextmanager
def phase_span(name: str, timer: Optional[PhaseTimer] = None, hub=None):
    """One pipeline phase: a ``torch.profiler`` range, the ``timer``'s
    accumulation and the hub's last-phase record."""
    import torch

    if hub is not None:
        hub.note_phase(name, done=False)
    with torch.profiler.record_function(name):
        try:
            if timer is not None:
                with timer.phase(name):
                    yield
            else:
                yield
        finally:
            if hub is not None:
                hub.note_phase(name, done=True)


@contextmanager
def episode_span(step: int, name: str = "episode_step"):
    """Step marker around one episode's dispatch: a ``torch.profiler``
    range named ``<name> <step>``, so a trace attributes device time per
    episode."""
    import torch

    with torch.profiler.record_function(f"{name} {int(step)}"):
        yield


class TestModeWriter:
    """The reference's test-mode CSV suite, every file flushed after each
    control interval."""

    __test__ = False   # not a pytest class, whatever its name

    def __init__(self, test_dir: str, write_schedule: bool = False,
                 sf_names: Sequence[str] = (), sfc_names: Sequence[str] = (),
                 write_flow_actions: bool = False):
        os.makedirs(test_dir, exist_ok=True)
        self.sf_names = list(sf_names)
        self.sfc_names = list(sfc_names)
        self.write_schedule = write_schedule
        self.write_flow_actions = write_flow_actions
        self._closed = False
        self._files = {}
        self._writers = {}

        def w(name, header):
            f = open(os.path.join(test_dir, name), "w", newline="")
            self._files[name] = f
            self._writers[name] = csv.writer(f)
            if header is not None:
                self._writers[name].writerow(header)

        w("placements.csv", ["episode", "time", "node", "sf"])
        w("node_metrics.csv", ["episode", "time", "node", "node_capacity",
                               "used_resources", "ingress_traffic"])
        # truncated_arrivals extends the reference's header: nonzero means
        # arrivals were admitted late (flow-table slots ran out)
        w("metrics.csv", ["episode", "time", "total_flows", "successful_flows",
                          "dropped_flows", "in_network_flows",
                          "avg_end2end_delay", "truncated_arrivals"])
        w("run_flows.csv", ["episode", "time", "successful_flows",
                            "dropped_flows", "total_flows"])
        w("runtimes.csv", ["run", "runtime"])
        w("drop_reasons.csv", ["episode", "time", *DROP_REASONS])
        w("rl_state.csv", None)
        if write_schedule:
            w("scheduling.csv", ["episode", "time", "origin_node", "sfc",
                                 "sf", "schedule_node", "schedule_prob"])
        if write_flow_actions:
            w("flow_actions.csv", ["episode", "time", "flow_id",
                                   "flow_rem_ttl", "flow_ttl", "curr_node_id",
                                   "dest_node", "cur_node_rem_cap",
                                   "next_node_rem_cap", "link_cap",
                                   "link_rem_cap"])
        self._run = 0

    def write_flow_action(self, episode: int, time: float, flow_id: int,
                          rem_ttl: float, ttl: float, cur_node, dest_node,
                          cur_node_rem_cap: float, next_node_rem_cap: float,
                          link_cap, link_rem_cap):
        """One per-flow decision row, flushed at once."""
        if self.write_flow_actions:
            self._writers["flow_actions.csv"].writerow(
                [episode, time, flow_id, rem_ttl, ttl, cur_node, dest_node,
                 cur_node_rem_cap, next_node_rem_cap, link_cap, link_rem_cap])
            self._files["flow_actions.csv"].flush()

    def write_step(self, episode: int, time: float, metrics, placement,
                   node_cap, node_names: Optional[Sequence[str]] = None,
                   schedule=None, runtime: Optional[float] = None,
                   rl_state: Optional[Sequence[float]] = None,
                   truncated_arrivals: int = 0):
        """One control interval.  ``metrics`` is one replica's
        ``SimMetrics`` on the host; ``placement`` [N, P], ``node_cap``
        [N] and ``schedule`` [N, C, S, N] host arrays."""
        placement = np.asarray(placement)
        node_cap = np.asarray(node_cap)
        n = placement.shape[0]
        names = (list(node_names) if node_names
                 else [f"pop{i}" for i in range(n)])
        sfs = self.sf_names or [f"sf{i}" for i in range(placement.shape[1])]

        for node in range(n):
            for s in range(placement.shape[1]):
                if placement[node, s]:
                    self._writers["placements.csv"].writerow(
                        [episode, time, names[node], sfs[s]])

        # used_resources: the interval's peak demanded capacity
        used = np.asarray(metrics.run_max_node_usage)
        ingress = np.asarray(metrics.run_requested_node)
        for node in range(n):
            if node_cap[node] > 0 or used[node] > 0:
                self._writers["node_metrics.csv"].writerow(
                    [episode, time, names[node], node_cap[node], used[node],
                     ingress[node]])

        self._writers["metrics.csv"].writerow(
            [episode, time, int(metrics.generated), int(metrics.processed),
             int(metrics.dropped), int(metrics.active),
             float(metrics.avg_e2e()), int(truncated_arrivals)])
        self._writers["run_flows.csv"].writerow(
            [episode, time, int(metrics.run_processed),
             int(metrics.run_dropped), int(metrics.run_generated)])
        self._writers["drop_reasons.csv"].writerow(
            [episode, time, *np.asarray(metrics.drop_reasons).tolist()])
        if runtime is not None:
            self._run += 1
            self._writers["runtimes.csv"].writerow([self._run, runtime])
        if rl_state is not None:
            self._writers["rl_state.csv"].writerow(
                [episode, time] + [float(x) for x in rl_state])
        if schedule is not None and self.write_schedule:
            sched = np.asarray(schedule)
            sfcs = self.sfc_names or [f"sfc{i}" for i in range(sched.shape[1])]
            rows = []
            for src in range(n):
                for c in range(sched.shape[1]):
                    for s in range(sched.shape[2]):
                        for dst in range(n):
                            p = sched[src, c, s, dst]
                            if p > 0:
                                rows.append([episode, time, names[src],
                                             sfcs[c], sfs[s], names[dst], p])
            self._writers["scheduling.csv"].writerows(rows)
        for f in self._files.values():
            f.flush()

    def close(self):
        """Flush and close every file; safe to call more than once."""
        if self._closed:
            return
        self._closed = True
        for f in self._files.values():
            f.close()
