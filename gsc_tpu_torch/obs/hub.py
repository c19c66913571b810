"""Metrics hub: counters, gauges and histograms.

The port's copy of the part of ``gsc_tpu.obs.hub.MetricsHub`` that the
serving path feeds: the latency and batch histograms (count, sum, min,
max and nearest-rank p50/p90/p99 over a window of the newest samples),
the request and batch counters and the queue-depth gauge.  Every
mutation takes the hub lock.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

# percentile window: enough samples for a meaningful p99, bounded memory
_HIST_WINDOW = 1024
_PCTS = ((0.50, "p50"), (0.90, "p90"), (0.99, "p99"))


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


class _Histogram:
    __slots__ = ("count", "total", "vmin", "vmax", "window")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.window = deque(maxlen=_HIST_WINDOW)

    def observe(self, value: float):
        self.count += 1
        self.total += value
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)
        self.window.append(value)

    def summary(self) -> Dict[str, float]:
        vals = sorted(self.window)
        out = {"count": float(self.count), "sum": self.total,
               "min": self.vmin if self.count else 0.0,
               "max": self.vmax if self.count else 0.0,
               "mean": self.total / self.count if self.count else 0.0}
        for q, label in _PCTS:
            out[label] = _percentile(vals, q)
        return out


_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, tags: Dict[str, object]) -> _Key:
    return name, tuple(sorted((k, str(v)) for k, v in tags.items()))


class MetricsHub:
    """Tagged counters, gauges and histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[_Key, float] = {}   # guarded-by: self._lock
        self._gauges: Dict[_Key, float] = {}     # guarded-by: self._lock
        self._hists: Dict[_Key, _Histogram] = {}  # guarded-by: self._lock

    def counter(self, name: str, inc: float = 1.0, **tags) -> float:
        """Monotonic counter; returns the new value."""
        k = _key(name, tags)
        with self._lock:
            val = self._counters.get(k, 0.0) + inc
            self._counters[k] = val
            return val

    def gauge(self, name: str, value: float, **tags):
        with self._lock:
            self._gauges[_key(name, tags)] = float(value)

    def observe(self, name: str, value: float, **tags):
        """Histogram sample."""
        k = _key(name, tags)
        with self._lock:
            hist = self._hists.get(k)
            if hist is None:
                hist = self._hists[k] = _Histogram()
            hist.observe(float(value))

    def histogram_summary(self, name: str, **tags) -> Optional[Dict[str, float]]:
        with self._lock:
            h = self._hists.get(_key(name, tags))
            return h.summary() if h else None
