"""Process-wide metrics hub: counters, gauges, histograms, heartbeats,
events and the flight recorder's series.

The port of ``gsc_tpu.obs.hub.MetricsHub``.  One hub per run (or per
server); the training loop, the prefetcher thread (heartbeats), the
watchdog thread (stall events) and the serving path write into it, so
every mutation takes the hub lock.  ``snapshot()`` flattens every series
to ``gsc_<name>{tag="value",...}`` names (histograms expand to
``_count``/``_sum``/``_min``/``_max``/``_p50``/``_p90``/``_p99``), the
exposition ``metrics.json`` and ``/metrics`` serve.  ``clock`` (default
``time.monotonic``) stamps the heartbeats, so a test can drive the
watchdog through an injected clock.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# percentile window: enough samples to make p99 meaningful over a long run
# without unbounded memory; a run logging 1 episode/s holds ~17 min of
# history, which is the window a live-tail debugging session cares about
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


# a series key is (name, sorted tag items) — hashable and order-insensitive
_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, tags: Dict[str, object]) -> _Key:
    return name, tuple(sorted((k, str(v)) for k, v in tags.items()))


def flat_name(name: str, tags: Iterable[Tuple[str, str]]) -> str:
    """Prometheus-text-style series name: ``gsc_name{k="v",...}``."""
    label = ",".join(f'{k}="{v}"' for k, v in tags)
    return f"gsc_{name}{{{label}}}" if label else f"gsc_{name}"


class MetricsHub:
    """Counters, gauges and histograms tagged by run/replica, plus the
    heartbeat registry the :class:`~gsc_tpu_torch.obs.watchdog.PipelineWatchdog`
    polls and the event fan-out the JSONL stream hangs off."""

    def __init__(self, tags: Optional[Dict[str, object]] = None,
                 series_window: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self._lock = threading.RLock()
        self.clock = clock
        self.base_tags: Dict[str, str] = {
            k: str(v) for k, v in (tags or {}).items()}
        self._counters: Dict[_Key, float] = {}        # guarded-by: self._lock
        self._gauges: Dict[_Key, float] = {}          # guarded-by: self._lock
        self._live_gauges: Dict[_Key, object] = {}    # guarded-by: self._lock
        self._hists: Dict[_Key, _Histogram] = {}      # guarded-by: self._lock
        self._beats: Dict[str, float] = {}            # guarded-by: self._lock
        self._last_phase: Optional[str] = None        # guarded-by: self._lock
        self._last_phase_done = False                 # guarded-by: self._lock
        # per-thread pipeline phase (fleet watchdog coverage): a wedged
        # actor's stall event names the phase IT was in, not the main
        # loop's
        self._thread_phases: Dict[str, str] = {}      # guarded-by: self._lock
        self._sinks: list = []                        # guarded-by: self._lock
        # time-series rings (the flight recorder; ``--obs-series-window``):
        # None = history off, series() is a no-op and every snapshot /
        # event byte stays identical to the history-free hub
        self.series_store = None
        if series_window and series_window > 0:
            from .series import SeriesStore
            self.series_store = SeriesStore(window=series_window,
                                            base_tags=self.base_tags)

    # ------------------------------------------------------------- series
    def counter(self, name: str, inc: float = 1.0, **tags) -> float:
        """Monotonic counter; returns the new value."""
        k = _key(name, tags)
        with self._lock:
            val = self._counters.get(k, 0.0) + inc
            self._counters[k] = val
            return val

    def get_counter(self, name: str, **tags) -> float:
        with self._lock:
            return self._counters.get(_key(name, tags), 0.0)

    def gauge(self, name: str, value: float, **tags):
        """Point-in-time value (last write wins)."""
        with self._lock:
            self._gauges[_key(name, tags)] = float(value)

    def get_gauge(self, name: str, **tags) -> Optional[float]:
        with self._lock:
            return self._gauges.get(_key(name, tags))

    def live_gauge(self, name: str, probe, **tags):
        """Register a zero-arg probe sampled at every :meth:`snapshot` —
        the /metrics endpoint scrapes through snapshot, so a live probe
        (e.g. the serve queue depth) stays current between the event
        writers' explicit samples.  The probe runs under the hub lock:
        keep it O(1) and lock-free (a ``qsize()``, a counter read)."""
        with self._lock:
            self._live_gauges[_key(name, tags)] = probe

    def drop_live_gauge(self, name: str, **tags):
        with self._lock:
            self._live_gauges.pop(_key(name, tags), None)

    def series(self, name: str, value: float, ts: Optional[float] = None,
               **tags):
        """Append one ``(ts, value)`` point to the metric's bounded ring
        (drop-oldest; the flight recorder's history).  A no-op when the
        hub was built without a series window, so feed sites never need
        to gate themselves.  The store has its own lock — a series feed
        never contends with snapshot scrapes on the hub lock."""
        if self.series_store is not None:
            self.series_store.add_point(name, value, ts=ts, **tags)

    def observe(self, name: str, value: float, **tags):
        """Histogram sample (count/sum/min/max + windowed percentiles)."""
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

    # --------------------------------------------------------- heartbeats
    def beat(self, name: str):
        """Record liveness of a component (trainer loop, prefetcher, ...)."""
        with self._lock:
            self._beats[name] = self.clock()

    def beat_age(self, name: str) -> Optional[float]:
        """Seconds since ``name`` last beat; None if it never has."""
        with self._lock:
            t = self._beats.get(name)
        return None if t is None else self.clock() - t

    def beat_time(self, name: str) -> Optional[float]:
        """Raw monotonic timestamp of the last beat (watchdog re-arm key)."""
        with self._lock:
            return self._beats.get(name)

    def beat_ages(self) -> Dict[str, float]:
        now = self.clock()
        with self._lock:
            return {n: round(now - t, 3) for n, t in self._beats.items()}

    # ---------------------------------------------------- phase bookkeeping
    def note_phase(self, name: str, done: bool = False):
        """Track the pipeline phase currently executing (``done=False``) or
        just finished (``done=True``) — a stall event reports both so a hang
        points at the phase it is stuck *in*."""
        with self._lock:
            self._last_phase = name
            self._last_phase_done = done

    @property
    def last_phase(self) -> Tuple[Optional[str], bool]:
        with self._lock:
            return self._last_phase, self._last_phase_done

    def note_thread_phase(self, thread: str, phase: str):
        """Track the phase one named pipeline thread (actor0, learner,
        ...) is currently in — the fleet watchdog reports it when THAT
        thread's heartbeat goes quiet, so a stall says ``blocked_put``
        vs ``dispatch`` vs ``adopt`` instead of pointing at the main
        loop."""
        with self._lock:
            self._thread_phases[thread] = phase

    def thread_phase(self, thread: str) -> Optional[str]:
        with self._lock:
            return self._thread_phases.get(thread)

    def thread_phases(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._thread_phases)

    # -------------------------------------------------------------- events
    def add_sink(self, sink):
        with self._lock:
            self._sinks.append(sink)

    def event(self, kind: str, **fields) -> Dict[str, object]:
        """Emit one structured record to every sink; returns the record.
        Base tags (run id, ...) merge in under the caller's fields."""
        record = {"event": kind, "ts": round(time.time(), 3),
                  **self.base_tags, **fields}
        with self._lock:
            sinks = list(self._sinks)
        for sink in sinks:
            sink.emit(record)
        return record

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, float]:
        """Flat ``{prometheus_name: value}`` view of every live series.
        Live-gauge probes are sampled first (their latest value also
        lands in the plain gauge table, so ``get_gauge`` and later
        snapshots agree with what was served)."""
        with self._lock:
            for k, probe in list(self._live_gauges.items()):
                try:
                    self._gauges[k] = float(probe())
                except Exception:   # a dead probe must not break scrapes
                    pass
            base = tuple(self.base_tags.items())
            merge = lambda tags: tuple(sorted(base + tags))
            out: Dict[str, float] = {}
            for (name, tags), v in self._counters.items():
                out[flat_name(name, merge(tags))] = v
            for (name, tags), v in self._gauges.items():
                out[flat_name(name, merge(tags))] = v
            for (name, tags), h in self._hists.items():
                s = h.summary()
                for suffix in ("count", "sum", "min", "max", "p50", "p90",
                               "p99"):
                    out[flat_name(f"{name}_{suffix}", merge(tags))] = s[suffix]
            return out

    def close(self):
        with self._lock:
            sinks, self._sinks = list(self._sinks), []
        for sink in sinks:
            try:
                sink.close()
            except Exception:  # a failing sink must not mask run teardown
                pass
