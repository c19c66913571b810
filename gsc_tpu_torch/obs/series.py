"""Time-series rings and the black-box post-mortem writer.

The port of ``gsc_tpu.obs.series``.  :class:`SeriesStore` keeps bounded
``(ts, value)`` rings per metric, keyed like the hub's flat series names
(``gsc_<name>{tag="v",...}``), drop-oldest, under one lock; every feed
site is a host site that already holds the value.  ``series.json`` is
the schema-versioned whole-run dump ``RunObserver.close()`` writes
(:func:`write_series`); :func:`write_blackbox` writes the last N seconds
of every ring with the pending event tail to ``blackbox.json`` when the
watchdog escalates, the run dies or a preemption lands.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .sinks import write_atomic_json

# bump on any series.json / /series payload shape change
SERIES_SCHEMA_VERSION = 1
# bump on any blackbox.json shape change
BLACKBOX_SCHEMA_VERSION = 1

# a ring key is (name, sorted tag items) — the hub's own key shape
_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _flat(name: str, tags: Tuple[Tuple[str, str], ...]) -> str:
    # local copy of hub.flat_name (hub imports THIS module lazily; a
    # top-level import back into hub would be a cycle)
    label = ",".join(f'{k}="{v}"' for k, v in tags)
    return f"gsc_{name}{{{label}}}" if label else f"gsc_{name}"


class SeriesStore:
    """Bounded per-metric ``(ts, value)`` rings, drop-oldest.

    ``window`` caps POINTS per ring, not seconds — a 1 Hz feed with the
    default CLI window holds ~17 minutes, matching the hub histogram
    window's live-tail horizon.  All methods are thread-safe; appends
    from the learner loop, the serve dispatcher and the drain never
    contend for more than one dict lookup + deque push."""

    def __init__(self, window: int = 1024,
                 base_tags: Optional[Dict[str, str]] = None):
        if window < 1:
            raise ValueError(f"series window must be >= 1, got {window}")
        self.window = int(window)
        self.base_tags: Dict[str, str] = dict(base_tags or {})
        self._lock = threading.Lock()
        self._rings: Dict[_Key, deque] = {}   # guarded-by: self._lock

    # ------------------------------------------------------------- writes
    def add_point(self, name: str, value: float,
                  ts: Optional[float] = None,
               **tags):
        """Push one point (drop-oldest past the window).  ``ts`` defaults
        to now; callers replaying deferred records pass their own."""
        key = (name, tuple(sorted((k, str(v)) for k, v in tags.items())))
        point = (round(float(ts if ts is not None else time.time()), 3),
                 float(value))
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = deque(maxlen=self.window)
            ring.append(point)

    # -------------------------------------------------------------- reads
    def names(self) -> List[str]:
        with self._lock:
            keys = list(self._rings)
        base = tuple(sorted(self.base_tags.items()))
        return sorted(_flat(n, tuple(sorted(base + t))) for n, t in keys)

    def query(self, name: Optional[str] = None,
              since: Optional[float] = None) -> Dict[str, List[List[float]]]:
        """``{flat_name: [[ts, value], ...]}``, oldest first.  ``name``
        filters on the BARE metric name (tags ignored — one bare name can
        fan out to many tagged rings); ``since`` keeps points with
        ``ts >= since``."""
        base = tuple(sorted(self.base_tags.items()))
        with self._lock:
            items = [(k, list(ring)) for k, ring in self._rings.items()]
        out: Dict[str, List[List[float]]] = {}
        for (n, tags), points in items:
            if name and n != name:
                continue
            if since is not None:
                points = [p for p in points if p[0] >= since]
            if not points:
                continue
            out[_flat(n, tuple(sorted(base + tags)))] = \
                [[p[0], p[1]] for p in points]
        return out

    def tail(self, seconds: float) -> Dict[str, List[List[float]]]:
        """Every ring's points from the last ``seconds`` — the black-box
        dump's series window."""
        return self.query(since=time.time() - float(seconds))

    def last(self, name: str, **tags) -> Optional[float]:
        key = (name, tuple(sorted((k, str(v)) for k, v in tags.items())))
        with self._lock:
            ring = self._rings.get(key)
            return ring[-1][1] if ring else None

    def point_count(self) -> int:
        with self._lock:
            return sum(len(r) for r in self._rings.values())

    # ---------------------------------------------------------- documents
    def document(self, run: Optional[str] = None,
                 since: Optional[float] = None) -> Dict:
        """The schema-versioned payload both ``series.json`` and the
        ``/series`` endpoint serve."""
        return {
            "schema_version": SERIES_SCHEMA_VERSION,
            "ts": round(time.time(), 3),
            "run": run,
            "window": self.window,
            "series": self.query(since=since),
        }


def write_series(path: str, store: SeriesStore,
                 run: Optional[str] = None) -> str:
    """Atomic whole-run ``series.json`` dump."""
    return write_atomic_json(path, store.document(run=run))


def write_blackbox(path: str, reason: str,
                   store: Optional[SeriesStore] = None,
                   events: Optional[List[Dict]] = None,
                   window_s: float = 30.0,
                   heartbeats: Optional[Dict[str, float]] = None,
                   thread_phases: Optional[Dict[str, str]] = None,
                   run: Optional[str] = None,
                   extra: Optional[Dict] = None) -> str:
    """The post-mortem dump: last ``window_s`` of every series ring plus
    the pending event tail, written atomically so a dying process leaves
    a complete document or none.  Every field is optional — a run with
    the series store disabled still gets its event tail and heartbeat
    ages on a crash."""
    doc = {
        "schema_version": BLACKBOX_SCHEMA_VERSION,
        "ts": round(time.time(), 3),
        "run": run,
        "reason": reason,
        "window_s": float(window_s),
        "series": store.tail(window_s) if store is not None else {},
        "events": list(events or []),
        "heartbeats": dict(heartbeats or {}),
        "thread_phases": dict(thread_phases or {}),
    }
    if extra:
        doc.update(extra)
    return write_atomic_json(path, doc)
