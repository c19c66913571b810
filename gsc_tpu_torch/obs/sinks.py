"""Event sinks, the atomic snapshot writer and the event-stream reader.

The port of ``gsc_tpu.obs.sinks`` (and of ``read_events`` /
``sort_events`` from ``gsc_tpu.obs.trace``).  ``events.jsonl`` is
append-only, one JSON object per line, flushed per record so a live run
can be tailed, and optionally rotated by size into ``events.jsonl.1..N``;
``metrics.json`` is rewritten whole through a temp file and
``os.replace`` so a poller never reads half a document.  JSON coercion
takes 0-d torch tensors and numpy scalars and arrays.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
from collections import deque
from typing import Dict, List

import numpy as np


def jsonable(obj):
    """Event-record leaves as JSON types: numpy scalars and arrays, torch
    tensors (0-d as a number, others as lists)."""
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "detach"):       # a torch tensor, without importing torch
        obj = obj.detach().cpu()
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)


def rotated_paths(path: str) -> List[str]:
    """Every on-disk segment of a (possibly rotated) JSONL stream, oldest
    first: ``events.jsonl.N .. events.jsonl.1, events.jsonl``."""
    n = 1
    older = []
    while os.path.exists(f"{path}.{n}"):
        older.append(f"{path}.{n}")
        n += 1
    return list(reversed(older)) + [path]


class JsonlSink:
    """Append-only JSONL stream, every record flushed; ``emit`` is called
    from the training loop and the watchdog thread, under a lock.
    ``rotate_mb > 0``: past that size the live file becomes ``<path>.1``
    (older segments shift up) and a fresh one is opened."""

    def __init__(self, path: str, rotate_mb: float = 0.0):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.rotate_bytes = int(max(rotate_mb, 0.0) * 2 ** 20)
        self._lock = threading.Lock()
        self._file = open(path, "a")   # guarded-by: self._lock

    def _rotate(self):  # requires-lock: self._lock
        with contextlib.closing(self._file):
            self._file.flush()
        n = 1
        while os.path.exists(f"{self.path}.{n}"):
            n += 1
        for k in range(n, 1, -1):
            os.replace(f"{self.path}.{k - 1}", f"{self.path}.{k}")
        os.replace(self.path, f"{self.path}.1")
        self._file = open(self.path, "a")

    def emit(self, record: Dict):
        line = json.dumps(record, default=jsonable)
        with self._lock:
            if self._file is None:
                return   # a late event after close (watchdog teardown)
            self._file.write(line + "\n")
            self._file.flush()
            if self.rotate_bytes and self._file.tell() >= self.rotate_bytes:
                self._rotate()

    def close(self):
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


class TailSink:
    """The last ``maxlen`` records, JSON round-tripped (the black-box
    dump's pending-event source); drop-oldest, thread-safe."""

    def __init__(self, maxlen: int = 256):
        self._records = deque(maxlen=int(maxlen))   # guarded-by: self._lock
        self._lock = threading.Lock()

    def emit(self, record: Dict):
        line = json.dumps(record, default=jsonable)
        with self._lock:
            self._records.append(json.loads(line))

    def tail(self) -> List[Dict]:
        with self._lock:
            return list(self._records)

    def close(self):
        pass


class ListSink:
    """In-memory sink: every record as a JSONL reader would see it."""

    def __init__(self):
        self.records: List[Dict] = []
        self._lock = threading.Lock()

    def emit(self, record: Dict):
        with self._lock:
            self.records.append(json.loads(json.dumps(record,
                                                      default=jsonable)))

    def of_kind(self, kind: str) -> List[Dict]:
        with self._lock:
            return [r for r in self.records if r.get("event") == kind]

    def close(self):
        pass


def write_atomic_json(path: str, obj) -> str:
    """Write ``obj`` as JSON through a temp file and ``os.replace``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, default=jsonable, indent=0, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def _event_ts(e) -> float:
    ts = e.get("ts") if isinstance(e, dict) else None
    return float(ts) if isinstance(ts, (int, float)) \
        and not isinstance(ts, bool) else float("-inf")


def sort_events(events: List[Dict]) -> List[Dict]:
    """Stable sort by ``ts`` within each run's slice of a stream (runs
    begin at ``run_start`` in file order): threads stamp ``ts`` before
    they take the sink lock, so their records can land out of order."""
    out: List[Dict] = []
    seg: List[Dict] = []
    for e in events:
        if isinstance(e, dict) and e.get("event") == "run_start" and seg:
            seg.sort(key=_event_ts)
            out.extend(seg)
            seg = []
        seg.append(e)
    seg.sort(key=_event_ts)
    out.extend(seg)
    return out


def read_events(path: str) -> List[Dict]:
    """A run's event stream (the run directory or its events.jsonl),
    rotated segments included, torn tail lines skipped, sorted by
    :func:`sort_events`."""
    if os.path.isdir(path):
        path = os.path.join(path, "events.jsonl")
    segments = [p for p in rotated_paths(path) if os.path.exists(p)]
    if not segments:
        raise FileNotFoundError(f"no events stream at {path}")
    events = []
    for seg in segments:
        with open(seg) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue   # the torn final line of a live segment
    return sort_events(events)
