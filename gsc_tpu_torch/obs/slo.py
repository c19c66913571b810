"""Serving SLO engine and request-path span tracer.

The port of ``gsc_tpu.obs.slo``, stdlib and the hub only:

- :class:`ServeTracer` — per-request spans.  The batcher stamps
  timestamps only (enqueue, batch admission, device dispatch, completion)
  and hands each flush over as one compact record; a drainer thread turns
  the records into the latency-decomposition histograms, ``serve_flush``
  events (always) and head-sampled ``serve_request_span`` events (every
  Nth trace id), so the flush path does no emission work.  Span events
  carry their original wall timestamps, so the trace exporter
  (:mod:`~gsc_tpu_torch.obs.trace`) draws them where they happened and
  links each sampled request to its flush with a flow arrow.
- :class:`SLOEngine` — declarative latency objectives
  (:func:`parse_slo_spec`: ``"25"`` is an overall target in ms,
  ``"25,8:60"`` adds a per-bucket one), rolling-window attainment against
  them, error-budget burn rate (``(1 - attainment) / (1 - target)``), the
  cumulative deadline-miss ratio (latency above the batcher's
  ``deadline_ms``), an arrival-rate EWMA over inter-arrival gaps and the
  per-flush pad waste (``1 - n_real/bucket``).  Its snapshot goes into
  ``serve_stats`` events, the ``slo_*`` gauges of ``/metrics`` and the
  ``slo.json`` document ``PolicyServer.close`` writes.

Every value either touches is a host float the batcher already held: no
device read happens on their account.  Neither reads a clock: every time
comes in as an argument, so a test drives them with its own.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

SLO_SCHEMA_VERSION = 1

# rolling attainment window: enough requests for a stable fraction
# without unbounded memory (matches the hub histogram window scale)
_SLO_WINDOW = 512
# arrival-rate EWMA smoothing over inter-arrival gaps
_ARRIVAL_ALPHA = 0.2


def _ratio(num: float, den: float) -> Optional[float]:
    return round(num / den, 6) if den else None


class SLOObjectives:
    """Declarative latency objectives: an overall target plus optional
    per-bucket overrides, judged at ``target_attainment`` (the SRE error
    budget is ``1 - target_attainment``)."""

    def __init__(self, p99_ms: Optional[float] = None,
                 per_bucket: Optional[Dict[int, float]] = None,
                 target_attainment: float = 0.99):
        if not 0.0 < target_attainment < 1.0:
            raise ValueError(f"target_attainment must be in (0, 1): "
                             f"{target_attainment!r}")
        self.p99_ms = float(p99_ms) if p99_ms is not None else None
        self.per_bucket = {int(b): float(v)
                           for b, v in (per_bucket or {}).items()}
        self.target_attainment = float(target_attainment)

    def objective_for(self, bucket) -> Optional[float]:
        """The target a request in ``bucket`` is judged against: the
        bucket override when one exists, else the overall objective."""
        try:
            return self.per_bucket.get(int(bucket), self.p99_ms)
        except (TypeError, ValueError):
            return self.p99_ms

    def declared(self) -> bool:
        return self.p99_ms is not None or bool(self.per_bucket)

    def to_doc(self) -> Dict:
        return {"p99_ms": self.p99_ms,
                "per_bucket": {str(b): v
                               for b, v in sorted(self.per_bucket.items())},
                "target_attainment": self.target_attainment}


def parse_slo_spec(spec: str,
                   target_attainment: float = 0.99) -> SLOObjectives:
    """``--slo-p99-ms`` grammar -> :class:`SLOObjectives`.

    ``entry := <ms> | <bucket>:<ms>``, comma-separated; at most one bare
    ``<ms>`` (the overall objective), any number of per-bucket overrides.
    Examples: ``"25"``, ``"25,8:60"``, ``"4:40,8:60"``.  Raises
    ``ValueError`` on malformed/duplicate/non-positive entries."""
    overall: Optional[float] = None
    per_bucket: Dict[int, float] = {}
    for raw in str(spec).split(","):
        entry = raw.strip()
        if not entry:
            raise ValueError(f"empty entry in SLO spec {spec!r}")
        if ":" in entry:
            b_txt, v_txt = entry.split(":", 1)
            try:
                b, v = int(b_txt), float(v_txt)
            except ValueError:
                raise ValueError(f"bad per-bucket SLO entry {entry!r} "
                                 f"(want <bucket>:<ms>)")
            if b < 1 or v <= 0:
                raise ValueError(f"per-bucket SLO entry {entry!r} must "
                                 "have bucket >= 1 and ms > 0")
            if b in per_bucket:
                raise ValueError(f"duplicate bucket {b} in SLO spec "
                                 f"{spec!r}")
            per_bucket[b] = v
        else:
            try:
                v = float(entry)
            except ValueError:
                raise ValueError(f"bad SLO entry {entry!r} (want <ms> or "
                                 "<bucket>:<ms>)")
            if v <= 0:
                raise ValueError(f"overall SLO must be > 0 ms: {entry!r}")
            if overall is not None:
                raise ValueError(f"more than one overall objective in "
                                 f"SLO spec {spec!r}")
            overall = v
    return SLOObjectives(p99_ms=overall, per_bucket=per_bucket,
                         target_attainment=target_attainment)


class SLOEngine:
    """Rolling SLO accounting for one serving process.

    Fed exclusively from the :class:`ServeTracer` drain (and the
    batcher's rejection path) — never from the flush path directly.
    Thread-safe: the drainer thread writes while ``serve_stats``
    emission and ``close()`` read."""

    def __init__(self, deadline_ms: float,
                 objectives: Optional[SLOObjectives] = None,
                 hub=None, window: int = _SLO_WINDOW,
                 alpha: float = _ARRIVAL_ALPHA,
                 tags: Optional[Dict[str, str]] = None):
        self.deadline_ms = float(deadline_ms)
        self.objectives = objectives or SLOObjectives()
        self.hub = hub
        # extra gauge/counter tags (e.g. {"worker": "w0"} in a fleet, so
        # N engines sharing one hub never fight over the slo_* series);
        # empty = the historic untagged series
        self.tags = dict(tags or {})
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        # (latency_ms, bucket) rolling window for attainment
        self._window = deque(maxlen=max(int(window), 1))   # guarded-by: self._lock
        self._requests = 0                  # guarded-by: self._lock
        self._deadline_misses = 0           # guarded-by: self._lock
        self._errored = 0                   # guarded-by: self._lock
        self._lat_sum = 0.0                 # guarded-by: self._lock
        self._queue_wait_sum = 0.0          # guarded-by: self._lock
        self._flushes = 0                   # guarded-by: self._lock
        self._pad_sum = 0.0                 # guarded-by: self._lock
        self._per_bucket: Dict[int, Dict[str, float]] = {}   # guarded-by: self._lock
        self._rejected: Dict[str, int] = {}   # guarded-by: self._lock
        self._last_arrival: Optional[float] = None   # guarded-by: self._lock
        self._ia_ewma: Optional[float] = None        # guarded-by: self._lock
        self._published_misses = 0          # guarded-by: self._lock

    # ------------------------------------------------------------ feeding
    def note_arrival(self, wall_ts: float):
        """One request arrival (accepted OR rejected) — drives the
        arrival-rate EWMA over inter-arrival gaps.  Gaps are floored at
        1 ns: a coarse wall clock stamping a burst with identical times
        must read as "very fast", never poison the EWMA with a 0 that
        makes the rate unreportable."""
        with self._lock:
            if self._last_arrival is not None:
                gap = max(wall_ts - self._last_arrival, 1e-9)
                self._ia_ewma = gap if self._ia_ewma is None else \
                    self.alpha * gap + (1.0 - self.alpha) * self._ia_ewma
            self._last_arrival = wall_ts

    def record_request(self, latency_ms: float, bucket: int,
                       queue_wait_ms: float = 0.0) -> bool:
        """One completed request; returns whether it missed the
        deadline (latency > the batcher's ``deadline_ms``)."""
        miss = latency_ms > self.deadline_ms
        with self._lock:
            self._requests += 1
            self._lat_sum += latency_ms
            self._queue_wait_sum += max(queue_wait_ms, 0.0)
            if miss:
                self._deadline_misses += 1
            self._window.append((float(latency_ms), int(bucket)))
            b = self._per_bucket.setdefault(
                int(bucket), {"requests": 0, "deadline_misses": 0,
                              "flushes": 0, "pad_sum": 0.0})
            b["requests"] += 1
            if miss:
                b["deadline_misses"] += 1
        return miss

    def record_failed_request(self, bucket: int):
        """A request whose device call ERRORED: it was never answered,
        so it burns the budget as both a deadline miss and an objective
        violation (an infinite latency fails any target) — a failing
        server must not report perfect attainment."""
        with self._lock:
            self._requests += 1
            self._errored += 1
            self._deadline_misses += 1
            self._window.append((float("inf"), int(bucket)))
            b = self._per_bucket.setdefault(
                int(bucket), {"requests": 0, "deadline_misses": 0,
                              "flushes": 0, "pad_sum": 0.0})
            b["requests"] += 1
            b["deadline_misses"] += 1

    def record_flush(self, n_real: int, bucket: int):
        pad = 1.0 - (n_real / bucket) if bucket else 0.0
        with self._lock:
            self._flushes += 1
            self._pad_sum += pad
            b = self._per_bucket.setdefault(
                int(bucket), {"requests": 0, "deadline_misses": 0,
                              "flushes": 0, "pad_sum": 0.0})
            b["flushes"] += 1
            b["pad_sum"] += pad

    def record_rejection(self, reason: str, wall_ts: Optional[float] = None):
        with self._lock:
            self._rejected[reason] = self._rejected.get(reason, 0) + 1
        if wall_ts is not None:
            self.note_arrival(wall_ts)

    # ----------------------------------------------------------- reading
    def _window_attainment(self, bucket: Optional[int] = None) \
            -> Optional[float]:  # requires-lock: self._lock
        """Fraction of rolling-window requests meeting their applicable
        objective (bucket override else overall); None when no objective
        applies to any window entry.  Caller holds the lock."""
        hits = total = 0
        for lat, b in self._window:
            if bucket is not None and b != bucket:
                continue
            target = self.objectives.objective_for(b)
            if target is None:
                continue
            total += 1
            if lat <= target:
                hits += 1
        return _ratio(hits, total)

    def snapshot(self) -> Dict:
        """The SLO state as one JSON-able dict (the ``serve_stats`` /
        ``slo.json`` payload core)."""
        with self._lock:
            attainment = self._window_attainment()
            burn = None
            if attainment is not None:
                budget = 1.0 - self.objectives.target_attainment
                burn = round((1.0 - attainment) / budget, 4)
            per_bucket = {}
            for b, rec in sorted(self._per_bucket.items()):
                per_bucket[str(b)] = {
                    "requests": int(rec["requests"]),
                    "deadline_misses": int(rec["deadline_misses"]),
                    "deadline_miss_ratio": _ratio(rec["deadline_misses"],
                                                  rec["requests"]),
                    "pad_waste": _ratio(rec["pad_sum"], rec["flushes"]),
                    "objective_ms": self.objectives.objective_for(b),
                    "attainment": self._window_attainment(b),
                }
            rate = None
            if self._ia_ewma is not None:   # floored > 0 in note_arrival
                rate = round(1.0 / self._ia_ewma, 3)
            return {
                "deadline_ms": self.deadline_ms,
                "objectives": self.objectives.to_doc(),
                "requests": self._requests,
                "errored_requests": self._errored,
                "deadline_misses": self._deadline_misses,
                "deadline_miss_ratio": _ratio(self._deadline_misses,
                                              self._requests),
                "attainment": attainment,
                "burn_rate": burn,
                "arrival_rate_rps": rate,
                "flushes": self._flushes,
                "pad_waste": _ratio(self._pad_sum, self._flushes),
                "queue_wait_frac": _ratio(self._queue_wait_sum,
                                          self._lat_sum),
                "rejected": dict(self._rejected),
                "window": {"size": len(self._window),
                           "capacity": self._window.maxlen},
                "per_bucket": per_bucket,
            }

    def publish_gauges(self):
        """Refresh the hub's ``slo_*`` gauges + deadline-miss counter
        from the current state (drainer cadence, never the flush path)."""
        if self.hub is None:
            return
        snap = self.snapshot()
        for name, key in (("slo_deadline_miss_ratio", "deadline_miss_ratio"),
                          ("slo_attainment", "attainment"),
                          ("slo_burn_rate", "burn_rate"),
                          ("slo_arrival_rate_rps", "arrival_rate_rps"),
                          ("slo_pad_waste", "pad_waste"),
                          ("slo_queue_wait_frac", "queue_wait_frac")):
            if snap.get(key) is not None:
                self.hub.gauge(name, snap[key], **self.tags)
        with self._lock:
            delta = self._deadline_misses - self._published_misses
            self._published_misses = self._deadline_misses
        if delta:
            self.hub.counter("serve_deadline_miss_total", delta,
                             **self.tags)


class ServeTracer:
    """Deferred span pipeline between the batcher's flush path and the
    observability stream.

    The batcher calls :meth:`record_flush` (a deque append of plain
    floats) and :meth:`note_rejection`; a daemon drainer thread converts
    pending records into

    - decomposition histograms (``serve_queue_wait_ms`` /
      ``serve_batch_wait_ms`` / ``serve_fanout_ms``, overall + per
      bucket; the device wall already lives in ``serve_batch_ms``),
    - one ``serve_flush`` event per device call (always recorded),
    - one ``serve_request_span`` event per head-sampled request
      (``sample`` = record every Nth trace id; 0 disables request
      spans), and
    - the :class:`SLOEngine` updates + ``slo_*`` gauge refresh.

    The pending queue is bounded; overflow drops the OLDEST record and
    counts it (``spans_dropped`` in the snapshot and a hub counter) —
    telemetry degrades loudly, the serve path never blocks on it."""

    def __init__(self, hub=None, sample: int = 0,
                 drain_interval_s: float = 0.05, max_pending: int = 8192):
        self.hub = hub
        self.sample = max(int(sample), 0)
        self.drain_interval_s = float(drain_interval_s)
        self.max_pending = int(max_pending)
        self.engine: Optional[SLOEngine] = None
        self._pending: deque = deque()   # guarded-by: self._append_lock
        self._dropped = 0                # guarded-by: self._append_lock
        self._published_dropped = 0      # guarded-by: self._append_lock
        self._flush_seq = 0              # guarded-by: self._drain_lock
        self._drain_lock = threading.Lock()
        self._append_lock = threading.Lock()
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def bind_engine(self, engine: SLOEngine) -> "ServeTracer":
        self.engine = engine
        return self

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "ServeTracer":
        if self._thread is None:
            self._stop_event.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="gsc-serve-tracer",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self):
        """Stop the drainer and drain everything still pending."""
        self._stop_event.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10.0)
        self.drain_pending()

    def _run(self):
        while not self._stop_event.wait(self.drain_interval_s):
            self.drain_pending()

    # ------------------------------------------------- batcher-side hooks
    def record_flush(self, rec: Dict):
        """Called from the batcher thread right after a flush: ``rec``
        holds timestamps + per-request tuples, nothing derived.  O(1),
        no I/O, no locks shared with the drain's emission work."""
        with self._append_lock:
            if len(self._pending) >= self.max_pending:
                self._pending.popleft()
                self._dropped += 1
            self._pending.append(("flush", rec))

    def note_rejection(self, reason: str, wall_ts: float):
        with self._append_lock:
            if len(self._pending) >= self.max_pending:
                self._pending.popleft()
                self._dropped += 1
            self._pending.append(("reject", reason, wall_ts))

    # --------------------------------------------------------------- drain
    def drain_pending(self):
        """Process every pending record (drainer thread, ``stop()`` and
        tests); serialized so records are handled in arrival order."""
        with self._drain_lock:
            batch: List = []
            with self._append_lock:
                while self._pending:
                    batch.append(self._pending.popleft())
            for item in batch:
                if item[0] == "flush":
                    self._drain_flush(item[1])
                else:
                    _, reason, wall_ts = item
                    if self.engine is not None:
                        self.engine.record_rejection(reason, wall_ts)
            if batch:
                if self.engine is not None:
                    self.engine.publish_gauges()
                self._publish_dropped()

    def _publish_dropped(self):
        if self.hub is None:
            return
        with self._append_lock:
            delta = self._dropped - self._published_dropped
            self._published_dropped = self._dropped
        if delta:
            self.hub.counter("serve_spans_dropped_total", delta)

    @property
    def spans_dropped(self) -> int:
        with self._append_lock:
            return self._dropped

    def _drain_flush(self, rec: Dict):  # requires-lock: self._drain_lock
        bucket = rec["bucket"]
        n_real = rec["n_real"]
        t_dispatch = rec["t_dispatch"]
        t_device_done = rec["t_device_done"]
        device_ms = (t_device_done - t_dispatch) * 1e3
        pad_fraction = round(1.0 - n_real / bucket, 6) if bucket else 0.0
        flush_id = self._flush_seq
        self._flush_seq += 1
        # fleet/hot-swap context: the policy version the device call ran
        # under (stamped under the batcher's flush lock, so it is exact)
        # and the worker id — both ride every serve_flush event and span
        # when the batcher declares them (None/absent otherwise)
        extra = {}
        if rec.get("policy_version") is not None:
            extra["policy_version"] = rec["policy_version"]
        if rec.get("worker"):
            extra["worker"] = rec["worker"]
        if self.engine is not None:
            self.engine.record_flush(n_real, bucket)
        if rec.get("error") is not None:
            # failed device call: the requests were never answered —
            # count them against the budget (misses + objective
            # violations), record the flush slice with its error, and
            # skip the per-request decomposition (there is none)
            if self.engine is not None:
                for (trace_id, wall_enq, _t_enq, _t_admit, _t) \
                        in rec["requests"]:
                    self.engine.record_failed_request(bucket)
                    self.engine.note_arrival(wall_enq)
            if self.hub is not None:
                self.hub.event("serve_flush",
                               ts=round(rec["wall_dispatch"], 6),
                               flush_id=flush_id, bucket=bucket,
                               n_real=n_real, pad_fraction=pad_fraction,
                               device_ms=round(device_ms, 4),
                               queue_depth=rec.get("queue_depth"),
                               error=rec["error"], **extra)
            return
        spans = []
        for (trace_id, wall_enq, t_enq, t_admit, t_done) in rec["requests"]:
            queue_wait_ms = (t_admit - t_enq) * 1e3
            batch_wait_ms = (t_dispatch - t_admit) * 1e3
            fanout_ms = (t_done - t_device_done) * 1e3
            # end-to-end to device-result availability — the exact value
            # the batcher recorded as serve_latency_ms for this request,
            # so queue + batch + device == latency by construction
            latency_ms = (t_device_done - t_enq) * 1e3
            miss = None
            if self.engine is not None:
                miss = self.engine.record_request(
                    latency_ms, bucket, queue_wait_ms=queue_wait_ms)
                self.engine.note_arrival(wall_enq)
            if self.hub is not None:
                for name, v in (("serve_queue_wait_ms", queue_wait_ms),
                                ("serve_batch_wait_ms", batch_wait_ms),
                                ("serve_fanout_ms", fanout_ms)):
                    self.hub.observe(name, v)
                    self.hub.observe(name, v, bucket=bucket)
            if self.sample and trace_id % self.sample == 0:
                spans.append({
                    "trace_id": trace_id, "flush_id": flush_id,
                    "bucket": bucket,
                    "ts": round(wall_enq, 6),
                    "queue_wait_ms": round(queue_wait_ms, 4),
                    "batch_wait_ms": round(batch_wait_ms, 4),
                    "device_ms": round(device_ms, 4),
                    "fanout_ms": round(fanout_ms, 4),
                    "latency_ms": round(latency_ms, 4),
                    "deadline_miss": miss,
                    **extra,
                })
        if self.hub is not None:
            # flush-level span: ALWAYS recorded (one per device call);
            # ts pinned to the dispatch wall time so the trace exporter
            # gets faithful geometry despite the deferred emission
            self.hub.event("serve_flush", ts=round(rec["wall_dispatch"], 6),
                           flush_id=flush_id, bucket=bucket, n_real=n_real,
                           pad_fraction=pad_fraction,
                           device_ms=round(device_ms, 4),
                           queue_depth=rec.get("queue_depth"), **extra)
            for span in spans:
                self.hub.event("serve_request_span", **span)


def write_slo_json(path: str, doc: Dict) -> str:
    """Atomic ``slo.json`` write (same contract as metrics.json)."""
    from .sinks import write_atomic_json

    return write_atomic_json(path, doc)
