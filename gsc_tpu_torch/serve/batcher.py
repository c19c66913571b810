"""Request micro-batcher: a thread-safe queue behind two batching
disciplines.

The port of ``gsc_tpu.serve.batcher``.  Requests land on a bounded queue
and are folded into bucketed device batches under one of two modes:

- ``mode="deadline"`` (the default): one consumer thread takes the oldest
  queued request and keeps admitting requests until it has waited
  ``deadline_ms`` or the largest bucket is full;
- ``mode="continuous"``: requests never wait out a deadline.  The
  consumer admits whatever is queued into a pending list and seals the
  next batch (stack and pad) the moment the device frees, handing it to
  a dispatcher thread through a depth-1 channel; the dispatcher answers
  with a "device freed" token on the request queue.  What arrives during
  an in-flight call becomes the next batch; a lone request on an idle
  device goes at once.  A serial client gets the same device calls, and
  the same answers bit for bit, in both modes.

A batch runs in the smallest bucket that fits it, padded by repeating the
last real request, and the answers are sliced back per request; rows
never interact.  Accounting flows into a
:class:`~gsc_tpu_torch.obs.MetricsHub`:

- ``serve_latency_ms`` histogram (overall and per bucket),
- ``serve_batch_ms`` device-call histogram per bucket,
- ``serve_requests_total`` / ``serve_batches_total{bucket=..}``,
- ``serve_rejected_total{reason=queue_full|stopping}``, counted before
  the error reaches the caller,
- ``serve_queue_depth``, sampled at every submit and every flush.

With ``worker=`` (a fleet worker id) the queue-depth gauge is tagged
``worker=`` and per-worker request/batch counters land beside the
untagged fleet totals.  Every dispatch runs under ``flush_lock``, and the
version ``version_provider`` reports is read under it: a hot-swap takes
the same lock, so no batch mixes policy versions, and the version stamped
on each future is the one its device call read.  With a
:class:`~gsc_tpu_torch.obs.slo.ServeTracer` attached, each dispatch hands
its timestamps over as one record; the tracer's drainer thread does the
rest.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .policy import ObsTemplate

BATCH_MODES = ("deadline", "continuous")


class ServeError(RuntimeError):
    """The device call answering this request failed (the error is
    replicated into every affected request's future)."""


class ServeFuture:
    """Minimal future for one request: blocks on ``result`` until the
    batcher fills it (or raises what the device call raised).

    Span timestamps (``time.perf_counter`` for intervals, one wall-clock
    ``time.time`` at enqueue for trace geometry) are stamped as the
    request moves: enqueue here, batch admission in the consumer loop,
    completion after the device result fans out.  Stamping is
    unconditional — timestamps are the only work the tracing contract
    allows on the serve path, and they cost nanoseconds.  Every stamp a
    done future exposes is written BEFORE ``_event.set()``: a waiter (or
    a racing reader building a trace record) that observes ``done()``
    must never see a half-stamped future."""

    __slots__ = ("_event", "_result", "_error", "t_enqueued",
                 "wall_enqueued", "t_admitted", "t_completed", "trace_id",
                 "policy_version", "bucket")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self.t_enqueued = time.perf_counter()
        self.wall_enqueued = time.time()
        self.t_admitted: Optional[float] = None
        self.t_completed: Optional[float] = None
        self.trace_id: int = -1
        # the policy version whose device call answered this request
        # (stamped under the flush lock at dispatch; None when the
        # backend declares no versions — raw MicroBatcher use)
        self.policy_version: Optional[int] = None
        # the bucket of the device call that answered it (stamped with
        # the version)
        self.bucket: Optional[int] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("serve request still queued after "
                               f"{timeout}s")
        if self._error is not None:
            raise ServeError(str(self._error)) from self._error
        return self._result


_STOP = object()
# dispatcher -> consumer "device freed" token (continuous mode): rides
# the request queue so the consumer has ONE blocking wait point
_FREE = object()


class MicroBatcher:
    """A bounded request queue behind one of two batching disciplines.

    ``run_batch(leaves, n_real, bucket) -> np.ndarray [bucket, A]`` is the
    execution backend (the server's learned tier or the SPR tier); ``leaves`` are the bucket-stacked obs arrays.
    """

    def __init__(self, run_batch: Callable, template: ObsTemplate,
                 buckets: Sequence[int] = (1, 4, 8),
                 deadline_ms: float = 5.0, hub=None,
                 max_queue: int = 4096,
                 on_flush: Optional[Callable[[int, int], None]] = None,
                 tracer=None, mode: str = "deadline",
                 worker: Optional[str] = None,
                 version_provider: Optional[Callable[[], int]] = None):
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"buckets must be positive ints: {buckets!r}")
        if mode not in BATCH_MODES:
            raise ValueError(f"mode must be one of {BATCH_MODES}: {mode!r}")
        self.run_batch = run_batch
        self.template = template
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.deadline_s = float(deadline_ms) / 1e3
        self.hub = hub
        self.on_flush = on_flush
        self.mode = mode
        # fleet worker id: moves the queue-depth gauge to a worker-tagged
        # series and adds per-worker request/batch counters (None = the
        # historic single-server series, untouched)
        self.worker = worker
        self._wtag = {"worker": worker} if worker else {}
        # current-policy-version probe, read under flush_lock at each
        # dispatch so the stamped version IS the version the device call
        # used (None = unversioned backend)
        self.version_provider = version_provider
        # obs.slo.ServeTracer (or None): receives one compact record per
        # flush + rejection notes; all span math/emission happens on ITS
        # drainer thread, never here
        self.tracer = tracer
        self._next_trace_id = 0   # guarded-by: self._submit_lock
        # backpressure is enforced by the WAITING counter, not the queue
        # bound: continuous mode drains the queue into its pending list
        # continuously (the _FREE token must never be stuck behind a
        # backlog), so a bounded queue alone would never fill there —
        # max_queue would silently stop rejecting and queue_depth would
        # read ~0 under exactly the overload that routing/brownout key
        # on.  _waiting counts accepted requests not yet handed to a
        # device dispatch, wherever they sit (queue, pending list,
        # prepared slot); submit rejects when it reaches max_queue.
        self.max_queue = int(max_queue)
        self._waiting = 0   # guarded-by: self._submit_lock
        self._q: "queue.Queue" = queue.Queue()
        # continuous mode: depth-1 channel of PREPARED (stacked+padded)
        # batches between the forming consumer and the dispatcher thread —
        # one batch on the device, one formed and waiting, the rest queued
        self._slot: "queue.Queue" = queue.Queue(maxsize=1)
        # serializes every device dispatch against weight hot-swaps: the
        # VersionWatcher swaps params under this lock, so a swap lands
        # between device calls and no batch mixes policy versions
        self.flush_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False   # guarded-by: self._submit_lock
        # serializes submit's check+enqueue against stop's flag+sentinel:
        # an accepted request is therefore ALWAYS queued ahead of _STOP,
        # so it is served by the drain — without this, a submit that
        # passed the flag check could enqueue after the consumer exited
        # and its future would hang until the client timeout
        self._submit_lock = threading.Lock()

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "MicroBatcher":
        if self._thread is None:
            target = self._loop if self.mode == "deadline" \
                else self._loop_continuous
            self._thread = threading.Thread(target=target,
                                            name="gsc-serve-batcher",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        """Drain-then-stop: requests queued before the stop are still
        answered; a ``submit`` racing it either lands ahead of the stop
        sentinel (and is served) or raises ServeError at the call site —
        never a silent until-timeout hang (the submit lock makes those
        the only two outcomes)."""
        if self._thread is None:
            return
        with self._submit_lock:
            self._stopping = True
            self._q.put(_STOP)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise ServeError(f"batcher thread did not stop within {timeout}s")
        self._thread = None

    @property
    def queue_depth(self) -> int:
        """Accepted requests not yet handed to a device dispatch —
        honest in both modes (continuous mode's pending list is part of
        the backlog; the raw queue size is not the whole story there).

        Lock-free monitoring read: a torn int is impossible under the
        GIL and a one-update-stale depth is fine for gauges and
        routing."""
        return self._waiting  # gsc-lint: disable=R7 -- racy monitoring read, staleness tolerated

    # -------------------------------------------------------------- submit
    def submit(self, obs) -> ServeFuture:
        """Enqueue one request (any obs pytree matching the template).
        Template validation happens HERE, in the caller's thread — a
        malformed request raises at the call site and never reaches the
        shared device path.  A rejection (stopping / queue full) bumps
        ``serve_rejected_total{reason=..}`` BEFORE raising, so overload
        shows up in serve_stats and /metrics instead of vanishing into
        client-side exceptions."""
        leaves = self.template.flatten(obs)
        fut = ServeFuture()
        with self._submit_lock:
            if self._stopping:
                self._note_rejection("stopping", fut)
                raise ServeError("batcher is stopping — request rejected")
            if self._waiting >= self.max_queue:
                self._note_rejection("queue_full", fut)
                raise ServeError(
                    f"serve queue full ({self.max_queue} requests "
                    "waiting) — backpressure: retry or add capacity")
            fut.trace_id = self._next_trace_id
            self._next_trace_id += 1
            self._waiting += 1
            self._q.put((fut, leaves))
        # live depth between flushes: the flush-side sample alone reads
        # stale while requests pile up or the queue sits idle
        if self.hub is not None:
            self.hub.gauge("serve_queue_depth", self._waiting,  # gsc-lint: disable=R7 -- racy monitoring read, staleness tolerated
                           **self._wtag)
        return fut

    def _note_rejection(self, reason: str, fut: ServeFuture):
        if self.hub is not None:
            self.hub.counter("serve_rejected_total", reason=reason)
            if self.worker:
                self.hub.counter("serve_rejected_total", reason=reason,
                                 **self._wtag)
            self.hub.gauge("serve_queue_depth", self._waiting,  # gsc-lint: disable=R7 -- racy monitoring read, staleness tolerated
                           **self._wtag)
        if self.tracer is not None:
            self.tracer.note_rejection(reason, fut.wall_enqueued)

    # ------------------------------------------------------- deadline loop
    def _loop(self):
        while True:
            item = self._q.get()
            if item is _STOP:
                break
            item[0].t_admitted = time.perf_counter()
            batch: List[Tuple[ServeFuture, List[np.ndarray]]] = [item]
            deadline = item[0].t_enqueued + self.deadline_s
            stop_after = False
            while len(batch) < self.buckets[-1]:
                remaining = deadline - time.perf_counter()
                try:
                    if remaining <= 0:
                        # deadline already spent (e.g. the previous device
                        # call outlasted it): still DRAIN what is already
                        # queued, non-blocking — otherwise overload
                        # degenerates to bucket-1 flushes exactly when
                        # batching matters most
                        nxt = self._q.get_nowait()
                    else:
                        nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop_after = True
                    break
                nxt[0].t_admitted = time.perf_counter()
                batch.append(nxt)
            self._flush(batch)
            if stop_after:
                break
        self._fail_leftovers()

    # ----------------------------------------------------- continuous loop
    def _loop_continuous(self):
        """Join-the-next-dispatch batching: this thread admits requests
        into a pending list continuously and SEALS a batch (stack + pad
        + hand to the dispatcher thread) the moment the device frees —
        so everything that arrived during the in-flight call becomes the
        next batch, and a lone request on an idle device dispatches
        immediately instead of waiting a deadline out.  A full bucket
        forming mid-flight seals early, so its host-side copies overlap
        the running device call.

        The seal-on-free discipline is what keeps continuous mode from
        degenerating: sealing eagerly whenever ANYTHING is pending would
        split staggered closed-loop arrivals into bucket-1 dispatches
        (measured: ~2.5x throughput loss) — batching must be paced by
        the device, not by the consumer thread's wake-up latency.

        The dispatcher signals completion by pushing a ``_FREE`` token
        through the request queue, giving this thread a single blocking
        wait point (new request | device freed | stop)."""
        dispatcher = threading.Thread(target=self._dispatch_loop,
                                      name="gsc-serve-dispatcher",
                                      daemon=True)
        dispatcher.start()
        pending: List[Tuple[ServeFuture, List[np.ndarray]]] = []
        device_free = True
        stopping = False
        while not (stopping and not pending and device_free):
            item = self._q.get()
            while True:
                if item is _STOP:
                    stopping = True
                elif item is _FREE:
                    device_free = True
                else:
                    item[0].t_admitted = time.perf_counter()
                    pending.append(item)
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
            # full batches formed while a call is in flight seal NOW:
            # their stack+pad copies overlap the running device call
            # (single producer, so the full() check cannot race)
            while len(pending) >= self.buckets[-1] \
                    and not self._slot.full():
                device_free = self._seal(pending)
            if pending and device_free:
                # the device just freed (or is idle): whatever arrived
                # joins this dispatch — never waits a deadline out
                device_free = self._seal(pending)
        self._slot.put(_STOP)
        dispatcher.join()
        self._fail_leftovers()

    def _seal(self, pending) -> bool:
        """Pop up to one largest-bucket's worth of pending requests,
        stack them, and hand the prepared batch to the dispatcher.
        Returns the new ``device_free`` state (always False): EVERY seal
        consumes the free token — leaving it True after an early seal
        would (a) let the next lone arrival seal into a degenerate
        bucket-1 dispatch behind the in-flight call, and (b) allow a
        second blocking ``_slot.put`` while the dispatcher can be
        blocked publishing ``_FREE`` into a full request queue — a
        mutual-block deadlock under exactly the overload the brownout
        tier is built for.  With the token consumed, a device_free seal
        only ever runs after a ``_FREE`` was received, i.e. when the
        dispatcher has already finished its queue put and is guaranteed
        to reach ``_slot.get`` — so this put can wait at most one
        slot-handoff, never forever."""
        batch = pending[:self.buckets[-1]]
        del pending[:self.buckets[-1]]
        k = len(batch)
        bucket = next(b for b in self.buckets if b >= k)
        stacked = self.template.stack_pad(
            [leaves for _, leaves in batch], bucket)
        self._slot.put((batch, stacked, k, bucket))
        return False

    def _dispatch_loop(self):
        while True:
            job = self._slot.get()
            if job is _STOP:
                return
            batch, stacked, k, bucket = job
            self._dispatch(batch, stacked, k, bucket)
            # wake the consumer: the device is free, seal the next batch
            # (rides the request queue so the consumer's single get()
            # sees it; the queue is effectively unbounded for the one
            # in-flight token)
            self._q.put(_FREE)

    def _fail_leftovers(self):
        # backstop: the submit lock means no future can land behind the
        # stop sentinel, but fail anything that somehow did (e.g. a second
        # _STOP from a double stop()) instead of hanging its client
        while True:
            try:
                leftover = self._q.get_nowait()
            except queue.Empty:
                return
            if leftover is _STOP or leftover is _FREE:
                continue
            fut, _ = leftover
            fut._error = ServeError("batcher stopped before this request "
                                    "was served")
            fut._event.set()

    # ------------------------------------------------------------ dispatch
    def _flush(self, batch):
        k = len(batch)
        bucket = next(b for b in self.buckets if b >= k)
        stacked = self.template.stack_pad([leaves for _, leaves in batch],
                                          bucket)
        self._dispatch(batch, stacked, k, bucket)

    def _dispatch(self, batch, stacked, k, bucket):
        # these k requests stop waiting now (dispatching, not backlog)
        with self._submit_lock:
            self._waiting -= k
        wall_dispatch = time.time()
        with self.flush_lock:
            # read the version INSIDE the lock: a hot-swap also runs
            # under flush_lock, so this is exactly the version the
            # device call below reads — the whole batch is answered by
            # one policy version, never a mix
            version = self.version_provider() \
                if self.version_provider is not None else None
            t0 = time.perf_counter()
            try:
                # holding flush_lock across the device call, readback
                # included, IS the hot-swap contract — apply_weights
                # runs under the same lock, so a swap can never land
                # mid-flush and the version stamped above is exactly
                # the one the device computed with.  The cost (other
                # dispatchers stall one device round-trip) is the
                # design: one in-flight batch per worker.
                out = self.run_batch(stacked, k, bucket)  # gsc-lint: disable=R9 -- flush_lock-across-device-call is the hot-swap contract
                err = None
            except BaseException as e:  # noqa: BLE001 - replicated below
                err = e
            now = time.perf_counter()
        if err is not None:
            for fut, _ in batch:
                fut.policy_version = version
                fut.bucket = bucket
                fut._error = err
                # same stamp-before-set contract as the success path: a
                # done future never exposes t_completed=None, errored or
                # not (the tracer's failed-flush record still carries
                # None per request — there is no completion to decompose)
                fut.t_completed = time.perf_counter()
                fut._event.set()
            if self.hub is not None:
                self.hub.counter("serve_errors_total")
            if self.tracer is not None:
                # a failed device call must BURN the SLO budget, not
                # vanish from it: the engine counts these requests as
                # deadline misses / objective violations (they were
                # never answered), so attainment and the gated slo_*
                # metrics degrade with real serving failures
                self.tracer.record_flush({
                    "bucket": bucket, "n_real": k,
                    "wall_dispatch": wall_dispatch,
                    "t_dispatch": t0,
                    "t_device_done": now,
                    "queue_depth": self._waiting,  # gsc-lint: disable=R7 -- racy monitoring read, staleness tolerated
                    "policy_version": version,
                    "worker": self.worker,
                    "error": f"{type(err).__name__}: {err}",
                    "requests": [(fut.trace_id, fut.wall_enqueued,
                                  fut.t_enqueued, fut.t_admitted, None)
                                 for fut, _ in batch],
                })
            return
        out = np.asarray(out)
        for i, (fut, _) in enumerate(batch):
            fut._result = out[i]
            fut.policy_version = version
            fut.bucket = bucket
            if self.hub is not None:
                lat_ms = (now - fut.t_enqueued) * 1e3
                self.hub.observe("serve_latency_ms", lat_ms)
                self.hub.observe("serve_latency_ms", lat_ms,
                                 bucket=bucket)
            # completion stamp strictly BEFORE the event: a waiter that
            # observes done() (or the tracer record built below) must
            # never read t_completed=None off a finished future
            fut.t_completed = time.perf_counter()
            fut._event.set()
        if self.hub is not None:
            self.hub.counter("serve_requests_total", k)
            self.hub.counter("serve_batches_total", bucket=bucket)
            if self.worker:
                self.hub.counter("serve_requests_total", k, **self._wtag)
                self.hub.counter("serve_batches_total", **self._wtag)
            self.hub.observe("serve_batch_ms", (now - t0) * 1e3,
                             bucket=bucket)
            self.hub.gauge("serve_queue_depth", self._waiting,  # gsc-lint: disable=R7 -- racy monitoring read, staleness tolerated
                           **self._wtag)
        if self.tracer is not None:
            # deferred span emission: hand over the raw timestamps as one
            # record (plain floats, O(batch) appends) — the tracer's
            # drainer thread derives the queue/batch/device/fan-out
            # decomposition and emits the events off this thread.
            # `now` doubles as the device-done stamp, so the tracer's
            # reconstructed latency equals the serve_latency_ms values
            # recorded above exactly.
            self.tracer.record_flush({
                "bucket": bucket, "n_real": k,
                "wall_dispatch": wall_dispatch,
                "t_dispatch": t0, "t_device_done": now,
                "queue_depth": self._waiting,  # gsc-lint: disable=R7 -- racy monitoring read, staleness tolerated
                "policy_version": version,
                "worker": self.worker,
                "requests": [(fut.trace_id, fut.wall_enqueued,
                              fut.t_enqueued, fut.t_admitted,
                              fut.t_completed)
                             for fut, _ in batch],
            })
        if self.on_flush is not None:
            self.on_flush(k, bucket)
