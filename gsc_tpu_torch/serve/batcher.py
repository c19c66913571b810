"""Request micro-batcher: a thread-safe queue behind a deadline flush.

The port of the deadline mode of ``gsc_tpu.serve.batcher.MicroBatcher``.
One consumer thread takes the oldest queued request and keeps admitting
requests until it has waited ``deadline_ms`` or the largest bucket is
full; the batch then runs in the smallest bucket that fits it, padded by
repeating the last real request, and the answers are sliced back per
request.  Latency flows into a :class:`~gsc_tpu_torch.obs.MetricsHub`:

- ``serve_latency_ms`` histogram (overall and tagged per bucket),
- ``serve_batch_ms`` device-call histogram per bucket,
- ``serve_requests_total`` / ``serve_batches_total{bucket=..}`` counters,
- ``serve_rejected_total{reason=queue_full|stopping}``,
- ``serve_queue_depth`` gauge at every submit and flush.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .policy import ObsTemplate


class ServeError(RuntimeError):
    """The device call answering this request failed, or the batcher
    refused the request."""


class ServeFuture:
    """Future for one request: ``result`` blocks until the batcher fills
    it (or raises what the device call raised)."""

    __slots__ = ("_event", "_result", "_error", "t_enqueued")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self.t_enqueued = time.perf_counter()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(f"serve request still queued after {timeout}s")
        if self._error is not None:
            raise ServeError(str(self._error)) from self._error
        return self._result


_STOP = object()


class MicroBatcher:
    """A bounded request queue behind the deadline batching discipline.

    ``run_batch(leaves, n_real, bucket) -> np.ndarray [bucket, A]`` is the
    execution backend; ``leaves`` are the bucket-stacked obs arrays.
    """

    def __init__(self, run_batch: Callable, template: ObsTemplate,
                 buckets: Sequence[int] = (1, 4, 8),
                 deadline_ms: float = 5.0, hub=None,
                 max_queue: int = 4096,
                 on_flush: Optional[Callable[[int, int], None]] = None):
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"buckets must be positive ints: {buckets!r}")
        self.run_batch = run_batch
        self.template = template
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.deadline_s = float(deadline_ms) / 1e3
        self.hub = hub
        self.on_flush = on_flush
        self.max_queue = int(max_queue)
        self._waiting = 0        # guarded-by: self._submit_lock
        self._stopping = False   # guarded-by: self._submit_lock
        # serialises submit's check+enqueue against stop's flag+sentinel,
        # so an accepted request is always queued ahead of the sentinel
        self._submit_lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "MicroBatcher":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="gsc-serve-batcher",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        """Drain, then stop: requests queued before the stop are answered."""
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
        """Accepted requests not yet handed to a device call (a racy
        monitoring read)."""
        return self._waiting

    # -------------------------------------------------------------- submit
    def submit(self, obs) -> ServeFuture:
        """Enqueue one request; a malformed request raises here, in the
        caller's thread."""
        leaves = self.template.flatten(obs)
        fut = ServeFuture()
        with self._submit_lock:
            if self._stopping:
                self._note_rejection("stopping")
                raise ServeError("batcher is stopping — request rejected")
            if self._waiting >= self.max_queue:
                self._note_rejection("queue_full")
                raise ServeError(f"serve queue full ({self.max_queue} "
                                 "requests waiting)")
            self._waiting += 1
            depth = self._waiting
            self._q.put((fut, leaves))
        if self.hub is not None:
            self.hub.gauge("serve_queue_depth", depth)
        return fut

    def _note_rejection(self, reason: str):
        if self.hub is not None:
            self.hub.counter("serve_rejected_total", reason=reason)

    # ------------------------------------------------------- deadline loop
    def _loop(self):
        while True:
            item = self._q.get()
            if item is _STOP:
                break
            batch: List[Tuple[ServeFuture, List[np.ndarray]]] = [item]
            deadline = item[0].t_enqueued + self.deadline_s
            stop_after = False
            while len(batch) < self.buckets[-1]:
                remaining = deadline - time.perf_counter()
                try:
                    # past the deadline, still drain what is already queued
                    nxt = (self._q.get_nowait() if remaining <= 0
                           else self._q.get(timeout=remaining))
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop_after = True
                    break
                batch.append(nxt)
            self._flush(batch)
            if stop_after:
                break
        self._fail_leftovers()

    def _fail_leftovers(self):
        while True:
            try:
                leftover = self._q.get_nowait()
            except queue.Empty:
                return
            if leftover is _STOP:
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
        with self._submit_lock:
            self._waiting -= k
        t0 = time.perf_counter()
        try:
            out = self.run_batch(stacked, k, bucket)
            err = None
        except Exception as e:  # noqa: BLE001 - replicated into every future
            out, err = None, e
        now = time.perf_counter()
        for i, (fut, _) in enumerate(batch):
            if err is not None:
                fut._error = err
            else:
                fut._result = out[i]
                if self.hub is not None:
                    lat_ms = (now - fut.t_enqueued) * 1e3
                    self.hub.observe("serve_latency_ms", lat_ms)
                    self.hub.observe("serve_latency_ms", lat_ms,
                                     bucket=bucket)
            fut._event.set()
        if self.hub is not None:
            if err is not None:
                self.hub.counter("serve_errors_total")
            else:
                self.hub.counter("serve_requests_total", k)
                self.hub.counter("serve_batches_total", bucket=bucket)
                self.hub.observe("serve_batch_ms", (now - t0) * 1e3,
                                 bucket=bucket)
            self.hub.gauge("serve_queue_depth", self.queue_depth)
        if err is None and self.on_flush is not None:
            self.on_flush(k, bucket)
