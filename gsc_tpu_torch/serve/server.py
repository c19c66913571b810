"""PolicyServer: the learned serving tier behind the micro-batcher.

The port of the learned tier of ``gsc_tpu.serve.server.PolicyServer``.
``start()`` warms every batch bucket with one call before the first
request (the kernel build and first launch happen there), then starts the
deadline micro-batcher; ``submit(obs)`` returns a
:class:`~gsc_tpu_torch.serve.batcher.ServeFuture`; ``close()`` drains the
queue.  The artifact cache, fleet, hot-swap, SLO tracing and the SPR
fallback tier are not ported.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from .batcher import MicroBatcher, ServeFuture
from .policy import GreedyServePolicy


class PolicyServer:
    def __init__(self, policy: GreedyServePolicy,
                 buckets: Sequence[int] = (1, 4, 8),
                 deadline_ms: float = 5.0, hub=None, max_queue: int = 4096):
        self.policy = policy
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.deadline_ms = float(deadline_ms)
        self.hub = hub
        self.max_queue = max_queue
        self.batcher: Optional[MicroBatcher] = None
        self.startup: Dict = {}
        # (n_real, bucket) of every dispatched batch, in order
        self.flushes: List[Tuple[int, int]] = []

    def start(self) -> "PolicyServer":
        t0 = time.perf_counter()
        per_bucket = {}
        for b in self.buckets:
            tb = time.perf_counter()
            self.policy.warm(b)
            per_bucket[str(b)] = {"prepare_s": time.perf_counter() - tb}
        self.batcher = MicroBatcher(
            self._run, self.policy.template, buckets=self.buckets,
            deadline_ms=self.deadline_ms, hub=self.hub,
            max_queue=self.max_queue, on_flush=self._on_flush).start()
        self.startup = {"startup_s": time.perf_counter() - t0,
                        "buckets": per_bucket}
        return self

    def _run(self, leaves, n_real: int, bucket: int):
        return self.policy.run_batch(leaves)

    def _on_flush(self, n_real: int, bucket: int):
        self.flushes.append((n_real, bucket))

    def close(self):
        if self.batcher is not None:
            self.batcher.stop()
            self.batcher = None

    def submit(self, obs) -> ServeFuture:
        if self.batcher is None:
            raise RuntimeError("PolicyServer not started")
        return self.batcher.submit(obs)

    def latency_summary(self, bucket: Optional[int] = None):
        if self.hub is None:
            return None
        tags = {"bucket": bucket} if bucket is not None else {}
        return self.hub.histogram_summary("serve_latency_ms", **tags)
