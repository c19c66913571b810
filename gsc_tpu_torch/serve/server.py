"""PolicyServer: the learned tier or the SPR tier behind the micro-batcher.

The port of ``gsc_tpu.serve.server.PolicyServer`` without the artifact
cache (the port has no serialized program to store: its kernels are built
once into ``gsc_tpu_torch/_build/``).  Lifecycle of one server:

1. ``start()`` warms every bucket of the learned tier with one call (the
   kernel build and first launch happen there, never inside a request's
   latency; with a cost ledger, ``perf``, that call is observed as
   ``serve_policy_b<B>``), starts the micro-batcher, the tracer and SLO
   engine when given, and the hot-swap watcher when given a directory,
   and emits
   ``serve_start`` (tier, buckets, mode, per-bucket ``prepare_s``, the
   served weights' fingerprint);
2. ``submit(obs)`` returns a :class:`~gsc_tpu_torch.serve.batcher.ServeFuture`;
   ``submit_sync`` blocks;
3. ``close()`` stops the watcher, drains the queue, drains the tracer,
   emits the final ``serve_stats``, writes ``slo.json`` (``slo_path``) and
   gives the ledger each bucket's device calls and their wall (the
   ``serve_batch_ms`` histogram: one observation per dispatch).

``serve_stats`` events (every ``stats_interval`` completed requests and at
close) carry requests, requests/s, p50/p99 overall and per bucket,
occupancy, queue depth, and under tracing the rejections, the latency
decomposition per bucket and the SLO snapshot; a fleet worker's carry its
``worker`` id and its own request count.  ``tools/obs_report.py`` renders
them as the serving section.

Hot swap: :meth:`apply_weights` stages a published version off the lock
(on the worker's stream), then swaps it in under the batcher's
``flush_lock``, between two dispatches, and bumps ``policy_version``;
every flush stamps the version it ran under.  Without a learned policy
the server runs the SPR tier
(:class:`~gsc_tpu_torch.serve.fallback.SPRFallbackPolicy`) through the
same batcher and accounting; a published single leaf shaped like its
action replaces the action, anything else moves the version stamp only.

``graph_mode`` is the served agent's observation mode, as the JAX
server carries it (there it keys the artifact cache, which the port does
not have): a learned policy whose template holds the other kind of
observation is refused.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .batcher import MicroBatcher, ServeFuture
from .fallback import SPRFallbackPolicy
from .policy import GreedyServePolicy, policy_fn_name

log = logging.getLogger("gsc_tpu_torch.serve.server")


class PolicyServer:
    """One serving process: the learned tier (``policy``) or the SPR
    tier (``fallback``) behind a micro-batcher."""

    def __init__(self, policy: Optional[GreedyServePolicy] = None, *,
                 fallback: Optional[SPRFallbackPolicy] = None,
                 buckets: Sequence[int] = (1, 4, 8),
                 deadline_ms: float = 5.0, fingerprint: str = "none",
                 hub=None, stats_interval: int = 50, max_queue: int = 4096,
                 tracer=None, slo=None, slo_path: Optional[str] = None,
                 mode: str = "deadline", worker: Optional[str] = None,
                 hot_swap_dir: Optional[str] = None,
                 swap_poll_s: float = 0.2, wall_clock=time.time,
                 perf=None, graph_mode: bool = True):
        if (policy is None) == (fallback is None):
            raise ValueError("exactly one of policy (the learned tier) or "
                             "fallback (the SPR tier) is required")
        graph = getattr(getattr(policy, "template", None), "graph",
                        graph_mode)
        if graph != graph_mode:
            raise ValueError(
                f"a graph_mode {str(graph_mode).lower()} server was given a "
                f"policy over {'graph' if graph else 'flat'} observations")
        self.graph_mode = graph_mode
        self.policy = policy
        self.fallback = fallback
        self.tier = "learned" if policy is not None else "spr"
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.deadline_ms = float(deadline_ms)
        self.fingerprint = fingerprint
        self.hub = hub
        # request-path tracing and the SLO engine (obs.slo); the engine is
        # made in start() when a tracer is attached; slo_path: where
        # close() writes slo.json (None: not written)
        self.tracer = tracer
        self.slo = slo
        self.slo_path = slo_path
        self.slo_engine = None
        self.stats_interval = max(int(stats_interval), 1)
        self.max_queue = max_queue
        self.mode = mode
        # fleet worker id: tags the queue-depth gauge, the per-worker
        # counters and the serve_start/serve_stats/weight_swap events
        self.worker = worker
        self._wtag = {"worker": worker} if worker else {}
        self.hot_swap_dir = hot_swap_dir
        self.swap_poll_s = swap_poll_s
        # the device-cost ledger (obs.perf.CostLedger) or None
        self.perf = perf
        self.wall_clock = wall_clock
        self.watcher = None
        self.policy_version = 0
        self.swaps = 0
        self.batcher: Optional[MicroBatcher] = None
        self.startup: Dict = {}
        # (n_real, bucket) of every dispatched batch, in order
        self.flushes: List[Tuple[int, int]] = []
        self._occupancy: Dict[int, int] = {}
        self._completed = 0
        self._last_stats_at = 0
        self._t_started = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "PolicyServer":
        t0 = time.perf_counter()
        per_bucket: Dict[str, Dict] = {}
        if self.tier == "learned":
            for b in self.buckets:
                tb = time.perf_counter()
                with self._observe(b):
                    self.policy.warm(b)
                per_bucket[str(b)] = {
                    "prepare_s": round(time.perf_counter() - tb, 3)}
            run_batch = self._run_learned
            template = self.policy.template
        else:
            run_batch = self.fallback.run_batch
            template = self.fallback.template
        if self.tracer is not None:
            from ..obs.slo import SLOEngine
            self.slo_engine = SLOEngine(deadline_ms=self.deadline_ms,
                                        objectives=self.slo, hub=self.hub,
                                        tags=self._wtag)
            self.tracer.bind_engine(self.slo_engine)
            self.tracer.start()
        self.batcher = MicroBatcher(
            run_batch, template, buckets=self.buckets,
            deadline_ms=self.deadline_ms, hub=self.hub,
            max_queue=self.max_queue, on_flush=self._on_flush,
            tracer=self.tracer, mode=self.mode, worker=self.worker,
            version_provider=lambda: self.policy_version).start()
        if self.hub is not None:
            # the /metrics endpoint snapshots the hub on every scrape: a
            # live probe keeps the queue depth current between samples
            batcher = self.batcher
            self.hub.live_gauge("serve_queue_depth",
                                lambda: batcher.queue_depth, **self._wtag)
        if self.hot_swap_dir is not None:
            from .fleet import VersionWatcher
            self.watcher = VersionWatcher(self.hot_swap_dir, self,
                                          poll_s=self.swap_poll_s,
                                          hub=self.hub).start()
        self._t_started = time.perf_counter()
        self.startup = {"tier": self.tier,
                        "startup_s": round(self._t_started - t0, 3),
                        "buckets": per_bucket}
        if self.hub is not None:
            self.hub.event("serve_start", tier=self.tier,
                           buckets=list(self.buckets),
                           deadline_ms=self.deadline_ms, mode=self.mode,
                           startup_s=self.startup["startup_s"],
                           bucket_prepare=per_bucket,
                           fingerprint=self.fingerprint,
                           **({"worker": self.worker, "hot_swap_dir":
                               self.hot_swap_dir} if self.worker
                              or self.hot_swap_dir else {}))
        return self

    def close(self):
        if self.watcher is not None:
            # stop watching before the drain: a swap landing mid-teardown
            # has nothing left to serve
            self.watcher.stop()
            self.watcher = None
        if self.batcher is not None:
            self.batcher.stop()
            self.batcher = None
        if self.hub is not None:
            self.hub.drop_live_gauge("serve_queue_depth", **self._wtag)
            self.hub.gauge("serve_queue_depth", 0, **self._wtag)
        if self.tracer is not None:
            # the final drain before the final stats event, so the last
            # flushes' spans and SLO updates are in it
            self.tracer.stop()
        self._emit_stats(final=True)
        if self.slo_engine is not None and self.slo_path is not None:
            from ..obs.slo import write_slo_json
            try:
                write_slo_json(self.slo_path, self._slo_doc())
            except OSError as e:   # a full disk must not mask teardown
                log.warning("slo.json not written to %s: %s",
                            self.slo_path, e)
        if self.perf is not None and self.hub is not None \
                and self.tier == "learned":
            # each bucket's device calls: serve_batch_ms wraps one run_batch
            # per observation, so `dispatches` counts device calls, not
            # requests; its wall includes the host staging around the call
            # (the MFU is a serving lower bound).  Buckets that never
            # flushed get no timing.
            for b in self.buckets:
                h = self.hub.histogram_summary("serve_batch_ms", bucket=b)
                if h and h.get("count"):
                    self.perf.note_timing(policy_fn_name(b), h["sum"] / 1e3,
                                          int(h["count"]))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------ requests
    def submit(self, obs) -> ServeFuture:
        if self.batcher is None:
            raise RuntimeError("PolicyServer not started")
        return self.batcher.submit(obs)

    def submit_sync(self, obs, timeout: Optional[float] = 60.0):
        return self.submit(obs).result(timeout)

    @property
    def queue_depth(self) -> int:
        return self.batcher.queue_depth if self.batcher is not None else 0

    # ------------------------------------------------------------ hot-swap
    def apply_weights(self, leaves, version: int, fingerprint: str,
                      meta: Optional[Dict] = None):
        """Swap a published weight version in, between two dispatches.

        Learned tier: ``leaves`` (host arrays in the served actor's
        state-dict order) must match its shapes and dtypes, else this
        raises and the served weights stay as they are.  Staging (the
        host-to-device copies, on the worker's stream) happens before
        the flush lock is taken; the lock is held for the reference swap
        only.  SPR tier: a single leaf shaped like the precomputed action
        replaces it; any other payload moves the version stamp only.
        No request is dropped: the queue is never touched, and each
        dispatch stamps the version it ran under."""
        t0 = time.perf_counter()
        staged_actor = staged_action = None
        if self.tier == "learned":
            staged_actor = self.policy.stage(leaves, version)
        else:
            action = self.fallback.action
            if len(leaves) == 1 and tuple(np.asarray(leaves[0]).shape) \
                    == tuple(action.shape):
                staged_action = np.asarray(leaves[0]).astype(action.dtype)
        lock = self.batcher.flush_lock if self.batcher is not None else None
        if lock is not None:
            lock.acquire()
        try:
            if staged_actor is not None:
                self.policy.swap(staged_actor)
            if staged_action is not None:
                self.fallback.action = staged_action
            self.policy_version = int(version)
            self.fingerprint = fingerprint
        finally:
            if lock is not None:
                lock.release()
        self.swaps += 1
        swap_ms = (time.perf_counter() - t0) * 1e3
        if self.hub is not None:
            self.hub.counter("serve_weight_swaps_total", **self._wtag)
            self.hub.gauge("serve_policy_version", version, **self._wtag)
            self.hub.event(
                "weight_swap", version=int(version),
                fingerprint=fingerprint, tier=self.tier,
                swap_ms=round(swap_ms, 3),
                weights_applied=bool(staged_actor is not None
                                     or staged_action is not None),
                requests_in_flight=self.queue_depth,
                **({"worker": self.worker} if self.worker else {}),
                **({"meta": meta} if meta else {}))

    # ------------------------------------------------------------ internals
    def _observe(self, bucket: int):
        """The cost ledger's context for a call at ``bucket``."""
        if self.perf is None:
            return contextlib.nullcontext()
        return self.perf.observe(policy_fn_name(bucket),
                                 device=self.policy.ddpg.device)

    def _run_learned(self, leaves, n_real: int, bucket: int) -> np.ndarray:
        return self.policy.run_batch(leaves)

    def _on_flush(self, n_real: int, bucket: int):
        self.flushes.append((n_real, bucket))
        self._occupancy[bucket] = self._occupancy.get(bucket, 0) + n_real
        self._completed += n_real
        if self._completed - self._last_stats_at >= self.stats_interval:
            self._last_stats_at = self._completed
            self._emit_stats()

    def latency_summary(self, bucket: Optional[int] = None):
        if self.hub is None:
            return None
        tags = {"bucket": bucket} if bucket is not None else {}
        return self.hub.histogram_summary("serve_latency_ms", **tags)

    def _rejected_totals(self) -> Dict[str, int]:
        if self.hub is None:
            return {}
        return {reason: int(self.hub.get_counter("serve_rejected_total",
                                                 reason=reason))
                for reason in ("queue_full", "stopping")}

    def _decomposition(self) -> Dict[str, Dict[str, float]]:
        """Per-bucket means of the latency split: queue wait, batch
        formation, device call (``serve_batch_ms``), fan-out."""
        if self.hub is None:
            return {}
        out: Dict[str, Dict[str, float]] = {}
        for b in self.buckets:
            row = {}
            for metric, key in (("serve_queue_wait_ms", "queue_ms"),
                                ("serve_batch_wait_ms", "batch_ms"),
                                ("serve_batch_ms", "device_ms"),
                                ("serve_fanout_ms", "fanout_ms")):
                s = self.hub.histogram_summary(metric, bucket=b)
                if s and s.get("count"):
                    row[key] = round(s["mean"], 4)
            if row:
                out[str(b)] = row
        return out

    def slo_summary(self) -> Optional[Dict]:
        """The SLO verdict of the CLI's JSON (``slo.json`` is the full
        document)."""
        if self.slo_engine is None:
            return None
        snap = self.slo_engine.snapshot()
        out = {k: snap.get(k) for k in
               ("requests", "deadline_misses", "deadline_miss_ratio",
                "attainment", "burn_rate", "pad_waste",
                "queue_wait_frac", "arrival_rate_rps", "rejected")}
        out["p99_target_ms"] = (snap.get("objectives") or {}).get("p99_ms")
        return out

    def _slo_doc(self) -> Dict:
        """``slo.json``: the engine snapshot with the serving context, the
        latency decomposition and the overall percentiles."""
        from ..obs.slo import SLO_SCHEMA_VERSION

        lat = self.latency_summary() or {}
        doc = {
            "schema_version": SLO_SCHEMA_VERSION,
            "ts": round(self.wall_clock(), 3),
            "run": (self.hub.base_tags.get("run")
                    if self.hub is not None else None),
            "tier": self.tier,
            "buckets": list(self.buckets),
            "requests_completed": self._completed,
            "p50_latency_ms": round(lat.get("p50", 0.0), 4),
            "p99_latency_ms": round(lat.get("p99", 0.0), 4),
            "decomposition_ms": self._decomposition(),
            "spans_dropped": (self.tracer.spans_dropped
                              if self.tracer is not None else 0),
        }
        doc.update(self.slo_engine.snapshot())
        return doc

    def _emit_stats(self, final: bool = False):
        if self.hub is None:
            return
        elapsed = (time.perf_counter() - self._t_started) \
            if self._t_started else 0.0
        lat = self.latency_summary() or {}
        per_bucket = {}
        for b in self.buckets:
            s = self.latency_summary(b)
            if s:
                per_bucket[str(b)] = {"p50_ms": round(s["p50"], 3),
                                      "p99_ms": round(s["p99"], 3),
                                      "requests": int(s["count"])}
        extra = {}
        rejected = self._rejected_totals()
        # a traced run always reports rejections (zeros included); an
        # untraced one once there was one
        if self.tracer is not None or any(rejected.values()):
            extra["rejected"] = rejected
        if self.tracer is not None:
            extra["decomposition"] = self._decomposition()
            if self.slo_engine is not None:
                snap = self.slo_engine.snapshot()
                extra["slo"] = {
                    k: snap.get(k) for k in
                    ("deadline_miss_ratio", "deadline_misses",
                     "attainment", "burn_rate", "arrival_rate_rps",
                     "pad_waste", "queue_wait_frac")}
                extra["slo"]["p99_target_ms"] = \
                    (snap.get("objectives") or {}).get("p99_ms")
        if self.worker:
            # the untagged histograms are fleet-wide, so `requests` below
            # is too; the worker's own count rides beside it
            extra["worker"] = self.worker
            extra["worker_requests"] = self._completed
        if self.policy_version or self.swaps:
            extra["policy_version"] = self.policy_version
            extra["swaps"] = self.swaps
        self.hub.event(
            "serve_stats", tier=self.tier, final=final,
            requests=self._completed,
            rps=round(self._completed / elapsed, 3) if elapsed else 0.0,
            p50_ms=round(lat.get("p50", 0.0), 3),
            p99_ms=round(lat.get("p99", 0.0), 3),
            mean_ms=round(lat.get("mean", 0.0), 3),
            max_ms=round(lat.get("max", 0.0), 3),
            queue_depth=int(self.hub.get_gauge("serve_queue_depth",
                                               **self._wtag) or 0),
            occupancy={str(b): n for b, n in
                       sorted(self._occupancy.items())},
            buckets=per_bucket, **extra)
