"""RunObserver: the facade one training run reports through.

The port of ``gsc_tpu.obs.run.RunObserver``.  It owns the hub, the
``events.jsonl`` sink, the ``metrics.json`` snapshot cadence, the
watchdog, the optional device-cost ledger (``perf``: an
``obs.perf.CostLedger`` the trainer and the server capture into, written
to ``perf.json`` at close), the compile monitor
(``analysis.sentinels.CompileMonitor``, one ``compile`` event per kernel
library built or loaded while the run is open), the optional learn ledger
(``curves.json`` at close), the series rings (``series.json``) and the
``/metrics`` endpoint; ``run_start`` records whether the ledger and the
monitor are on (``perf``; ``compile_events``, always True).
``out_dir=None`` keeps everything in memory (a
``ListSink`` in ``self.events``) and writes no files: ``cli train``
without ``--result-dir``.  A run on a mesh has one observer, on rank 0;
its ``run_start`` records the canonical ``mesh`` (``"dpxmp"``), the
``partition_rules`` and ``partition_specs`` (``{spec: leaf count}``
over the learner state, ``parallel.partition.spec_summary``), as the
JAX package's does.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

from .device import record_device_gauges
from .hub import MetricsHub
from .sinks import (JsonlSink, ListSink, TailSink, read_events,
                    write_atomic_json)
from .watchdog import PipelineWatchdog

log = logging.getLogger("gsc_tpu_torch.obs.run")

# phases whose per-episode wall deltas are worth percentile tracking
_PHASE_HIST = ("host_sample", "host_sample_wait", "dispatch", "drain",
               "actor_dispatch", "actor_idle", "replay_ingest",
               "learner_idle")


class RunObserver:
    """Per-run observability: hub + JSONL events + atomic snapshots +
    watchdog, all rooted in one output directory."""

    def __init__(self, out_dir: Optional[str], run_id: Optional[str] = None,
                 snapshot_interval: int = 10,
                 watchdog_budget_s: float = 0.0,
                 tags: Optional[Dict[str, object]] = None,
                 watchdog_escalate: int = 0,
                 rotate_mb: float = 0.0,
                 perf: bool = False,
                 learn: bool = False,
                 metrics_port: Optional[int] = None,
                 series_window: int = 0,
                 blackbox_window_s: float = 30.0,
                 clock=None):
        self.out_dir = os.path.abspath(out_dir) if out_dir else None
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
        run_id = run_id or (os.path.basename(self.out_dir.rstrip(os.sep))
                            if self.out_dir else "run")
        hub_kw = {"clock": clock} if clock is not None else {}
        self.hub = MetricsHub(tags={"run": run_id, **(tags or {})},
                              series_window=series_window, **hub_kw)
        path = (lambda name: os.path.join(self.out_dir, name)) \
            if self.out_dir else (lambda name: None)
        self.events_path = path("events.jsonl")
        self.snapshot_path = path("metrics.json")
        self.perf_path = path("perf.json")
        self.curves_path = path("curves.json")
        self.series_path = path("series.json")
        self.blackbox_path = path("blackbox.json")
        # serving's SLO summary: PolicyServer.close() (or the fleet's
        # caller) writes it
        self.slo_path = path("slo.json")
        # no directory: the stream stays in memory
        self.events = None
        if self.out_dir is None:
            self.events = ListSink()
            self.hub.add_sink(self.events)
        # size-based rotation for 100+-episode exhibits (``--obs-rotate-mb``)
        # — readers walk the rotated segments via sinks.rotated_paths
        if self.events_path:
            self.hub.add_sink(JsonlSink(self.events_path,
                                        rotate_mb=rotate_mb))
        # black-box event tail: the last-N pending events a post-mortem
        # dump flushes when the run dies mid-write
        self.blackbox_window_s = float(blackbox_window_s)
        self._tail_sink = None
        if self.hub.series_store is not None:
            self._tail_sink = TailSink()
            self.hub.add_sink(self._tail_sink)
        # device-cost ledger (obs.perf.CostLedger), opt-in because each
        # entry point's first dispatch runs observed (the CLI turns it on
        # with --perf): the trainer and the server capture into it and
        # close() writes perf.json next to metrics.json
        self.perf = None
        if perf:
            from .perf import CostLedger
            self.perf = CostLedger(hub=self.hub)
        # learning-signal ledger (obs.learning.LearnLedger), opt-in: the
        # trainer hands the facade's spec to the agent, drains per-episode
        # signals through it, and close() extracts curves.json from the
        # event stream
        self.learn = None
        if learn:
            from .learning import LearnLedger
            self.learn = LearnLedger(hub=self.hub)
        # live /metrics endpoint (obs.endpoint.MetricsEndpoint): None =
        # off; 0 = ephemeral port (tests); bound lazily in start()
        self._metrics_port = metrics_port
        self.endpoint = None
        self.snapshot_interval = max(int(snapshot_interval), 1)
        self.watchdog: Optional[PipelineWatchdog] = None
        if watchdog_budget_s and watchdog_budget_s > 0:
            # paused until the trainer enters its episode loop — eval /
            # checkpoint time between loops must not read as a pipeline
            # stall.  (The first episode's kernel builds happen inside
            # the loop and do count: a stall with episodes_drained=0
            # carries a note saying so.)
            # escalation (``watchdog_escalate`` extra quiet periods before
            # acting) stays report-only until the trainer installs its
            # ``on_escalate`` hook for the duration of the episode loop
            self.watchdog = PipelineWatchdog(
                self.hub, watchdog_budget_s, start_paused=True,
                escalate_after=watchdog_escalate,
                # a stall that outlives the escalation horizon flushes
                # the black-box dump, so a wedged run leaves a post-mortem
                on_blackbox=lambda thread, age: self.write_blackbox(
                    reason=f"watchdog_escalation:{thread}",
                    extra={"age_s": round(age, 3)}))
        # the kernel-build sentinel (analysis.sentinels.CompileMonitor),
        # started in start()
        self.compile_monitor = None
        self._drained = 0
        self._prev_phase_totals: Dict[str, float] = {}
        self._started = False
        self._closed = False

    # ---------------------------------------------------------- lifecycle
    def start(self, meta: Optional[Dict] = None) -> "RunObserver":
        if self._started:
            return self
        self._started = True
        self.hub.event("run_start", **{"perf": self.perf is not None,
                                       "compile_events": True,
                                       **(meta or {})})
        from ..analysis.sentinels import CompileMonitor
        self.compile_monitor = CompileMonitor(hub=self.hub).start()
        if self.watchdog is not None:
            self.watchdog.start()
        if self._metrics_port is not None:
            # best effort: a taken port must not kill a training run —
            # the run keeps its on-disk snapshots either way
            from .endpoint import MetricsEndpoint
            try:
                self.endpoint = MetricsEndpoint(
                    self.hub, port=self._metrics_port).start()
                self.hub.event("metrics_endpoint",
                               port=self.endpoint.port,
                               url=self.endpoint.url)
            except OSError as e:
                log.warning("metrics endpoint not started on port %s: %s",
                            self._metrics_port, e)
                self.endpoint = None
        return self

    def close(self, status: str = "ok"):
        """Final snapshot + ``run_end`` event; idempotent."""
        if self._closed:
            return
        self._closed = True
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.compile_monitor is not None:
            self.compile_monitor.stop()
        if self.endpoint is not None:
            self.endpoint.stop()
            self.endpoint = None
        try:
            if self.learn is not None and self.curves_path:
                # learning-curve extraction from the run's own event
                # stream (rotation-aware) into schema-versioned
                # curves.json, best effort
                try:
                    from .curves import write_curves
                    events = read_events(self.events_path)
                    if any(e.get("event") in ("episode", "harness_episode")
                           for e in events):
                        write_curves(self.curves_path, events)
                except Exception:
                    pass
            if self.perf is not None and self.perf_path \
                    and self.perf.summary()["entries"]:
                # the run's cost ledger next to metrics.json, best effort:
                # a ledger failure must not mask the run's teardown
                try:
                    self.perf.write_json(self.perf_path)
                except Exception:
                    log.warning("perf.json not written", exc_info=True)
            self.hub.event("run_end", status=status,
                           episodes=self._drained,
                           stalls=self.hub.get_counter("stalls"),
                           recoveries=self.hub.get_counter(
                               "recoveries_total"))
            if self.hub.series_store is not None and self.series_path:
                # whole-run history next to the snapshot, best effort
                try:
                    from .series import write_series
                    write_series(self.series_path, self.hub.series_store,
                                 run=self.hub.base_tags.get("run"))
                except Exception:
                    pass
            if status not in ("ok", "preempted") and self.blackbox_path:
                # a run dying on an exception leaves the same post-mortem
                # a wedged run does (a preempted run is not a failure)
                try:
                    self.write_blackbox(reason=f"run_end:{status}")
                except Exception:
                    pass
            self.write_snapshot()
        finally:
            self.hub.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, *exc):
        self.close(status="error" if exc_type else "ok")
        return False

    # ------------------------------------------------------------ plumbing
    def resume_watchdog(self):
        if self.watchdog is not None:
            self.watchdog.resume()

    def pause_watchdog(self):
        if self.watchdog is not None:
            self.watchdog.pause()

    def watch_fleet(self, names, budget_s: Optional[float] = None):
        """Register the per-thread heartbeats of a decoupled run (the
        actor threads and the learner) with the watchdog for the run's
        duration: a quiet thread's stall event names it and its phase."""
        if self.watchdog is not None:
            for name in names:
                self.watchdog.watch_thread(name, budget_s=budget_s)

    def unwatch_fleet(self):
        if self.watchdog is not None:
            self.watchdog.unwatch_all_threads()

    def write_blackbox(self, reason: str,
                       extra: Optional[Dict] = None) -> Optional[str]:
        """Flush the post-mortem: last ``blackbox_window_s`` seconds of
        every series ring + the pending event tail + heartbeat ages and
        per-thread phases, atomically to ``blackbox.json``.  Called from
        the watchdog's escalation hook, the SIGTERM path and the
        error-status close; safe (and useful) even with the series store
        disabled — the event tail is empty then, but the heartbeat/phase
        picture still lands."""
        from .series import write_blackbox
        if not self.blackbox_path:
            return None
        return write_blackbox(
            self.blackbox_path, reason,
            store=self.hub.series_store,
            events=(self._tail_sink.tail() if self._tail_sink is not None
                    else []),
            window_s=self.blackbox_window_s,
            heartbeats=self.hub.beat_ages(),
            thread_phases=self.hub.thread_phases(),
            run=self.hub.base_tags.get("run"),
            extra=extra)

    def record_precision(self, policy):
        """Dtype-policy gauges + one ``precision`` event (policy is a
        ``config.schema.PrecisionPolicy``).  Gauges carry the bit width per
        role so ``metrics.json`` diffs show a dtype change numerically;
        the event carries the dtype names for the per-run report header
        (tools/obs_report.py)."""
        if self.perf is not None:
            self.perf.precision = policy.name
        bits = {"float32": 32, "bfloat16": 16, "float16": 16}
        for role, dt in (("param", policy.param_dtype),
                         ("gnn_compute", policy.gnn_compute),
                         ("mlp_compute", policy.mlp_compute),
                         ("replay", policy.replay_dtype)):
            self.hub.gauge("dtype_bits", bits.get(dt, 0), role=role)
        self.hub.event("precision", name=policy.name,
                       param_dtype=policy.param_dtype,
                       gnn_compute=policy.gnn_compute,
                       mlp_compute=policy.mlp_compute,
                       replay_dtype=policy.replay_dtype)

    def prefetcher_heartbeat(self):
        """Bound callable handed to ``EpisodeDriver.prefetcher`` — beats
        from the producer thread after every staged episode."""
        return lambda: self.hub.beat("prefetcher")

    def attach_prefetcher(self, prefetcher):
        """Register stall-event probes over a live prefetcher: queue depth
        and producer-thread liveness."""
        if self.watchdog is not None:
            self.watchdog.register_probe(
                "prefetch_queue_depth", lambda: prefetcher.queue_depth)
            self.watchdog.register_probe(
                "prefetcher_alive", lambda: prefetcher.is_alive())

    # ------------------------------------------------------------- episodes
    def episode_dispatched(self, episode: int):
        self.hub.counter("episodes_dispatched")
        self.hub.beat("dispatch")

    def episode_end(self, episode: int, global_step: int,
                    metrics: Dict[str, float], sps: float,
                    phases: Dict[str, Dict[str, float]],
                    drop_reasons: Optional[Dict[str, int]] = None,
                    truncated_arrivals: int = 0,
                    replay_bytes: Optional[int] = None,
                    extra: Optional[Dict] = None) -> Dict:
        """One drained episode: update hub series, sample device memory,
        emit the ``episode`` event, heartbeat the watchdog, and rewrite
        the snapshot every ``snapshot_interval`` episodes.

        ``phases`` is the cumulative ``PhaseTimer.summary()``; per-episode
        deltas are derived here and fed to the phase histograms."""
        self._drained += 1
        self.hub.counter("episodes_drained")
        self.hub.gauge("sps", sps)
        self.hub.gauge("episode", episode)
        # flight-recorder history rides the SAME values the gauges get,
        # at the same instant — the last ring point of every fed metric
        # always equals the final metrics.json snapshot (series() no-ops
        # when the recorder is off)
        self.hub.series("sps", sps)
        self.hub.series("episode", episode)
        for k, v in metrics.items():
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue   # non-scalar stat (kept in the event record only)
            self.hub.gauge(k, fv)
            self.hub.series(k, fv)
        if replay_bytes is not None:
            self.hub.gauge("replay_bytes", replay_bytes)
            self.hub.series("replay_bytes", replay_bytes)
        if truncated_arrivals:
            self.hub.counter("truncated_arrivals_total", truncated_arrivals)
        for reason, n in (drop_reasons or {}).items():
            if n:
                self.hub.counter("sim_drops_total", n, reason=reason)
        for name in _PHASE_HIST:
            total = phases.get(name, {}).get("total_s")
            if total is None:
                continue
            delta = total - self._prev_phase_totals.get(name, 0.0)
            self._prev_phase_totals[name] = total
            self.hub.observe("phase_s", delta, phase=name)
        device_memory = record_device_gauges(self.hub)
        record = self.hub.event(
            "episode", episode=episode, global_step=global_step,
            sps=round(sps, 3), **metrics,
            drop_reasons=drop_reasons or {},
            truncated_arrivals=truncated_arrivals,
            replay_bytes=replay_bytes,
            phases=phases, device_memory=device_memory,
            **(extra or {}))
        self.hub.beat("episode")
        if self._drained % self.snapshot_interval == 0:
            self.write_snapshot()
        return record

    def recovery(self, episode: int, site: str, action: str,
                 fault: Optional[str] = None,
                 attempt: Optional[int] = None,
                 detail: Optional[str] = None) -> Dict:
        """One self-healing action (resilience subsystem): a monotonic
        total plus a per-(site, action) counter for metrics.json diffs,
        and one structured ``recovery`` event in events.jsonl —
        ``tools/obs_report.py`` renders them as the recovery timeline.

        The degradation ladder's actions: ``retry`` (dispatch backoff),
        ``restart`` (prefetcher), ``pipeline_off`` (degrade to serial
        sampling), ``rollback`` (restore last-good state), ``resave``
        (checkpoint failed validation), ``preempt_snapshot`` (SIGTERM)."""
        self.hub.counter("recoveries_total")
        self.hub.counter("recoveries", site=site, action=action)
        return self.hub.event(
            "recovery", episode=episode, site=site, action=action,
            **{k: v for k, v in (("fault", fault), ("attempt", attempt),
                                 ("detail", detail)) if v is not None})

    def invariant_violation(self, episode: int, violations: List[str]):
        """A simulator-invariant failure: a monotonic counter for
        metrics.json diffs plus one event per occurrence in events.jsonl
        (tools/obs_report.py lists them)."""
        self.hub.counter("invariant_violations_total", len(violations))
        self.hub.event("invariant_violation", episode=episode,
                       violations=violations)

    def eval_episode(self, episode: int, episodic_return: float,
                     succ_ratio: float, runtime_s: float):
        self.hub.counter("eval_episodes")
        device_memory = record_device_gauges(self.hub)
        self.hub.event("eval_episode", episode=episode,
                       episodic_return=episodic_return,
                       succ_ratio=succ_ratio,
                       runtime_s=round(runtime_s, 4),
                       device_memory=device_memory)

    # ------------------------------------------------------------ snapshot
    def write_snapshot(self) -> Optional[str]:
        import time

        if not self.snapshot_path:
            return None
        return write_atomic_json(self.snapshot_path, {
            "ts": round(time.time(), 3),
            "run": self.hub.base_tags.get("run"),
            "metrics": self.hub.snapshot(),
        })
