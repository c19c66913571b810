"""The port's trace exporter (``gsc_tpu_torch.obs.trace``) and the
rendering of its serving events.

``build_trace`` is held against the JAX package's on the same event
stream, JSON-equal but for the exporter's own name in the metadata: a
stream with every track (episodes with phase deltas, evaluation, stalls,
escalations, invariant violations, a recovery ladder, prefetcher
restarts, compile spans, serving starts/stats/flushes and sampled
request spans with their flow arrows, the async flight-recorder records)
and an appended second run.  The validator and the serve-request track
are mirrored from tests/test_serve_obs.py, and a real serving run of the
port renders through tools/obs_report.py's serving section as the JAX
package's does (tests/test_serve_obs.py's render test)."""
import io
import json
import os
import sys

import numpy as np
import pytest

from gsc_tpu_torch.obs import (JsonlSink, MetricsHub, RunObserver,
                               ServeTracer, SLOEngine, parse_slo_spec)
from gsc_tpu_torch.obs.trace import (TRACE_TRACKS, build_trace,
                                     export_trace, read_events,
                                     validate_trace)
from gsc_tpu_torch.serve import MicroBatcher, PolicyServer, ServeError
from torch_port_helpers import (ArrayTemplate, StubPolicy,  # noqa: F401
                                one_torch_thread)

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "tools"))


def _stream():
    span = dict(bucket=4, queue_wait_ms=1.0, batch_wait_ms=5.0,
                device_ms=1.5, fanout_ms=0.1, latency_ms=7.5)
    run1 = [
        {"event": "run_start", "ts": 100.0, "run": "r", "episodes": 2,
         "replicas": 4, "precision": "f32"},
        {"event": "compile", "ts": 100.5, "fn": "step", "stage": "trace",
         "duration_s": 0.3, "count": 1},
        {"event": "compile_cost", "ts": 100.6, "fn": "step", "flops": 10},
        {"event": "episode", "ts": 101.0, "episode": 0, "sps": 5.0,
         "episodic_return": -1.0,
         "phases": {"host_sample": {"total_s": 0.1},
                    "dispatch": {"total_s": 0.5},
                    "drain": {"total_s": 0.2}, "other": {"total_s": 0.1}}},
        {"event": "stall", "ts": 101.2, "age_s": 3.0, "budget_s": 2.0,
         "last_phase": "dispatch"},
        {"event": "escalation", "ts": 101.3, "age_s": 9.0,
         "action": "restart"},
        {"event": "recovery", "ts": 101.4, "site": "dispatch",
         "action": "retry", "episode": 1, "fault": "transient"},
        {"event": "recovery", "ts": 101.45, "site": "prefetcher",
         "action": "restart", "episode": 1},
        {"event": "invariant_violation", "ts": 101.5, "episode": 1,
         "violations": ["a", "b"]},
        {"event": "episode", "ts": 102.0, "episode": 1, "sps": 6.0,
         "episodic_return": -0.5,
         "phases": {"host_sample": {"total_s": 0.3},
                    "dispatch": {"total_s": 2.5},
                    "drain": {"total_s": 0.3}}},
        {"event": "eval_episode", "ts": 102.5, "episode": 0,
         "runtime_s": 0.2, "episodic_return": -0.4, "succ_ratio": 0.9},
        {"event": "serve_start", "ts": 102.6, "tier": "spr",
         "startup_s": 0.01},
        {"event": "serve_flush", "ts": 102.710, "flush_id": 0, "bucket": 4,
         "n_real": 3, "pad_fraction": 0.25, "device_ms": 1.5,
         "queue_depth": 0},
        {"event": "serve_request_span", "ts": 102.704, "trace_id": 7,
         "flush_id": 0, **span, "deadline_miss": True},
        {"event": "serve_request_span", "ts": 102.705, "trace_id": 8,
         "flush_id": 99, **span},
        {"event": "serve_stats", "ts": 102.8, "rps": 30.0, "p99_ms": 8.0,
         "queue_depth": 1},
        {"event": "async_actor_ep", "ts": 103.0, "actor": 1, "ep": 0,
         "chunks": [[102.81, 102.85, 1]], "puts": [[102.86, 0.01, 50, 1, 0]],
         "adopts": [[102.95, 2]]},
        {"event": "async_learner_spans", "ts": 103.1,
         "ingests": [[102.9, 102.91, 50, 1, 0, 0, 3]],
         "bursts": [[102.92, 102.93, 4]], "publishes": [[102.94, 2]]},
        {"event": "run_end", "ts": 103.2, "status": "ok"},
    ]
    run2 = [
        {"event": "run_start", "ts": 200.0, "run": "r"},
        {"event": "serve_request_span", "ts": 200.001, "trace_id": 1,
         "flush_id": 0, **span},
        {"event": "serve_flush", "ts": 200.005, "flush_id": 0, "bucket": 1,
         "n_real": 1, "pad_fraction": 0.0, "device_ms": 0.1},
        {"event": "run_end", "ts": 200.1, "status": "error"},
    ]
    return run1 + run2


def test_build_trace_json_equal_to_jax():
    from gsc_tpu.obs.trace import build_trace as jbuild
    from gsc_tpu.obs.trace import validate_trace as jvalidate

    events = _stream()
    # shuffled within each run: both sort per run the same way
    rng = np.random.default_rng(0)
    mixed = [events[0]] + [events[i] for i in
                           1 + rng.permutation(len(events) - 5)] \
        + events[-4:]
    for stream in (events, mixed):
        port, jax = build_trace(stream), jbuild(stream)
        assert port["metadata"].pop("exporter") == "gsc_tpu_torch.obs.trace"
        assert jax["metadata"].pop("exporter") == "gsc_tpu.obs.trace"
        assert json.dumps(port, sort_keys=True) == \
            json.dumps(jax, sort_keys=True)
        assert validate_trace(port) == jvalidate(jax) == []
    assert {e["tid"] for e in port["traceEvents"]} >= \
        set(TRACE_TRACKS.values())


def test_validator_accepts_serve_request_track_with_flows():
    events = [e for e in _stream()[:15] if e["event"] in
              ("run_start", "serve_flush", "serve_request_span")]
    trace = build_trace(events)
    assert validate_trace(trace) == []
    evs = trace["traceEvents"]
    req = [e for e in evs if e.get("ph") == "X"
           and e["tid"] == TRACE_TRACKS["serve_request"]]
    fl = [e for e in evs if e.get("ph") == "X"
          and e["tid"] == TRACE_TRACKS["serve"]]
    assert len(req) == 2 and len(fl) == 1
    assert req[0]["dur"] == 7600.0 and fl[0]["dur"] == 1500.0
    starts = [e for e in evs if e.get("ph") == "s"]
    ends = [e for e in evs if e.get("ph") == "f"]
    # one arrow: the span whose flush exists; none from flush_id 99
    assert len(starts) == len(ends) == 1
    assert ends[0]["ts"] == fl[0]["ts"]


def test_validator_rejects_broken_traces():
    ok = {"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": 1.0, "dur": 1.0}
    bad = [
        [{**ok, "ts": -1.0}],
        [{**ok, "ts": 2.0}, {**ok, "ts": 1.0}],
        [{**ok, "ph": "B"}],
        [{**ok, "ph": "E"}],
        [{**ok, "ph": "B", "name": "x"}, {**ok, "ph": "E", "name": "y"}],
        [{**ok, "dur": -1}],
        [{**ok, "ph": "s", "id": 1}],
        [{**ok, "ph": "f", "id": 1}],
        [{k: v for k, v in ok.items() if k != "pid"}],
    ]
    for evs in bad:
        assert validate_trace({"traceEvents": evs}), evs
    assert validate_trace({"traceEvents": [ok]}) == []
    assert validate_trace({}) == ["traceEvents missing or not a list"]


def test_flows_never_cross_appended_runs():
    trace = build_trace(_stream()[-4:] + [
        {"event": "run_start", "ts": 300.0, "run": "r"},
        {"event": "serve_request_span", "ts": 300.001, "trace_id": 1,
         "flush_id": 0, "bucket": 1, "latency_ms": 0.3}])
    assert validate_trace(trace) == []
    starts = [e for e in trace["traceEvents"] if e.get("ph") == "s"]
    assert len(starts) == 1


def test_real_stream_exports_valid_trace(tmp_path):
    hub = MetricsHub(tags={"run": "e2e"})
    hub.add_sink(JsonlSink(str(tmp_path / "events.jsonl")))
    hub.event("run_start", mode="serve")
    tracer = ServeTracer(hub=hub, sample=1)
    tracer.bind_engine(SLOEngine(deadline_ms=2.0, hub=hub,
                                 objectives=parse_slo_spec("10")))
    tracer.start()
    mb = MicroBatcher(StubPolicy().run_batch, ArrayTemplate(
        np.zeros(3, np.float32)), buckets=(1, 4), deadline_ms=2.0, hub=hub,
        tracer=tracer, mode="continuous").start()
    for _ in range(6):
        mb.submit(np.zeros(3, np.float32)).result(30)
    mb.stop()
    tracer.stop()
    hub.event("run_end", status="ok")
    trace, errors = export_trace(str(tmp_path),
                                 out_path=str(tmp_path / "trace.json"))
    assert errors == []
    assert json.load(open(tmp_path / "trace.json")) == trace
    assert len([e for e in trace["traceEvents"] if e.get("ph") == "X"
                and e["tid"] == TRACE_TRACKS["serve_request"]]) == 6
    assert len(read_events(str(tmp_path))) == \
        len(open(tmp_path / "events.jsonl").readlines())


def _render(summary) -> str:
    from obs_report import render_text

    out = io.StringIO()
    render_text(summary, out=out)
    return out.getvalue()


def _serve_run(pkg, out_dir):
    """The same traced SPR-tier run, one rejection included, through
    either package's RunObserver and PolicyServer."""
    if pkg == "jax":
        from gsc_tpu.obs import RunObserver as Obs
        from gsc_tpu.obs import ServeTracer as Tracer
        from gsc_tpu.obs import parse_slo_spec as parse
        from gsc_tpu.serve import ObsTemplate
        from gsc_tpu.serve import PolicyServer as Server
        from gsc_tpu.serve import ServeError as Err

        stub = StubPolicy()
        stub.template = ObsTemplate(np.zeros(3, np.float32))
    else:
        Obs, Tracer, parse, Server, Err = (RunObserver, ServeTracer,
                                           parse_slo_spec, PolicyServer,
                                           ServeError)
        stub = StubPolicy()
    rec = Obs(str(out_dir))
    rec.start(meta={"mode": "serve", "tier": "spr"})
    srv = Server(fallback=stub, buckets=(1, 2), deadline_ms=1.0,
                 hub=rec.hub, tracer=Tracer(hub=rec.hub, sample=2),
                 slo=parse("50"), slo_path=rec.slo_path).start()
    for _ in range(4):
        srv.submit_sync(np.zeros(3, np.float32), timeout=30)
    srv.batcher._stopping = True
    with pytest.raises(Err):
        srv.submit(np.zeros(3, np.float32))
    srv.batcher._stopping = False
    srv.close()
    rec.close(status="ok")


def test_serve_events_render_like_jax(tmp_path):
    from obs_report import load_events, summarize

    views = {}
    for pkg in ("jax", "port"):
        _serve_run(pkg, tmp_path / pkg)
        summary = summarize(load_events(str(tmp_path / pkg)))
        text = _render(summary)
        sv = summary["serving"]
        views[pkg] = {
            "tier": sv["tier"], "requests": sv["requests"],
            "occupancy": sum(sv["occupancy"].values()),
            "rejected": sv["rejected"],
            "slo_target": sv["slo"]["p99_target_ms"],
            "slo_keys": sorted(sv["slo"]),
            "decomposition": {b: sorted(r) for b, r in
                              sv["decomposition"].items()},
            "lines": [line.split(":")[0] for line in text.splitlines()
                      if line.startswith("  SLO") or "rejected" in line
                      or "decomposition" in line or "serving (" in line],
        }
        assert os.path.exists(tmp_path / pkg / "slo.json")
    assert views["port"] == views["jax"]
    assert views["port"]["rejected"] == {"queue_full": 0, "stopping": 1}


def test_fleet_events_render(tmp_path):
    """A port fleet run (two SPR workers, two fired swaps) renders the
    fleet view: fleet_start, per-worker stats, the swap timeline."""
    from obs_report import load_events, summarize

    from gsc_tpu_torch import cli

    assert cli.main(["serve", "--device", "cpu", "--requests", "8",
                     "--concurrency", "2", "--pool-steps", "1",
                     "--workers", "2", "--hot-swap-dir",
                     str(tmp_path / "w"), "--fire-swaps", "2",
                     "--swap-poll-s", "0.02", "--obs-dir",
                     str(tmp_path / "o")]) == 0
    events = load_events(str(tmp_path / "o"))
    start = [e for e in events if e["event"] == "fleet_start"]
    assert start and start[0]["workers"] == ["w0", "w1"]
    sv = summarize(events)["serving"]
    assert set(sv["workers"]) == {"w0", "w1"}
    assert sv["fleet"]["swaps"] == 4 and sv["requests"] == 8
    assert [s["version"] for s in sv["swap_timeline"]] == [1, 1, 2, 2]
    text = _render(summarize(events))
    assert "fleet: 2 worker(s)" in text and "hot-swap timeline" in text
