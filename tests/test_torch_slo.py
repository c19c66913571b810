"""The port's SLO engine and request tracer (``gsc_tpu_torch.obs.slo``)
against the JAX package's, and their behaviour through the port's
batcher and server (mirroring tests/test_serve_obs.py with numpy stub
backends).

Held against ``gsc_tpu.obs.slo`` exactly: ``parse_slo_spec`` results and
errors on a list of specs, and ``SLOEngine`` snapshots after the same
seeded record sequence (the records carry their own times, the engine
reads no clock).  The span decomposition identity holds to 1e-2 ms, the
rounding of the span fields; everything else is exact."""
import json

import numpy as np
import pytest

import gsc_tpu_torch.obs.slo as pslo
from gsc_tpu_torch.obs import (ListSink, MetricsHub, RunObserver,
                               ServeTracer, SLOEngine, SLOObjectives,
                               parse_slo_spec)
from gsc_tpu_torch.serve import MicroBatcher, PolicyServer, ServeError
from torch_port_helpers import (ArrayTemplate, StubPolicy,  # noqa: F401
                                one_torch_thread)

SPECS = ["25", "25,4:40,8:60", "4:40", " 10 , 2:3.5", "1e1", "",
         "abc", "25,30", "4:", "0", "4:-1", "4:40,4:50", "x:3", "2:y",
         "25,", ",25", "0:10", "-3"]


def _obs():
    return np.zeros(3, np.float32)


def _traced_batcher(hub, sample=1, buckets=(1, 4), deadline_ms=5.0,
                    slo="10", run_batch=None, **kw):
    tracer = ServeTracer(hub=hub, sample=sample)
    tracer.bind_engine(SLOEngine(deadline_ms=deadline_ms,
                                 objectives=parse_slo_spec(slo), hub=hub))
    tracer.start()
    mb = MicroBatcher(run_batch or StubPolicy().run_batch,
                      ArrayTemplate(_obs()), buckets=buckets,
                      deadline_ms=deadline_ms, hub=hub, tracer=tracer,
                      **kw).start()
    return mb, tracer


@pytest.mark.parametrize("spec", SPECS)
def test_parse_slo_spec_matches_jax(spec):
    from gsc_tpu.obs import slo as jslo

    def parse(mod):
        try:
            obj = mod.parse_slo_spec(spec, target_attainment=0.95)
        except ValueError as e:
            return ("error", str(e))
        return ("ok", obj.to_doc(), obj.declared(),
                [obj.objective_for(b) for b in (1, 2, 4, 8, "x")])

    assert parse(pslo) == parse(jslo)


@pytest.mark.parametrize("seed,spec", [(0, "10"), (1, "10,4:40"),
                                       (2, None)])
def test_slo_engine_snapshots_match_jax(seed, spec):
    """The same seeded sequence of requests, failures, flushes,
    rejections and arrivals (at recorded times) into both engines."""
    from gsc_tpu.obs import slo as jslo

    rng = np.random.default_rng(seed)
    ops = []
    t = 1000.0
    for _ in range(600):
        kind = rng.integers(0, 10)
        bucket = int(rng.choice([1, 4, 8]))
        t += float(rng.exponential(0.004))
        if kind < 6:
            ops.append(("req", float(rng.gamma(2.0, 4.0)), bucket,
                        float(rng.uniform(0, 2))))
        elif kind == 6:
            ops.append(("fail", bucket))
        elif kind == 7:
            ops.append(("flush", int(rng.integers(1, bucket + 1)), bucket))
        elif kind == 8:
            ops.append(("reject", str(rng.choice(["queue_full",
                                                  "stopping"])), t))
        else:
            ops.append(("arrive", t))

    def run(mod):
        obj = mod.parse_slo_spec(spec) if spec else None
        eng = mod.SLOEngine(deadline_ms=12.0, objectives=obj, window=128)
        snaps = []
        for i, op in enumerate(ops):
            if op[0] == "req":
                eng.record_request(op[1], op[2], queue_wait_ms=op[3])
            elif op[0] == "fail":
                eng.record_failed_request(op[1])
            elif op[0] == "flush":
                eng.record_flush(op[1], op[2])
            elif op[0] == "reject":
                eng.record_rejection(op[1], op[2])
            else:
                eng.note_arrival(op[1])
            if i % 97 == 0:
                snaps.append(eng.snapshot())
        return snaps + [eng.snapshot()]

    assert json.dumps(run(pslo)) == json.dumps(run(jslo))


def test_slo_engine_hand_computed_attainment_and_burn():
    eng = SLOEngine(deadline_ms=5.0, objectives=parse_slo_spec("10"))
    for lat in [4.0] * 8 + [20.0] * 2:
        eng.record_request(lat, bucket=1)
    snap = eng.snapshot()
    assert snap["attainment"] == 0.8
    assert abs(snap["burn_rate"] - 20.0) < 1e-9
    assert snap["deadline_miss_ratio"] == 0.2
    assert snap["deadline_misses"] == 2 and snap["requests"] == 10


def test_slo_engine_per_bucket_override_and_no_objective():
    eng = SLOEngine(deadline_ms=100.0, objectives=parse_slo_spec("10,4:50"))
    eng.record_request(30.0, bucket=4)
    eng.record_request(30.0, bucket=1)
    snap = eng.snapshot()
    assert snap["attainment"] == 0.5
    assert snap["per_bucket"]["4"]["attainment"] == 1.0
    assert snap["per_bucket"]["1"]["objective_ms"] == 10.0
    bare = SLOEngine(deadline_ms=5.0)
    bare.record_request(20.0, bucket=1)
    s = bare.snapshot()
    assert s["attainment"] is None and s["burn_rate"] is None
    assert s["deadline_miss_ratio"] == 1.0


def test_slo_engine_pad_waste_arrival_rate_and_gauges():
    hub = MetricsHub()
    eng = SLOEngine(deadline_ms=5.0, hub=hub, tags={"worker": "w1"})
    eng.record_flush(n_real=1, bucket=4)
    eng.record_flush(n_real=4, bucket=4)
    for i in range(50):
        eng.note_arrival(100.0 + 0.01 * i)
    eng.record_request(9.0, bucket=4)
    snap = eng.snapshot()
    assert snap["pad_waste"] == 0.375
    assert abs(snap["arrival_rate_rps"] - 100.0) < 1.0
    eng.publish_gauges()
    assert hub.get_gauge("slo_pad_waste", worker="w1") == 0.375
    assert hub.get_counter("serve_deadline_miss_total", worker="w1") == 1


def test_span_decomposition_sums_to_recorded_latency():
    hub = MetricsHub(tags={"run": "spans"})
    sink = ListSink()
    hub.add_sink(sink)
    mb, tracer = _traced_batcher(hub, sample=1, deadline_ms=20.0)
    futs = [mb.submit(_obs()) for _ in range(4)]
    for f in futs:
        f.result(30)
    mb.submit(_obs()).result(30)
    mb.stop()
    tracer.stop()
    spans = sink.of_kind("serve_request_span")
    assert len(spans) == 5
    for s in spans:
        assert min(s["queue_wait_ms"], s["batch_wait_ms"], s["device_ms"],
                   s["fanout_ms"]) >= 0
        total = s["queue_wait_ms"] + s["batch_wait_ms"] + s["device_ms"]
        assert abs(total - s["latency_ms"]) < 1e-2, s
    lat = hub.histogram_summary("serve_latency_ms")
    assert lat["count"] == 5
    assert abs(max(s["latency_ms"] for s in spans) - lat["max"]) < 1e-2
    flushes = sink.of_kind("serve_flush")
    assert sorted(f["n_real"] for f in flushes) == [1, 4]
    assert {s["flush_id"] for s in spans} == {f["flush_id"] for f in flushes}


def test_head_sampling_records_every_nth_request():
    hub = MetricsHub()
    sink = ListSink()
    hub.add_sink(sink)
    mb, tracer = _traced_batcher(hub, sample=3, buckets=(1,),
                                 deadline_ms=0.5)
    for _ in range(9):
        mb.submit(_obs()).result(30)
    mb.stop()
    tracer.stop()
    assert [s["trace_id"] for s in sink.of_kind("serve_request_span")] \
        == [0, 3, 6]
    assert len(sink.of_kind("serve_flush")) == 9


def test_rejections_counted_before_the_error_reaches_the_caller():
    hub = MetricsHub()
    tracer = ServeTracer(hub=hub, sample=0)
    engine = SLOEngine(deadline_ms=5.0, hub=hub)
    tracer.bind_engine(engine)
    mb = MicroBatcher(StubPolicy().run_batch, ArrayTemplate(_obs()),
                      buckets=(1,), max_queue=1, hub=hub, tracer=tracer)
    mb.submit(_obs())                      # the consumer is not started
    with pytest.raises(ServeError, match="queue full"):
        mb.submit(_obs())
    assert hub.get_counter("serve_rejected_total", reason="queue_full") == 1
    mb._stopping = True
    with pytest.raises(ServeError, match="stopping"):
        mb.submit(_obs())
    tracer.drain_pending()
    assert engine.snapshot()["rejected"] == {"queue_full": 1, "stopping": 1}


def test_failed_device_calls_burn_the_slo_budget():
    hub = MetricsHub()
    sink = ListSink()
    hub.add_sink(sink)
    calls = {"n": 0}

    def flaky(leaves, k, bucket):
        calls["n"] += 1
        if calls["n"] % 2 == 0:
            raise RuntimeError("injected device fault")
        return np.zeros((bucket, 2), np.float32)

    mb, tracer = _traced_batcher(hub, sample=1, buckets=(1,),
                                 deadline_ms=1000.0, slo="1000",
                                 run_batch=flaky)
    ok = err = 0
    for _ in range(6):
        try:
            mb.submit(_obs()).result(30)
            ok += 1
        except ServeError:
            err += 1
    mb.stop()
    tracer.stop()
    assert (ok, err) == (3, 3)
    snap = tracer.engine.snapshot()
    assert snap["requests"] == 6 and snap["errored_requests"] == 3
    assert snap["deadline_miss_ratio"] == 0.5 and snap["attainment"] == 0.5
    failed = [f for f in sink.of_kind("serve_flush") if f.get("error")]
    assert len(failed) == 3 and "injected device fault" in failed[0]["error"]
    assert len(sink.of_kind("serve_request_span")) == 3


def test_tracer_overflow_drops_oldest_and_counts():
    hub = MetricsHub()
    tracer = ServeTracer(hub=hub, sample=0, max_pending=2)
    engine = SLOEngine(deadline_ms=5.0)
    tracer.bind_engine(engine)
    for i in range(5):
        tracer.note_rejection("queue_full" if i < 3 else "stopping",
                              float(i))
    assert tracer.spans_dropped == 3
    tracer.drain_pending()
    assert hub.get_counter("serve_spans_dropped_total") == 3
    # the oldest went: only the two newest records reached the engine
    assert engine.snapshot()["rejected"] == {"stopping": 2}


def test_answers_and_latency_identical_with_tracing_off():
    sink_on, sink_off = ListSink(), ListSink()
    hub_on, hub_off = MetricsHub(), MetricsHub()
    hub_on.add_sink(sink_on)
    hub_off.add_sink(sink_off)
    mb_on, tracer = _traced_batcher(hub_on, sample=1)
    mb_off = MicroBatcher(StubPolicy().run_batch, ArrayTemplate(_obs()),
                          buckets=(1, 4), deadline_ms=5.0,
                          hub=hub_off).start()
    outs_on = [mb_on.submit(_obs()).result(30) for _ in range(3)]
    outs_off = [mb_off.submit(_obs()).result(30) for _ in range(3)]
    mb_on.stop()
    tracer.stop()
    mb_off.stop()
    for a, b in zip(outs_on, outs_off):
        np.testing.assert_array_equal(a, b)
    assert hub_on.histogram_summary("serve_latency_ms")["count"] == \
        hub_off.histogram_summary("serve_latency_ms")["count"] == 3
    assert sink_on.of_kind("serve_request_span")
    assert not sink_off.of_kind("serve_request_span")
    assert not sink_off.of_kind("serve_flush")
    assert hub_off.histogram_summary("serve_queue_wait_ms") is None


def test_slo_json_and_stats_written_at_server_close(tmp_path):
    rec = RunObserver(str(tmp_path / "run"))
    rec.start(meta={"mode": "serve", "tier": "spr"})
    tracer = ServeTracer(hub=rec.hub, sample=2)
    srv = PolicyServer(fallback=StubPolicy(), buckets=(1, 2),
                       deadline_ms=1.0, hub=rec.hub, tracer=tracer,
                       slo=SLOObjectives(p99_ms=10.0),
                       slo_path=rec.slo_path,
                       wall_clock=lambda: 1234.5).start()
    for _ in range(4):
        srv.submit_sync(_obs(), timeout=30)
    srv.close()
    rec.close(status="ok")
    doc = json.load(open(rec.slo_path))
    assert doc["schema_version"] == 1 and doc["tier"] == "spr"
    assert doc["requests"] == 4 and doc["run"] == "run"
    assert doc["ts"] == 1234.5
    assert doc["objectives"]["p99_ms"] == 10.0
    assert doc["attainment"] is not None and doc["pad_waste"] is not None
    assert doc["decomposition_ms"]
    s = srv.slo_summary()
    assert s["deadline_miss_ratio"] == doc["deadline_miss_ratio"]
    assert s["p99_target_ms"] == 10.0
    stats = [e for e in map(json.loads, open(rec.events_path))
             if e["event"] == "serve_stats"]
    assert stats[-1]["final"] and stats[-1]["requests"] == 4
    assert stats[-1]["slo"]["p99_target_ms"] == 10.0
    assert stats[-1]["rejected"] == {"queue_full": 0, "stopping": 0}
