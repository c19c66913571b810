"""The events.jsonl -> Chrome-trace exporter, and the profiler spans.

The port of ``gsc_tpu.obs.trace``.  The live annotations,
:func:`phase_span` and :func:`episode_span`, are ``torch.profiler``
ranges kept in :mod:`gsc_tpu_torch.utils.telemetry` and re-exported here;
:func:`sort_events` and :func:`read_events` live in
:mod:`~gsc_tpu_torch.obs.sinks`.

:func:`build_trace` renders a run's event stream as Chrome trace-event
JSON (what Perfetto and ``chrome://tracing`` open): one track per logical
thread (:data:`TRACE_TRACKS`: episode loop, prefetcher, serve, watchdog,
compile, recovery, serve_request, channel, learner), watchdog stalls as
instants, recovery ladders chained by flow arrows, batcher flushes as
complete slices on the serve track, and head-sampled
``serve_request_span`` events as slices on the serve_request track whose
flow arrows link each request to the flush that answered it.  Phase
sub-spans are rebuilt from the cumulative per-episode deltas (laid back
to back inside each episode's span), so they show shares, not exact
start times.  :func:`validate_trace` is the strict schema check (monotone
ts, matched B/E pairs, pid/tid present, balanced flows);
:func:`export_trace` reads, builds and validates in one call.  Stdlib
only: it runs wherever the event stream can be copied to.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from ..utils.telemetry import episode_span, phase_span
from .sinks import read_events, sort_events

__all__ = ["ACTOR_TRACK_BASE", "TRACE_PID", "TRACE_TRACKS", "build_trace",
           "episode_span", "export_trace", "phase_span", "read_events",
           "sort_events", "validate_trace"]


# --------------------------------------------------------------- exporter
# one pid per run stream; fixed tids = the logical threads of a run.
# Stable API: tools and tests reference these names.
TRACE_PID = 1
TRACE_TRACKS = {
    "episode": 1,        # training loop: episode spans + phase sub-spans
    "prefetcher": 2,     # producer-thread restarts
    "serve": 3,          # serve_start/serve_stats counters + flush slices
    "watchdog": 4,       # stalls, escalations, invariant violations
    "compile": 5,        # jit trace/XLA compile spans + compile_cost marks
    "recovery": 6,       # self-healing ladder, chained by flow arrows
    "serve_request": 7,  # head-sampled request spans, flow-linked to the
                         # batcher flush that answered them
    "channel": 8,        # async actor->learner conduit: one slice per
                         # block's queued residency (put -> pop)
    "learner": 9,        # async learner: ingest + learn_burst slices,
                         # publish marks (flow-linked to actor adopts)
}
# per-actor async tracks start here: actor a renders on tid BASE + a
ACTOR_TRACK_BASE = 16
# phase sub-span layout order inside an episode slice (the obs schema's
# cumulative PhaseTimer names)
_TRACE_PHASES = ("host_sample", "host_sample_wait", "dispatch", "drain")


def _us(ts: float, t0: float) -> float:
    return round((ts - t0) * 1e6, 1)


def build_trace(events: List[Dict]) -> Dict:
    """Chrome trace-event JSON from an obs event stream.

    Episode slices sit back-to-back on the episode track (each ends at
    its event's wall ts); phase sub-spans are reconstructed from the
    per-episode deltas of the cumulative PhaseTimer totals, laid
    sequentially inside the episode slice and scaled down if they would
    overflow it — faithful shares, synthetic start times.  Stalls /
    escalations / invariant violations are instants on the watchdog
    track; consecutive ``recovery`` events chain with flow arrows so a
    retry -> restart -> rollback ladder reads as one connected story."""
    events = [e for e in events if isinstance(e, dict) and "ts" in e]
    if not events:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    # read_events already sorts, but the builder also accepts raw lists
    # (tests, in-memory sinks) — re-apply the SAME per-run sort so a
    # later run whose clock stepped backwards is never woven into the
    # previous run's slices here either.  (The trace is one timeline, so
    # the final output sort below still orders such streams globally —
    # a Chrome-format requirement; multi-run streams with non-monotone
    # clocks render best-effort.)  Stable: same-ts events keep caller
    # order.
    events = sort_events(events)
    # the async flight-recorder records (``async_actor_ep`` /
    # ``async_learner_spans``) are emitted DEFERRED at run end but carry
    # their own wall timestamps from mid-run — the trace origin must
    # include those payload times or every reconstructed span would land
    # at a negative offset and fail the strict validator
    t_min = [float(e["ts"]) for e in events]
    for e in events:
        k = e.get("event")
        if k == "async_actor_ep":
            t_min.extend(float(r[0]) for r in (e.get("chunks") or []))
            t_min.extend(float(r[0]) - float(r[1])
                         for r in (e.get("puts") or []))
            t_min.extend(float(r[0]) for r in (e.get("adopts") or []))
        elif k == "async_learner_spans":
            for field in ("ingests", "bursts", "publishes"):
                t_min.extend(float(r[0]) for r in (e.get(field) or []))
    t0 = min(t_min)
    run = next((e.get("run") for e in events if e.get("run")), "run")
    out: List[Dict] = []

    # named `push`, not `emit`: a device-side scan body already owns
    # that name, and gsc-lint's name-graph would treat this host-only
    # helper as traced
    def push(ph, name, tid, ts_us, dur=None, args=None, **extra):
        ev = {"ph": ph, "name": name, "pid": TRACE_PID, "tid": tid,
              "ts": ts_us, "cat": "gsc"}
        if dur is not None:
            ev["dur"] = dur
        if args:
            ev["args"] = args
        ev.update(extra)
        out.append(ev)

    # track metadata (ph "M"): process + thread names
    out.append({"ph": "M", "name": "process_name", "pid": TRACE_PID,
                "tid": 0, "ts": 0.0, "args": {"name": f"gsc_tpu {run}"}})
    for label, tid in TRACE_TRACKS.items():
        out.append({"ph": "M", "name": "thread_name", "pid": TRACE_PID,
                    "tid": tid, "ts": 0.0, "args": {"name": label}})

    ep_tid = TRACE_TRACKS["episode"]
    prev_phase_totals: Dict[str, float] = {}
    prev_end = 0.0            # episode-track cursor (monotone)
    compile_end = 0.0         # compile-track cursor
    recoveries = [e for e in events if e.get("event") == "recovery"]
    rec_index = {id(e): i for i, e in enumerate(recoveries)}
    flow_id = 0
    # serving flushes index ((run-segment, flush_id) -> dispatch ts_us):
    # sampled request spans flow-arrow into the flush slice that
    # answered them; built up front because span events carry their
    # ENQUEUE wall time, which always precedes the flush's dispatch time
    # in the sorted stream.  Keyed per run_start segment, not by
    # flush_id alone — appended runs in a reused --obs-dir each restart
    # their flush ids at 0, and a run-1 span must never arrow into a
    # run-2 flush slice
    seg_of: Dict[int, int] = {}
    seg = 0
    for e in events:
        if e.get("event") == "run_start":
            seg += 1
        seg_of[id(e)] = seg
    flush_ts = {(seg_of[id(e)], e.get("flush_id")): _us(float(e["ts"]), t0)
                for e in events
                if e.get("event") == "serve_flush"
                and e.get("flush_id") is not None}
    # async flight-recorder indices (same per-segment keying): put->pop
    # flows need each block's ingest start by seq, publish->adopt flows
    # need each version's publish time; both live in deferred learner
    # records that can sort before OR after the actor records
    async_ingest: Dict[tuple, List] = {}
    async_pub: Dict[tuple, float] = {}
    actor_ids = set()
    for e in events:
        k = e.get("event")
        if k == "async_learner_spans":
            s = seg_of[id(e)]
            for row in (e.get("ingests") or []):
                async_ingest[(s, int(row[5]))] = row
            for p_ts, ver in (e.get("publishes") or []):
                async_pub.setdefault((s, int(ver)), float(p_ts))
        elif k == "async_actor_ep":
            actor_ids.add(int(e.get("actor") or 0))
    for a in sorted(actor_ids):
        out.append({"ph": "M", "name": "thread_name", "pid": TRACE_PID,
                    "tid": ACTOR_TRACK_BASE + a, "ts": 0.0,
                    "args": {"name": f"actor{a}"}})

    for ev in events:
        kind = ev.get("event")
        ts_us = _us(float(ev["ts"]), t0)
        if kind == "run_start":
            prev_phase_totals = {}
            prev_end = max(prev_end, ts_us)
            push("i", "run_start", ep_tid, ts_us, s="t",
                 args={k: v for k, v in ev.items()
                       if k in ("run", "episodes", "replicas", "pipeline",
                                "precision", "substep_impl", "mesh")})
        elif kind == "episode":
            start = max(prev_end, 0.0)
            end = max(ts_us, start)
            push("B", f"episode {ev.get('episode')}", ep_tid, start,
                 args={"episode": ev.get("episode"), "sps": ev.get("sps"),
                       "return": ev.get("episodic_return")})
            totals = {n: i.get("total_s", 0.0)
                      for n, i in (ev.get("phases") or {}).items()}
            deltas = {n: max(t - prev_phase_totals.get(n, 0.0), 0.0)
                      for n, t in totals.items()}
            prev_phase_totals = totals
            order = [p for p in _TRACE_PHASES if deltas.get(p, 0) > 0] + \
                sorted(set(deltas) - set(_TRACE_PHASES))
            total_us = sum(deltas.get(p, 0.0) for p in order) * 1e6
            span = end - start
            scale = (span / total_us) if total_us > span else 1.0
            cursor = start
            for p in order:
                d = round(deltas.get(p, 0.0) * 1e6 * scale, 1)
                if d <= 0:
                    continue
                push("B", p, ep_tid, cursor,
                     args={"delta_ms": round(deltas[p] * 1e3, 3)})
                cursor = round(min(cursor + d, end), 1)
                push("E", p, ep_tid, cursor)
            push("E", f"episode {ev.get('episode')}", ep_tid, end)
            prev_end = end
        elif kind == "eval_episode":
            start = max(prev_end,
                        ts_us - round(float(ev.get("runtime_s") or 0.0)
                                      * 1e6, 1))
            end = max(ts_us, start)
            push("B", f"eval {ev.get('episode')}", ep_tid, start,
                 args={"return": ev.get("episodic_return"),
                       "succ_ratio": ev.get("succ_ratio")})
            push("E", f"eval {ev.get('episode')}", ep_tid, end)
            prev_end = end
        elif kind == "run_end":
            push("i", f"run_end ({ev.get('status')})", ep_tid,
                 max(ts_us, prev_end), s="t")
            prev_end = max(ts_us, prev_end)
        elif kind == "stall":
            push("i", "stall", TRACE_TRACKS["watchdog"], ts_us, s="g",
                 args={"age_s": ev.get("age_s"),
                       "budget_s": ev.get("budget_s"),
                       "last_phase": ev.get("last_phase"),
                       "dispatch_drain_lag": ev.get("dispatch_drain_lag")})
        elif kind == "escalation":
            push("i", "escalation", TRACE_TRACKS["watchdog"], ts_us,
                 s="g", args={"age_s": ev.get("age_s"),
                              "action": ev.get("action")})
        elif kind == "invariant_violation":
            push("i", "invariant_violation", TRACE_TRACKS["watchdog"],
                 ts_us, s="t",
                 args={"episode": ev.get("episode"),
                       "violations": len(ev.get("violations") or [])})
        elif kind == "recovery":
            name = f"{ev.get('site')}/{ev.get('action')}"
            i = rec_index[id(ev)]
            nxt = (_us(float(recoveries[i + 1]["ts"]), t0)
                   if i + 1 < len(recoveries) else ts_us + 1000.0)
            dur = round(max(min(1000.0, nxt - ts_us), 0.0), 1)
            tid = TRACE_TRACKS["recovery"]
            push("B", name, tid, ts_us,
                 args={"episode": ev.get("episode"),
                       "fault": ev.get("fault"),
                       "detail": ev.get("detail")})
            # flow arrows chain the ladder: this action -> the next one
            if i + 1 < len(recoveries):
                flow_id += 1
                push("s", "ladder", tid, ts_us, id=flow_id)
                push("f", "ladder", tid, nxt, id=flow_id, bp="e")
            push("E", name, tid, round(ts_us + dur, 1))
            if ev.get("site") == "prefetcher":
                push("i", ev.get("action") or "restart",
                     TRACE_TRACKS["prefetcher"], ts_us, s="t",
                     args={"episode": ev.get("episode")})
        elif kind == "compile":
            dur = round(float(ev.get("duration_s") or 0.0) * 1e6, 1)
            start = max(compile_end, ts_us - dur)
            end = max(ts_us, start)
            push("B", f"{ev.get('fn')} [{ev.get('stage')}]",
                 TRACE_TRACKS["compile"], start,
                 args={"count": ev.get("count")})
            push("E", f"{ev.get('fn')} [{ev.get('stage')}]",
                 TRACE_TRACKS["compile"], end)
            compile_end = end
        elif kind == "compile_cost":
            push("i", f"cost {ev.get('fn')}", TRACE_TRACKS["compile"],
                 max(ts_us, compile_end), s="t",
                 args={"flops": ev.get("flops"),
                       "bytes_accessed": ev.get("bytes_accessed"),
                       "fusions": ev.get("fusions")})
            compile_end = max(ts_us, compile_end)
        elif kind == "serve_start":
            push("i", "serve_start", TRACE_TRACKS["serve"], ts_us, s="t",
                 args={"tier": ev.get("tier"),
                       "startup_s": ev.get("startup_s")})
        elif kind == "serve_stats":
            push("C", "serve", TRACE_TRACKS["serve"], ts_us,
                 args={"rps": float(ev.get("rps") or 0.0),
                       "p99_ms": float(ev.get("p99_ms") or 0.0),
                       "queue_depth": float(ev.get("queue_depth") or 0)})
        elif kind == "serve_flush":
            # one complete slice per device call ("X": self-contained
            # duration, so overlapping flushes never unbalance a B/E
            # stack); ts is the dispatch wall time the tracer pinned
            dur = round(max(float(ev.get("device_ms") or 0.0), 0.0)
                        * 1e3, 1)
            push("X", f"flush b{ev.get('bucket')}", TRACE_TRACKS["serve"],
                 ts_us, dur=dur,
                 args={"flush_id": ev.get("flush_id"),
                       "n_real": ev.get("n_real"),
                       "pad_fraction": ev.get("pad_fraction")})
        elif kind == "serve_request_span":
            # sampled request: enqueue -> fan-out as one slice, with the
            # queue/batch/device/fan-out split in args; a flow arrow
            # links it to its flush's slice on the serve track
            total_ms = (float(ev.get("latency_ms") or 0.0)
                        + max(float(ev.get("fanout_ms") or 0.0), 0.0))
            push("X", f"req {ev.get('trace_id')}",
                 TRACE_TRACKS["serve_request"], ts_us,
                 dur=round(max(total_ms, 0.0) * 1e3, 1),
                 args={k: ev.get(k) for k in
                       ("trace_id", "flush_id", "bucket", "queue_wait_ms",
                        "batch_wait_ms", "device_ms", "fanout_ms",
                        "latency_ms", "deadline_miss")})
            f_ts = flush_ts.get((seg_of[id(ev)], ev.get("flush_id")))
            if f_ts is not None and f_ts >= ts_us:
                flow_id += 1
                push("s", "serve_req", TRACE_TRACKS["serve_request"],
                     ts_us, id=flow_id)
                push("f", "serve_req", TRACE_TRACKS["serve"], f_ts,
                     id=flow_id, bp="e")
        elif kind == "async_actor_ep":
            # one deferred record per actor-episode; every span below
            # uses the PAYLOAD wall times, not this record's emit ts.
            # All complete slices ("X") — reconstructed spans from three
            # concurrent threads must never share a B/E stack.
            aid = int(ev.get("actor") or 0)
            tid = ACTOR_TRACK_BASE + aid
            s = seg_of[id(ev)]
            ep = ev.get("ep")
            for c0, c1, ver in (ev.get("chunks") or []):
                push("X", f"rollout ep{ep}", tid, _us(float(c0), t0),
                     dur=round(max(float(c1) - float(c0), 0.0) * 1e6, 1),
                     args={"episode": ep, "version": int(ver)})
            for t_enq, wait_s, steps, ver, seq in (ev.get("puts") or []):
                t_enq, wait_s = float(t_enq), max(float(wait_s), 0.0)
                enq_us = _us(t_enq, t0)
                # the backpressure wait the put paid, on the actor track
                push("X", "put", tid, _us(t_enq - wait_s, t0),
                     dur=round(wait_s * 1e6, 1),
                     args={"seq": int(seq), "steps": int(steps),
                           "staleness_wait_s": round(wait_s, 6),
                           "version": int(ver)})
                ing = async_ingest.get((s, int(seq)))
                ing_us = _us(float(ing[0]), t0) if ing else None
                # queued residency on the channel track: put -> pop
                push("X", f"block s{seq}", TRACE_TRACKS["channel"],
                     enq_us,
                     dur=(round(max(ing_us - enq_us, 0.0), 1)
                          if ing_us is not None else 0.0),
                     args={"seq": int(seq), "steps": int(steps),
                           "staleness_wait_s": round(wait_s, 6),
                           "version": int(ver)})
                if ing_us is not None and ing_us >= enq_us:
                    flow_id += 1
                    push("s", "chan", tid, enq_us, id=flow_id,
                         args={"steps": int(steps),
                               "staleness_wait_s": round(wait_s, 6)})
                    push("f", "chan", TRACE_TRACKS["learner"], ing_us,
                         id=flow_id, bp="e")
            for a_ts, ver in (ev.get("adopts") or []):
                a_us = _us(float(a_ts), t0)
                push("i", f"adopt v{int(ver)}", tid, a_us, s="t",
                     args={"version": int(ver)})
                # publish -> adopt: one arrow per adopting actor (the
                # validator balances s/f per flow id, so a version
                # adopted by N actors gets N independent arrows)
                p_ts = async_pub.get((s, int(ver)))
                if p_ts is not None and _us(p_ts, t0) <= a_us:
                    flow_id += 1
                    push("s", f"publish v{int(ver)}",
                         TRACE_TRACKS["learner"], _us(p_ts, t0),
                         id=flow_id)
                    push("f", f"publish v{int(ver)}", tid, a_us,
                         id=flow_id, bp="e")
        elif kind == "async_learner_spans":
            ltid = TRACE_TRACKS["learner"]
            for row in (ev.get("ingests") or []):
                # rows grew a trailing dp-shard id (producer's stable
                # assignment) with the sharded async ring; pre-shard
                # recordings carry 6 elements — unpack tolerantly
                i0, i1, steps, ver, lag, seq = row[:6]
                args = {"seq": int(seq), "steps": int(steps),
                        "version": int(ver), "policy_lag": int(lag)}
                if len(row) > 6:
                    args["replay_shard"] = int(row[6])
                push("X", "replay_ingest", ltid, _us(float(i0), t0),
                     dur=round(max(float(i1) - float(i0), 0.0) * 1e6, 1),
                     args=args)
            for b0, b1, n in (ev.get("bursts") or []):
                push("X", f"learn_burst {int(n)}", ltid,
                     _us(float(b0), t0),
                     dur=round(max(float(b1) - float(b0), 0.0) * 1e6, 1),
                     args={"burst": int(n)})
            for p_ts, ver in (ev.get("publishes") or []):
                push("i", f"publish v{int(ver)}", ltid,
                     _us(float(p_ts), t0), s="t",
                     args={"version": int(ver)})
        # other event kinds (precision, harness_episode, ...) carry no
        # timeline geometry — the report renders them, the trace skips them

    # flows ride INSIDE slices; keep pairs adjacent under the stable sort
    order_key = {"M": 0}
    out.sort(key=lambda e: (e.get("ts", 0.0),
                            order_key.get(e.get("ph"), 1)))
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "metadata": {"run": run, "exporter": "gsc_tpu_torch.obs.trace",
                         "t0_unix_s": t0}}


def validate_trace(trace: Dict) -> List[str]:
    """Strict schema check; returns a list of problems (empty = valid).

    Rules: every event carries ph/name/pid/tid and a numeric ts >= 0;
    events are globally sorted by ts; per (pid, tid) the B/E events form
    a properly nested stack (names match, nothing left open); "X" events
    need dur >= 0; every flow start ("s") has a matching finish ("f")."""
    errors: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    stacks: Dict[tuple, List[str]] = {}
    flows_open: Dict[object, int] = {}
    last_ts = None
    for i, ev in enumerate(events):
        for field in ("ph", "name", "pid", "tid"):
            if field not in ev:
                errors.append(f"event {i}: missing {field!r}")
        ph = ev.get("ph")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph != "M":
            if last_ts is not None and ts < last_ts:
                errors.append(f"event {i}: ts {ts} < previous {last_ts} "
                              "(stream not monotone)")
            last_ts = ts
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(ev.get("name"))
        elif ph == "E":
            stack = stacks.get(key) or []
            if not stack:
                errors.append(f"event {i}: E with empty stack on {key}")
            else:
                top = stack.pop()
                if ev.get("name") and ev["name"] != top:
                    errors.append(f"event {i}: E {ev['name']!r} does not "
                                  f"match open B {top!r} on {key}")
        elif ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) \
                    or ev["dur"] < 0:
                errors.append(f"event {i}: X with bad dur {ev.get('dur')!r}")
        elif ph == "s":
            flows_open[ev.get("id")] = flows_open.get(ev.get("id"), 0) + 1
        elif ph == "f":
            if flows_open.get(ev.get("id"), 0) <= 0:
                errors.append(f"event {i}: flow finish without start "
                              f"(id {ev.get('id')!r})")
            else:
                flows_open[ev["id"]] -= 1
    for key, stack in stacks.items():
        if stack:
            errors.append(f"unclosed B events on {key}: {stack}")
    for fid, n in flows_open.items():
        if n:
            errors.append(f"flow start without finish (id {fid!r})")
    return errors


def export_trace(src: str, out_path: Optional[str] = None):
    """events.jsonl (or run dir) -> validated trace dict; optionally
    written to ``out_path``.  Returns ``(trace, errors)`` — the caller
    decides whether a non-empty error list is fatal."""
    trace = build_trace(read_events(src))
    errors = validate_trace(trace)
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(trace, f)
    return trace, errors
