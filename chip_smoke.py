#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``gsc_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them;
2. build: compiles every kernel of the serving path from the sources in
   this checkout (``gsc_tpu_torch/csrc/*.cu``, nvcc for sm_90a, into
   ``gsc_tpu_torch/_build/``) and prints the build seconds;
3. kernels against their plain versions on the card, f32, at the serving
   shapes (B, N, F) = (1, 24, 22), (4, 24, 22), (8, 24, 22), the learn-burst
   shape (100, 24, 22) and one N > 32 case (4, 64, 22), mean and sum
   aggregation, seeded inputs with padded nodes and rows without a
   neighbour (which must come out exactly 0); prints, for both
   aggregations, the error against the plain version and each side's
   distance to a float64 evaluation, and for mean aggregation (the
   flagship's) the kernel's time, the plain version's and the bound;
4. the slice: ``run_serve`` on Abilene at the flagship widths (GATv2 22
   features x 2 layers x 2 iterations, actor hidden 256, action dim 1728)
   with ``gnn_impl="pallas"`` on the card, 8 pool steps and actor weights
   drawn from seed 0, in three bursts: 64 requests at concurrency 4 (the
   reported requests/s and p50/p99), 8 at concurrency 1 (every dispatch in
   bucket 1) and 32 at concurrency 8 (bucket 8).  Each of buckets 1/4/8
   must serve requests.  Every answer must be finite, of shape [1728],
   with every destination row summing to 1, and equal to an unbatched call
   and to the plain (dense) actor's answer on the same observation; the
   kernel's launch count over the three bursts must be exactly 3 per
   dispatch and warm-up call (one encoder conv, the tied process conv
   twice);
5. a JSON line of the kernels (name, route, source, the TPU kernel it
   replaces, launches on the main path, max abs error, ms, plain ms, bound
   ms and what bounds it, library ms);
6. last line: ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Tolerances (stated here, used below): the kernel against its plain
version rtol 1e-5 / atol 1e-5 (f32 in another summation order: the
unit-normal inputs give logits summed over 22 products, whose ~1e-6
relative rounding differences exp and the weighted sum carry into up to
~1e-5 absolute on outputs of a few units); that this is rounding and not a
fault is checked on every shape and aggregation: the kernel must lie no
further from a float64 evaluation of the same inputs than F64_RATIO times
the plain version's distance (floored at F64_FLOOR); served
answers against unbatched and plain-actor answers rtol 1e-5 / atol 1e-6,
except in destination rows where a pre-threshold value lies within 1e-4
of the 0.1 threshold (a last-bit difference may flip that entry).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-5
ANSWER_RTOL, ANSWER_ATOL = 1e-5, 1e-6
THRESH_TOL = 1e-4
F64_RATIO, F64_FLOOR = 4.0, 1e-7
# one H100 SXM (NVIDIA data sheet): HBM rate and the f32 rate outside the
# tensor cores, which is what this f32 CUDA-core kernel can use
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SHAPES = [(1, 24, 22), (4, 24, 22), (8, 24, 22), (100, 24, 22), (4, 64, 22)]
# the largest bucket the main path dispatches: its timings go into the
# JSON line
MAIN_SHAPE = (8, 24, 22)
# (requests, concurrency) of the serving bursts: concurrency 4 is the
# measured load; 1 and 8 make the batcher fill buckets 1 and 8
BURSTS = [(64, 4), (8, 1), (32, 8)]
BUCKETS = (1, 4, 8)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def gat_inputs(b, n, f, seed, torch, device):
    """Seeded attention inputs with padded nodes and empty rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xl = rng.normal(size=(b, n, f)).astype(np.float32)
    xr = rng.normal(size=(b, n, f)).astype(np.float32)
    att = rng.normal(size=(f,)).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    adj = rng.uniform(size=(b, n, n)) < 0.3
    real = n - 3
    adj[:, np.arange(real), np.arange(real)] = True
    adj[:, real:, :] = False
    adj[:, :, real:] = False
    adj[:, :2, :] = False
    return [torch.from_numpy(a).to(device) for a in (xl, xr, att, bias, adj)]


def cuda_time_ms(fn, torch, reps=200, warmup=20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_device_ms(fn, torch, reps=20, kernel=None):
    """Device time per call of ``fn`` from the profiler's CUDA events: the
    kernels whose name contains ``kernel`` (all kernels when None).  None
    when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:   # a machine that refuses tracing: no number
        print(f"  profiler unavailable ({e}); device time not measured")
        return None
    total_us = 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us and (kernel is None or kernel in evt.key):
            total_us += dev_us
    return total_us / reps / 1e3 if total_us > 0 else None


def gat_bound(args):
    """Least time for the attention stage on these inputs: every input
    read once and the output written once over the HBM rate, against the
    f32 operations this adjacency needs over the f32 rate."""
    xl, xr, att, bias, adj = args
    b, n, f = xl.shape
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + xl.numel() * xl.element_size()
    edges = int(adj.sum())
    rows = int(adj.any(dim=-1).sum())
    # per edge: add, leaky select, multiply-add into the logit (4F), exp,
    # normalise (2), weighted accumulate (2F); per row: divide + bias (2F)
    ops = edges * (6 * f + 3) + rows * 2 * f
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ambiguous_rows(pre, thr=0.1, n_dst=24):
    """Destination rows where a value before either threshold pass lies
    within THRESH_TOL of the threshold."""
    import numpy as np

    rows = np.clip(pre, 0.0, 1.0).reshape(pre.shape[:-1] + (-1, n_dst))
    amb = np.zeros(rows.shape[:-1], bool)
    for _ in range(2):
        amb |= (np.abs(rows - thr) < THRESH_TOL).any(-1)
        kept = np.where(rows >= thr, rows, 0.0)
        total = kept.sum(-1, keepdims=True)
        rows = np.where(total > 0, kept / np.maximum(total, 1e-30),
                        1.0 / n_dst)
    return amb


def compare_answers(got, want, pre, what):
    """Exact zero pattern and close values outside ambiguous rows."""
    import numpy as np

    amb = ambiguous_rows(pre)
    g = got.reshape(-1, 24)[~amb.reshape(-1)]
    w = want.reshape(-1, 24)[~amb.reshape(-1)]
    check(np.array_equal(g == 0, w == 0),
          f"{what}: thresholded entries differ outside ambiguous rows")
    err = float(np.max(np.abs(g - w))) if g.size else 0.0
    check(np.allclose(g, w, rtol=ANSWER_RTOL, atol=ANSWER_ATOL),
          f"{what}: answers differ by {err}")
    return err, int(amb.sum())


def ddpg_policy_batch(report, b, torch, dev):
    """A [b]-stack of the served pool's observations on ``dev``."""
    import numpy as np

    from gsc_tpu_torch.env.observations import GraphObs

    obs = [report.pool[i % len(report.pool)] for i in range(b)]
    return GraphObs(**{f: torch.from_numpy(np.stack(
        [np.asarray(getattr(o, f)) for o in obs])).to(dev)
        for f in vars(obs[0])})


def check_answers(report, plain_actor, torch, dev):
    """Every answer of one burst: finite, [1728], rows summing to 1, equal
    to an unbatched call and to the plain actor.  Returns the largest
    difference and the count of ambiguous rows."""
    import numpy as np

    from gsc_tpu_torch.env.observations import GraphObs

    ddpg = report.ddpg
    worst = 0.0
    ambiguous = 0
    for k, ans in report.answers:
        check(ans.shape == (1728,) and bool(np.isfinite(ans).all()),
              f"answer for pool obs {k} is {ans.shape} or not finite")
        check(np.allclose(ans.reshape(-1, 24).sum(-1), 1.0, rtol=1e-5),
              "a destination row does not sum to 1")
    for k in sorted({k for k, _ in report.answers}):
        obs = GraphObs(**{f: torch.from_numpy(np.asarray(v))[None].to(dev)
                          for f, v in vars(report.pool[k]).items()})
        with torch.inference_mode():
            single = ddpg.greedy_action(obs)[0].cpu().numpy()
            pre = ddpg.actor(obs)[0].cpu().numpy()
            plain = ddpg.env.process_action(
                plain_actor(obs).clamp(0.0, 1.0))[0].cpu().numpy()
        e1, a1 = compare_answers(single, plain, pre,
                                 f"kernel vs plain actor, obs {k}")
        worst = max(worst, e1)
        ambiguous += a1
        for kk, ans in report.answers:
            if kk == k:
                e2, _ = compare_answers(ans, single, pre,
                                        f"batched vs unbatched, obs {k}")
                worst = max(worst, e2)
    return worst, ambiguous


def main() -> int:
    import numpy as np
    import torch

    t_start = time.perf_counter()
    # ---- 1. device -----------------------------------------------------
    check(torch.cuda.is_available(), "CUDA is not available")
    from gsc_tpu_torch.device import resolve_device
    from gsc_tpu_torch.models.nets import Actor
    from gsc_tpu_torch.ops.gat_attention import (SOURCE, attention_plain,
                                                 gat_attention)
    from gsc_tpu_torch.serve import run_serve

    dev = resolve_device()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"device: {name} (x{count}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    gat_attention.library()
    build_s = time.perf_counter() - t0
    print(f"build: gat_attention {build_s:.2f} s", flush=True)
    for line in gat_attention.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel vs plain on the card ---------------------------------
    max_err = 0.0
    timings = {}
    print(f"kernel vs plain (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}) on "
          f"{smi}:")
    for b, n, f in SHAPES:
        for mean in (True, False):
            args = gat_inputs(b, n, f, seed=b * 1000 + n, torch=torch,
                              device=dev)
            got = gat_attention.launch(*args, mean)
            torch.cuda.synchronize()
            want = attention_plain(*args, mean)
            err = float((got - want).abs().max())
            rel = float(((got - want).abs()
                         / want.abs().clamp(min=1e-6)).max())
            # how far each f32 result lies from a float64 evaluation
            ref = attention_plain(*[a.double() if a.is_floating_point()
                                    else a for a in args], mean)
            k64 = float((got.double() - ref).abs().max())
            p64 = float((want.double() - ref).abs().max())
            max_err = max(max_err, err)
            aggr = "mean" if mean else "sum"
            line = (f"  B={b:3d} N={n:2d} F={f} {aggr:4s}: max abs err "
                    f"{err:.2e} rel {rel:.2e}, max |out| "
                    f"{float(want.abs().max()):.2f} (vs f64: kernel "
                    f"{k64:.2e}, plain {p64:.2e})")
            print(line, flush=True)
            check(torch.allclose(got, want, rtol=KERNEL_RTOL,
                                 atol=KERNEL_ATOL),
                  f"kernel != plain at {(b, n, f)} {aggr}: "
                  f"max abs err {err}")
            check(k64 <= F64_RATIO * max(p64, F64_FLOOR),
                  f"kernel is {k64} from float64 at {(b, n, f)} {aggr}, "
                  f"the plain version {p64}")
            empty = ~args[4].any(dim=-1)
            check(bool(empty.any()) and bool((got[empty] == 0).all()),
                  f"rows without a neighbour are not exactly 0 at {(b, n, f)}")
            if mean:
                ms = cuda_time_ms(lambda: gat_attention.launch(*args, True),
                                  torch)
                plain_ms = cuda_time_ms(
                    lambda: attention_plain(*args, True), torch, reps=50)
                bound_ms, bound_by = gat_bound(args)
                timings[(b, n, f)] = (ms, plain_ms, bound_ms, bound_by)
                dev_ms = profile_device_ms(
                    lambda: gat_attention.launch(*args, True), torch,
                    kernel="gat_attention_kernel")
                plain_dev_ms = profile_device_ms(
                    lambda: attention_plain(*args, True), torch)
                fmt = lambda v: "not measured" if v is None else f"{v:.5f} ms"
                print(f"    per call (events) kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms; device time (profiler) kernel "
                      f"{fmt(dev_ms)}, plain {fmt(plain_dev_ms)}; bound "
                      f"{bound_ms:.6f} ms ({bound_by})", flush=True)

    # ---- 4. the slice: run_serve on the card ----------------------------
    gat_attention.launches = 0
    reports = [run_serve(device=dev, pool_steps=8, requests=r,
                         concurrency=c, buckets=BUCKETS, seed=0)
               for r, c in BURSTS]
    launches = gat_attention.launches
    calls = sum(len(rep.flushes) + len(rep.startup["buckets"])
                for rep in reports)
    check(launches == 3 * calls,
          f"{launches} kernel launches for {calls} dispatches and warm-up "
          "calls (want 3 per call)")
    served = set()
    for (r, c), report in zip(BURSTS, reports):
        summ = report.summary()
        check(not report.errors, f"serve errors: {report.errors[:3]}")
        check(len(report.answers) == r, f"{len(report.answers)} of {r} "
              "answered")
        ddpg = report.ddpg
        plain_actor = Actor(ddpg.agent, ddpg.action_dim,
                            gnn_impl="dense").to(dev)
        plain_actor.load_state_dict(ddpg.actor.state_dict())
        worst, ambiguous = check_answers(report, plain_actor, torch, dev)
        used = sorted({b for _, b in report.flushes})
        served.update(used)
        print(f"serve burst: {summ['completed']} requests at concurrency {c}, "
              f"{summ['dispatches']} dispatches (buckets {used}); "
              f"{summ['requests_per_s']:.1f} req/s, p50 {summ['p50_ms']:.3f} ms, "
              f"p99 {summ['p99_ms']:.3f} ms, startup {summ['startup_s']:.2f} s on "
              f"{smi}; answers vs unbatched and plain actor max abs diff "
              f"{worst:.2e} ({ambiguous} ambiguous rows)", flush=True)
        print(f"serve_summary c={c}: " + json.dumps(summ))
    check(served == set(BUCKETS),
          f"buckets {sorted(set(BUCKETS) - served)} served no request")
    print(f"serve: {sum(r for r, _ in BURSTS)} requests through buckets "
          f"{sorted(served)}, {launches} kernel launches", flush=True)
    report = reports[0]
    ddpg = report.ddpg
    # where a request's device call goes: the whole greedy policy against
    # its three attention launches, at buckets 1 and 8 (CUDA events)
    for b in (1, 8):
        leaves = ddpg_policy_batch(report, b, torch, dev)
        with torch.inference_mode():
            fwd_ms = cuda_time_ms(lambda: ddpg.greedy_action(leaves), torch,
                                  reps=50, warmup=5)
        print(f"greedy_action B={b}: {fwd_ms:.4f} ms per call on the card "
              f"(3 attention launches: {3 * timings.get((b, 24, 22), (0,))[0]:.4f} ms)")

    # ---- 5. kernels line ------------------------------------------------
    ms, plain_ms, bound_ms, bound_by = timings[MAIN_SHAPE]
    kernels = {"kernels": [{
        "name": "gat_attention",
        "route": "cuda",
        "source": str(SOURCE.relative_to(SOURCE.parents[2])),
        "replaces": "gsc_tpu/ops/pallas_gat.py:45",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # noqa: BLE001 - any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
