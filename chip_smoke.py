#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``gsc_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them;
2. build: compiles the three kernel sources (the GATv2 attention kernel,
   its backward kernel, each with an f32 and a bf16 entry point whose
   wrappers share the library, and the substep megakernel) from this
   checkout (``gsc_tpu_torch/csrc/*.cu``, one nvcc for each, started
   together, for sm_90a, into ``gsc_tpu_torch/_build/``), the megakernel
   a second time with ``-DSUBSTEP_STAGE_CLOCKS`` for phase 7's stage
   clocks, both attention kernels a second time with
   ``-DGAT_STAGE_CLOCKS`` for phase 3's, and, where
   ``_parent/substep_megakernel.cu`` or ``_parent/gat_attention.cu``
   exist (copies of the parent commit's sources, never committed; the
   latter only with its wrapper ``_parent/gat_attention.py`` beside it),
   those for the comparisons of phases 7 and 3; prints the build
   seconds and each ptxas line of registers, shared memory and spills;
3. the attention kernels against their plain versions on the card, f32,
   at the serving shapes (B, N, F) = (1, 24, 22), (4, 24, 22), (8, 24, 22),
   the training rollout's (64, 24, 22), the learn-burst shape (100, 24, 22)
   and one N > 32 case (4, 64, 22), mean and sum
   aggregation, seeded inputs with padded nodes and rows without a
   neighbour (which must come out exactly 0) and a seeded grad_out: the
   forward kernel against ``attention_plain``, the backward kernel's
   (d_xl, d_xr, d_att, d_bias) against ``attention_backward_plain`` (d_xr
   exactly 0 on rows without a neighbour, two launches bit-identical),
   and both again at the learn-burst shape on inputs whose softmax
   saturates, as trained weights make it (logits ~12 apart);
   prints, for both aggregations, the errors against the plain versions
   and each side's distance to a float64 evaluation, and for mean
   aggregation (the flagship's) each kernel's device time (profiler) and
   time per call with its wrapper (CUDA events), the plain versions'
   times, the dense VJP's time per call (what the backward replaces) in
   turns with the backward kernel's (VJP, kernel, kernel, VJP), the
   parent forward kernel's device time and time per call in turns with
   this one's where it was built (and the backward's in 10 alternating
   pairs at the learn-burst shape), and each kernel's bound; then each
   attention kernel's share of a launch per stage (block 0's clock64() at
   its stage barriers, from the stage-clocks builds, whose results must
   equal the kernels'): the forward's at the learn-burst shape, the
   backward's at the learn bursts' shapes (100, 24, 22), (100, 128, 22)
   and (100, 256, 22), and the parent backward's beside it where
   ``_parent/gat_attention_backward.cu`` was built;
4. the slice: ``run_serve`` on Abilene at the flagship widths (GATv2 22
   features x 2 layers x 2 iterations, actor hidden 256, action dim 1728)
   with ``gnn_impl="pallas"`` on the card, a request pool of 8 env steps
   (each one megakernel launch, checked) and actor weights
   drawn from seed 0, in three bursts: 64 requests at concurrency 4 (the
   reported requests/s and p50/p99), 8 at concurrency 1 (every dispatch in
   bucket 1) and 32 at concurrency 8 (bucket 8).  Each of buckets 1/4/8
   must serve requests.  Every answer must be finite, of shape [1728],
   with every destination row summing to 1, and equal to an unbatched call
   and to the plain (dense) actor's answer on the same observation; the
   kernel's launch count over the three bursts must be exactly 3 per
   dispatch and warm-up call (one encoder conv, the tied process conv
   twice);
5. the substep megakernel against its plain version (the engine's plain
   substep) on the card and on CPU copies of the same inputs, over the
   battery of ``gsc_tpu_torch.sim.cases``: the six drop-taxonomy
   scenarios, the WRR-collision triangle, the saturated-link line,
   fractional data rates and Abilene with 64 replicas and with one (the
   single-env trainer's batch) under a seeded non-uniform schedule, data
   rates of a range (1e-30 beside 1e10) whose
   admission sums no double holds exactly, and Abilene under heavy
   traffic at 1024 and at 200 flow slots.  Every leaf of state and metrics
   must be bit-equal to the plain version on CPU copies of the inputs,
   and within the tolerance below of the plain version on the card (each
   side's distance is printed); two launches on the same inputs must be
   bit-identical, and a single-substep launch must agree as well; the
   kernel's count of admission rounds that took its sequential scan must
   be above 0 on the wide-range case and 0 on every other;
6. the seeded Abilene golden trajectory on the kernel path: generated
   800, processed 658, dropped 133, active 9, drop reasons [0, 0, 0,
   133], average end-to-end delay 34.75 +- 0.1;
7. the megakernel's time per interval at B = 1, 64 and 256 replicas
   (CUDA events with the wrapper, profiler device time of the kernel),
   the plain engine's time and the bound, and, where the parent's source
   was built, the parent kernel's device time on the same inputs, timed
   in turns (parent, kernel, kernel, parent); at B = 64 also its device
   time with 0 and 1 admission rounds and with 1 WRR rank level (the
   default is 3 and 4), and the clocked build's share of an interval per
   stage (thread 0's clock64() between the stage's barriers), which say
   where an interval's time goes;
8. the training slice: ``python -m gsc_tpu_torch.cli train --replicas 64
   --chunk 50 --episodes 2`` through ``cli.run_train`` on Abilene at the
   flagship widths (the first episode warm-up, the second acting through
   the actor, each ending in a 200-step learn burst).  Every return, loss
   and q must be finite, every actor and critic parameter must have moved,
   every replay shard must hold min(400, mem_limit // 64) transitions, the
   megakernel must launch once per env step, the attention kernel 3 times
   per acting rollout step plus 15 times per gradient step (critic loss:
   target actor, target critic, critic; actor loss: actor, critic) plus 3
   times per step of the greedy evaluation episode that ends every
   ``train`` (on one env; the megakernel once per step there too), its
   backward kernel 6 times per gradient step (the critic's 3 convs in the
   critic loss, the actor's 3 in the actor loss; the critic's GNN is not
   differentiated in the actor loss) and never while acting, and on one
   sampled batch the gradients of every actor and critic parameter
   through the kernels' ``autograd.Function`` must equal the dense path's;
   prints the rollout's env-steps/s and each learn burst's seconds;
9. the bf16 attention kernels (``gat_attention_bf16``,
   ``gat_attention_backward_bf16``: the bf16 forms of both attention
   sources) against their plain versions at phase 3's shapes and
   aggregations, and at the saturated learn-burst inputs, on the same
   inputs with xl, xr and grad_out rounded to bf16: each bf16 output (the
   forward's, d_xl, d_xr) within one bf16 ulp of the tensor's largest
   entry of the plain version's and no further from a float64 evaluation
   at the same rounding points than twice the plain version (floored at a
   quarter of that ulp); d_xl and d_xr with the f32 backward's absolute
   floors besides (BWD_ATOL, F64_FLOOR: a saturated softmax's d_xr is
   ~1e-12 everywhere, f32 rounding, below one ulp of its largest entry's
   noise), d_att and d_bias within the f32 backward's tolerance, d_xr 0
   on rows without a neighbour, relaunches bit-identical;
   prints, at mean aggregation, each bf16 kernel's device time and time
   per call, its bound (xl, xr, out, grad_out, d_xl, d_xr at 2 bytes) and
   the f32 kernel's time at the same shape, taken in turns (f32, bf16,
   bf16, f32), and where the parent's backward was built, its bf16 form's
   device time and time per call in turns with this one's (parent,
   kernel, kernel, parent) and, at the learn-burst shape, in 10
   alternating pairs;
10. the bf16 training slice: ``cli train --precision bf16 --replicas 64
   --chunk 50 --episodes 2 --checkpoint DIR`` at the flagship widths, with
   every kernel count set to 0 before it: the bf16 attention kernels must
   launch 3 times per acting step plus 15 per gradient step and 6 per
   gradient step, the f32 attention kernels 0 times, the megakernel once
   per env step; every actor and critic parameter must move, the masters
   and Adam states stay f32, the replay's float leaves be bf16, the
   checkpoint's sidecar record bf16, and on one sampled batch the
   gradients through the bf16 kernels must match those through the
   kernels' plain versions (``attention_plain`` with
   ``attention_backward_plain`` as its gradient, on the card) within
   GRAD_BF16_SCALE of each tensor's largest entry; prints how far the
   dense bf16 path's autograd lies from them, and the rollout
   env-steps/s and each learn burst's seconds beside the f32 run's;
11. the bf16 serving slice: ``run_serve(checkpoint=DIR)`` on that
   checkpoint (bf16 adopted from its sidecar), 64 requests at concurrency
   4 and 32 at concurrency 8, with the counts set to 0 before it: the bf16
   forward kernel 3 times per dispatch and warm-up call, the f32 one 0
   times; every answer finite, [1728], rows summing to 1, and equal to the
   plain (dense) bf16 actor's answer on CPU copies and to an unbatched
   call within ANSWER_BF16_RTOL / ANSWER_BF16_ATOL outside rows with a
   value within THRESH_BF16_TOL of the threshold; prints requests/s and
   p50/p99;
12. (printed after phase 15) a JSON line
   of the kernels (name, route, source, the TPU kernel it replaces,
   launches summed over the runs of phases 8, 10, 13, 14 and 15, max abs
   error, ms, plain ms, bound ms and what bounds it, library ms);
13. the generalization slice, the reference's own training path at the
   flagship widths: ``cli.init_configs`` writes the yaml set and the
   GraphML networks with the port's writer (bteurope-in2 must read back
   as 24 nodes, 37 edges and caps in 1-2); ``cli.run_train --scheduler
   --replicas 1`` trains one env for 3 episodes on a schedule of
   abilene-in4 and claranet-in4-cap1 switching every episode, each
   episode ending in a 200-step learn burst, and evaluates greedily on
   compuserve-in4-cap1, which no episode trained on.  With every count 0
   before it: the megakernel once per env and evaluation step (at B=1),
   the attention kernel 3 times per acting and evaluation step at B=1 and
   15 times per gradient step at B=100, its backward 6 times per gradient
   step, no bf16 kernel; returns and losses finite, every parameter
   moved, the replay's ``topo_idx`` naming each episode's network, the
   checkpoint's sidecar its episode count.  Then 2 episodes, a
   checkpoint and ``--resume`` to 3 must give the straight run's tensors
   (networks, targets, Adam states, replay leaves, pos/size, the Draws
   generator state) under ``torch.equal``, bit for bit; ``cli.run_infer``
   on the straight run's checkpoint must reproduce its evaluation
   exactly.  Prints the single-env rollout's env-steps/s, each
   learn burst's seconds, the evaluation's ``compile_warmup_s`` /
   ``steady_s``, the checkpoint's save and load seconds, the launch
   counts per batch shape, and where a single-env step goes: 20 acting
   steps under ``torch.profiler`` (wall and device time per step, the
   megakernel's part, kernel launches and device-to-host reads per step),
   the last of whose megakernel launches (B=1, on the trained policy's
   schedule over claranet) must be bit-equal to the plain version on CPU
   copies of its inputs and within the tolerance below of it on the card;
   and the seconds of each of the phase's parts;
14. bench.py's two largest stacks (``large_network_slice``): (a) the four
   attention forms at (4, 128, 22) and (4, 256, 22) (graphs cut into
   CTAs of 32 target rows, the backward's as 4- and 8-CTA clusters)
   against their plain versions on unit-normal and saturated inputs,
   both aggregations, at phases 3's and 9's tolerances (on saturated
   inputs d_att and d_bias against float64 only), relaunches
   bit-identical, and each form's device time, time per call, plain time
   and bound at mean aggregation; both backward forms at the learn bursts'
   batch, (100, 128, 22) and (100, 256, 22), checked at mean aggregation
   and timed the same way, in turns with the parent's where built; (b)
   the megakernel on one interroute
   (M=1024, N=128) and one rung-5 (M=1024, N=256, P=5) interval at B=2,
   bit-equal to its plain version on CPU copies, a relaunch
   bit-identical, its shared memory, device time and bound; (c)
   ``cli.run_train`` on Interoute (128 nodes / 192 edges, abc chain,
   1024 slots, 200-step episodes, ``mem_limit`` 2048, the factored heads)
   at 8 replicas for 2 f32 episodes with a checkpoint and (d) 1 bf16
   episode, with phase 8's checks (launch counts per step, every
   parameter moved, replay fill, gradients through the kernels against
   the dense path or the plain versions); (e) ``run_serve`` of 16
   requests at concurrency 4 from the f32 checkpoint's factored actor,
   answers against unbatched calls and the plain actor; (f)
   ``cli.run_train`` on rung 5 (``random_network(200, num_ingress=8,
   seed=11)`` through GraphML, padded to 256 / 384, the mixed catalog,
   ``mem_limit`` 1024) at 2 replicas for one 20-step episode and burst.
   Prints each part's seconds, every run's env-steps/s and burst seconds
   and the serving numbers beside the card's name and power limit; the
   kernels line's launch counts include this phase's;
15. the default train run (``default_run_slice``), on phase 13's schedule
   at the flagship widths with episodes cut from 200 to
   ``DEFAULT_RUN_STEPS`` steps (the warm-up as long, so each episode ends
   in a burst): (a) ``cli.run_train`` for 2 episodes with the defaults
   (the pipelined loop, the run observer, the learning-signal ledger and
   the rollback guard) and for the same 2 with ``--no-pipeline
   --no-learn-obs``: every tensor of the learner state, the replay and
   the random source ``torch.equal``, the kernel launches equal; each
   run's learn-burst seconds and, under ``torch.profiler``, kernel
   launches and milliseconds per gradient step with the ledger on and
   off; (b) ``--fault-plan "nan_grads@1;dispatch_transient@2"`` for 3
   episodes: the ``recovery`` events (site, action, episode) that
   tests/test_torch_resilience.py holds against the JAX package, and a
   finite final state; (c) ``--precision bf16`` for 1 episode: only the
   bf16 attention kernels launch; (d) the default run wrote
   ``events.jsonl``, ``metrics.json`` (with non-zero device gauges),
   ``series.json``, ``curves.json``, ``result.yaml`` and ``run.log``, and
   ``tools/obs_report.py`` exits 0 on it; (e) ``cli.run_simulate -d 500``
   on Abilene on the card (one megakernel launch per interval) and on the
   CPU (the plain engine): integer fields equal, the mean end-to-end
   delay within SUB_RTOL.  Prints each part's seconds; the kernels line's
   launch counts include this phase's;
16. last line: ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Tolerances (stated here, used below): the attention kernel against its
plain version rtol 1e-5 / atol 1e-5 (f32 in another summation order: the
unit-normal inputs give logits summed over 22 products, whose ~1e-6
relative rounding differences exp and the weighted sum carry into up to
~1e-5 absolute on outputs of a few units); its backward kernel against
``attention_backward_plain`` per output tensor: the largest difference
within 1e-5 of the tensor's largest entry plus 1e-5.  An f32 gradient entry
is a sum of up to N·F terms (d_att and d_bias over every graph of the
batch) whose size is the tensor's, not the entry's, each carrying the
forward's rounding: the plain version itself lies up to ~5e-5 from a
float64 evaluation on d_att entries of ~100 at B=100, and an entry near 0
carries the same absolute error, which an elementwise rtol would refuse
(the first card run: 3.2e-5 on a small d_att entry at B=100, sum
aggregation); the kernel adds d_att and d_bias across rows and graphs in
double.  That
this is rounding and not a fault is checked on every shape and
aggregation, for each output of both kernels: the kernel must lie no
further from a float64 evaluation of the same inputs than F64_RATIO times
the plain version's distance (floored at F64_FLOOR); served
answers against unbatched and plain-actor answers rtol 1e-5 / atol 1e-6,
except in destination rows where a pre-threshold value lies within 1e-4
of the 0.1 threshold (a last-bit difference may flip that entry).  The
megakernel's float state rtol 1e-5 / atol 1e-5 against the plain version
on the card (whose scatter-adds are float atomics and whose cumsum is a
parallel f32 scan, so it adds in another order), its integers exactly;
against the plain version on CPU copies every leaf bit for bit: the
kernel keeps the CPU version's order, or an admission scan order that is
exact in a double, and the plain version adds the whole-slot sums in
slot order as the kernel does (``sim.engine.slot_order_sum``).
Training gradients through the kernels against the dense path: per
parameter tensor, the largest difference within 1e-4 of the tensor's
largest entry plus 1e-5.  The two paths' forward outputs differ by f32
rounding, and their attention gradients (the backward kernel's against
the dense VJP) by f32 summation order; those differences reach every
gradient entry through sums whose terms are of the size of the largest
entries (actor gradients reach norms of 1e4 after two episodes), so an
entry's error scales with the tensor's scale, not with its own value (a
card run with the dense VJP on both paths: 2.4e-4 on an entry far smaller
than its tensor's largest, one f32 ulp at 2e3).  The bf16 kernels'
tolerances are stated with phase 9 and tests/test_torch_kernels.py: the
two sides round at the same points and sum in other orders, so an f32 sum
or a weight alpha may land on a neighbouring bf16 value.  Training
gradients through the bf16 kernels against the kernels' plain versions:
per parameter tensor within GRAD_BF16_SCALE of its largest entry plus
GRAD_ATOL (a last-bit difference of an f32 sum moves a bf16 activation by
one ulp, 2^-8 relative, and the layers after it carry that into the
gradients).  Not against the dense bf16 path: its autograd rounds the
cotangents of its bf16 intermediates to bf16 (as the JAX package's VJP
does), among them de_ij = dl_ij att LeakyReLU', whose sum over j cancels
(sum_j dl_ij = 0), so d_xr of a trained, saturated actor is bf16 noise:
a run on an NVIDIA H100 found the actor encoder's lin_r gradient 0.177 off
where its largest entry is 0.281.  Served bf16 answers against the plain
bf16 actor on CPU copies: the two forwards round at the same points, and
a last-bit difference of an f32 sum moves a bf16 activation by one ulp
(2^-8 relative), which the head carries into the pre-threshold values.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-5
# the backward kernel against its plain version, per output tensor: the
# largest difference within BWD_SCALE of the tensor's largest entry plus
# BWD_ATOL (see the docstring)
BWD_SCALE, BWD_ATOL = 1e-5, 1e-5
ANSWER_RTOL, ANSWER_ATOL = 1e-5, 1e-6
THRESH_TOL = 1e-4
F64_RATIO, F64_FLOOR = 4.0, 1e-7
# one H100 SXM (NVIDIA data sheet): HBM rate and the f32 rate outside the
# tensor cores, which is what this f32 CUDA-core kernel can use
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# the bf16 peak (tensor cores, dense): the least time for work on bf16
# inputs, whatever pipe a kernel uses
BF16_FLOP_PER_S = 989e12
SHAPES = [(1, 24, 22), (4, 24, 22), (8, 24, 22), (64, 24, 22),
          (100, 24, 22), (4, 64, 22)]
# the learn burst's batch, where the training path launches the attention
# kernel most (15 of every 16 launches): its timings go into the JSON line
MAIN_SHAPE = (100, 24, 22)
SUB_RTOL, SUB_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# the bf16 paths (phases 9-11; see the docstring)
GRAD_BF16_SCALE = 2.0 ** -4
ANSWER_BF16_RTOL, ANSWER_BF16_ATOL = 2.0 ** -5, 2.0 ** -9
THRESH_BF16_TOL = 2.0 ** -7
BF16_BURSTS = [(64, 4, 5.0), (32, 8, 50.0)]
# replicas of the megakernel's timings; the training path runs 64
# pairs of device-time measurements, parent and this commit in
# alternating order, behind phase 3's comparison at the learn-burst shape
PARENT_PAIRS = 10
# the learn bursts' shapes of interroute's and rung 5's graphs (batch 100),
# where phase 14 times the backward kernels (and phase 3 their stage
# clocks)
BURST_LARGE_SHAPES = [(100, 128, 22), (100, 256, 22)]
# phase 14: kernel #1 at interroute's and rung 5's graph sizes, and the
# configurations of bench.py's _interroute_stack and _rung5_stack (their
# SimConfig(ttl_choices=(100.0,), max_flows=1024) with the defaults
# written out; the flagship agent with gnn_impl "pallas" and their replay
# budgets; rung 5's episodes cut from 200 to 20 steps)
LARGE_SHAPES = [(4, 128, 22), (4, 256, 22)]
LARGE_SIM_YAML = ("inter_arrival_mean: 10.0\ndeterministic_arrival: true\n"
                  "deterministic_size: true\nflow_dr_mean: 1.0\n"
                  "flow_dr_stdev: 0.0\nflow_size_shape: 0.001\n"
                  "run_duration: 100\nttl_choices: [100]\nmax_flows: 1024\n")
INTERROUTE_AGENT_YAML = ("episode_steps: 200\nobjective: prio-flow\n"
                         "mem_limit: 2048\ngnn_impl: pallas\n")
RUNG5_AGENT_YAML = ("episode_steps: 20\nlearn_steps: 20\n"
                    "objective: prio-flow\nmem_limit: 1024\n"
                    "gnn_impl: pallas\n")
MIXED_SERVICE_YAML = (
    "sfc_list:\n  sfc_1: [a, b, c]\n  sfc_2: [d, e]\nsf_list:\n"
    + "".join(f"  {n}:\n    processing_delay_mean: {d}\n"
              "    processing_delay_stdev: 0.0\n"
              for n, d in zip("abcde", (5.0, 5.0, 5.0, 8.0, 2.0))))
INTERROUTE_NET = ["--network", "interroute", "--max-nodes", "128",
                  "--max-edges", "192"]
# requests and concurrency of phase 14's interroute serving
LARGE_SERVE = (16, 4)
SUB_TIMING_BATCHES = (1, 64, 256)
SUB_MAIN_BATCH = 64
TRAIN_ARGS = ["--replicas", "64", "--chunk", "50", "--episodes", "2",
              "--seed", "0"]
# phase 15: the default train run on phase 13's schedule, its episodes
# cut from 200 to DEFAULT_RUN_STEPS steps (warm-up as long, so every
# episode ends in a burst of as many gradient steps)
DEFAULT_RUN_STEPS = 50
DEFAULT_RUN_PLAN = "nan_grads@1;dispatch_transient@2"
DEFAULT_RUN_RECOVERIES = [("dispatch", "retry", 2),
                          ("learner_state", "rollback", 1)]
# gradient steps profiled per learn burst, ledger on and off
LEDGER_PROFILE_STEPS = 5
# phase 13: single-env episodes over the schedule (switching every
# GEN_PERIOD episodes)
GEN_EPISODES = 3
GEN_PERIOD = 1
# profiled rollout steps of its split of a single-env step
GEN_PROFILE_STEPS = 20
# operations that every flow slot does in every substep, whatever its
# phase (the phase test and the timer's advance): a lower count, since
# what else a slot does depends on phases this script does not trace
OPS_PER_SLOT_SUBSTEP = 2
# (requests, concurrency, deadline ms) of the serving bursts: concurrency
# 4 at the default 5 ms deadline is the measured load; 1 and 8 make the
# batcher fill buckets 1 and 8. The concurrency-8 burst waits up to 50 ms
# for its batch: at 5 ms, a dispatch as long as the deadline lets the
# clients settle into two groups of 4 that alternate, and bucket 8 then
# serves nothing. A full batch of 8 flushes at once, whatever the deadline.
BURSTS = [(64, 4, 5.0), (8, 1, 5.0), (32, 8, 50.0)]
# env steps that build each burst's request pool
POOL_STEPS = 8
BUCKETS = (1, 4, 8)
# copies of the parent commit's megakernel source and attention kernel
# source and wrapper, present only in a run that compares them (never
# committed)
PARENT_DIR = Path(__file__).resolve().parent / "_parent"
PARENT_SOURCE = PARENT_DIR / "substep_megakernel.cu"
PARENT_GAT_SOURCE = PARENT_DIR / "gat_attention.cu"
PARENT_GAT_WRAPPER = PARENT_DIR / "gat_attention.py"
PARENT_GAT_BACKWARD_SOURCE = PARENT_DIR / "gat_attention_backward.cu"
# the battery case whose data rates span more than a double holds
WIDE_CASE = "wide_range_dr"


class SmokeFailure(RuntimeError):
    pass


class Laps:
    """Seconds between successive ``lap(name)`` calls, the first counted
    from the object's creation, in ``seconds``."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds = {}

    def lap(self, name):
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now


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
    """Device time per call of ``fn`` from the profiler's CUDA events: all
    kernels per call when ``kernel`` is None, else per launch of the
    kernels whose name contains ``kernel``, averaged over the launches
    the profiler recorded (some profiles hold only part of a window's
    launches, which an average over ``reps`` would halve).  None when the
    profiler records no device time."""
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
    total_us, launches = 0.0, 0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us and (kernel is None or kernel in evt.key):
            total_us += dev_us
            launches += evt.count
    if total_us <= 0:
        return None
    return total_us / (reps if kernel is None else launches) / 1e3


def saturated_inputs(b, n, f, seed, torch, device, gap=12.0):
    """Attention inputs whose softmax saturates, as trained weights make
    it: ``gat_inputs``' adjacency, att = 1/F, xl_j = 100 + U(0, 10) + gap *
    rank_j, xr in U(0, 1), so each row's logits lie ~gap apart."""
    import numpy as np

    adj = gat_inputs(b, n, f, seed, torch, device)[4]
    rng = np.random.default_rng(seed + 7)
    rank = np.argsort(rng.uniform(size=(b, n)), axis=-1)
    xl = (100.0 + rng.uniform(0, 10, size=(b, n, f))
          + gap * rank[..., None]).astype(np.float32)
    xr = rng.uniform(0, 1, size=(b, n, f)).astype(np.float32)
    att = np.full((f,), 1.0 / f, np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (xl, xr, att, bias)] \
        + [adj]


def check_backward(args, grad, mean, what, torch, sums_to_f64=False):
    """The backward kernel against its plain version on one input: within
    the tolerance per output, no further from float64 than F64_RATIO times
    the plain version, d_xr 0 on rows without a neighbour, and two launches
    bit for bit the same.  ``sums_to_f64``: d_att and d_bias are held to
    the float64 evaluation only (a saturated softmax at large N, where
    their f32 sums cancel terms far larger than themselves and the plain
    version is the less accurate side).  Returns the largest difference
    and a line."""
    from gsc_tpu_torch.ops.gat_attention import (attention_backward_plain,
                                                 gat_attention_backward)

    xl, xr, att, _, adj = args
    bwd = gat_attention_backward.launch(grad, xl, xr, att, adj, mean)
    again = gat_attention_backward.launch(grad, xl, xr, att, adj, mean)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(bwd, again)),
          f"two backward launches differ at {what}")
    want = attention_backward_plain(grad, xl, xr, att, adj, mean)
    ref = attention_backward_plain(grad.double(), xl.double(), xr.double(),
                                   att.double(), adj, mean)
    worst = 0.0
    parts = []
    for key, g, w, r in zip(("d_xl", "d_xr", "d_att", "d_bias"), bwd, want,
                            ref):
        e = float((g - w).abs().max())
        k64 = float((g.double() - r).abs().max())
        p64 = float((w.double() - r).abs().max())
        scale = float(w.abs().max())
        worst = max(worst, e)
        parts.append(f"{key} {e:.2e} (f64 {k64:.2e}/{p64:.2e}, max "
                     f"{scale:.3g})")
        check(g.shape == w.shape, f"backward {key} is {tuple(g.shape)}")
        check(e <= BWD_SCALE * scale + BWD_ATOL or
              (sums_to_f64 and key in ("d_att", "d_bias")),
              f"backward {key} != plain at {what}: max abs err {e}, largest "
              f"entry {scale}")
        check(k64 <= F64_RATIO * max(p64, F64_FLOOR),
              f"backward {key} is {k64} from float64 at {what}, the plain "
              f"version {p64}")
    empty = ~adj.any(dim=-1)
    check(bool((bwd[1][empty] == 0).all()),
          f"d_xr of rows without a neighbour is not 0 at {what}")
    return worst, ("backward max abs err (vs f64 kernel/plain): "
                   + "; ".join(parts) + "; relaunch bit-identical")


def grad_input(b, n, f, seed, torch, device):
    """A seeded grad_out for the attention stage's output."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(b, n, f)).astype(
        np.float32)).to(device)


def flop_rate(t) -> float:
    """The card's peak operation rate for inputs of ``t``'s dtype."""
    import torch

    return BF16_FLOP_PER_S if t.dtype == torch.bfloat16 else F32_FLOP_PER_S


def gat_bound(args):
    """Least time for the attention stage on these inputs: every input
    read once and the output written once (in the inputs' dtype) over the
    HBM rate, against the operations this adjacency needs over the peak
    rate for the features' dtype."""
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
    t_ops = ops / flop_rate(xl) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gat_backward_bound(args, grad):
    """Least time for the attention stage's gradient on these inputs:
    grad_out, xl, xr, att and adj read once and d_xl, d_xr (in the
    features' dtype), d_att, d_bias (f32) written once over the HBM rate,
    against the operations the closed form needs on this adjacency over
    the peak rate for the features' dtype."""
    xl, xr, att, _, adj = args
    f = xl.shape[-1]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (grad, xl, xr, att, adj)) \
        + 2 * xl.numel() * xl.element_size() + 2 * f * att.element_size()
    edges = int(adj.sum())
    rows = int(adj.any(dim=-1).sum())
    # per edge: the logit again (4F), exp and normalise (3), dalpha (2F),
    # dl (4), d_att's multiply-add (2F), LeakyReLU' and dl x att (2F), the
    # d_xr add (F), d_xl's alpha x g multiply-add and add (3F); per row:
    # g / d_i, the empty-row select and the d_bias add (3F)
    ops = edges * (14 * f + 7) + rows * 3 * f
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flop_rate(xl) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def dense_vjp(args, grad, mean, torch):
    """The dense VJP that the backward kernel replaces (as the JAX
    package's ``_gatv2_pallas_bwd`` takes it): ``attention_plain``
    recomputed under autograd and differentiated."""
    from gsc_tpu_torch.ops.gat_attention import attention_plain

    xl, xr, att, bias, adj = args
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (xl, xr, att, bias)]
        return torch.autograd.grad(attention_plain(*ins, adj, mean), ins,
                                   grad)


def alternating_pairs(parent_fn, fn, kernel, torch, pairs=PARENT_PAIRS):
    """Device time per launch (profiler) of ``parent_fn`` and ``fn`` in
    ``pairs`` pairs, each pair's order alternating; returns (parent
    median, median, pairs won by ``fn``, pairs measured), a pair being
    dropped when the profiler records no device time on a side."""
    import statistics

    won = measured = 0
    times = ([], [])
    for p in range(pairs):
        sides = [0, 1] if p % 2 == 0 else [1, 0]
        pair = [None, None]
        for side in sides:
            call = parent_fn if side == 0 else fn
            pair[side] = profile_device_ms(call, torch, reps=30,
                                           kernel=kernel)
        if None in pair:
            continue
        measured += 1
        won += pair[1] < pair[0]
        times[0].append(pair[0])
        times[1].append(pair[1])
    if not measured:
        return None
    return (statistics.median(times[0]), statistics.median(times[1]), won,
            measured)


def parent_gat():
    """The parent commit's attention kernels with their own wrappers
    (loaded beside the package's modules, so that the time per call
    compares wrapper and all): (forward, backward f32, backward bf16,
    backward with stage clocks), the backward's None unless
    ``_parent/gat_attention_backward.cu`` is there; None unless both
    ``_parent/gat_attention.cu`` and ``_parent/gat_attention.py`` are there
    (the headers they include, ``_parent/*.cuh``, beside them)."""
    if not (PARENT_GAT_SOURCE.exists() and PARENT_GAT_WRAPPER.exists()):
        return None
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "gsc_tpu_torch.ops._parent_gat_attention", PARENT_GAT_WRAPPER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fwd = mod.GatAttention(source=PARENT_GAT_SOURCE)
    if not PARENT_GAT_BACKWARD_SOURCE.exists():
        return fwd, None, None, None
    src = PARENT_GAT_BACKWARD_SOURCE
    return (fwd, mod.GatAttentionBackward(source=src),
            mod.GatAttentionBackward(source=src, dtype=torch.bfloat16),
            mod.GatAttentionBackward(source=src, stage_clocks=True))


def backward_spans(source, n):
    """The stage-clock spans (name, first slot, last slot) of a backward
    kernel source at graphs of n nodes: this design's, or the first
    design's (the one whose d_xl walked every row through distributed
    shared memory, ``column_sums``), whose slot 7 fell inside its
    recomputed forward."""
    if "column_sums" in Path(source).read_text():
        return [("staging", 0, 1), ("pair logits", 1, 7), ("softmax", 7, 2),
                ("g / d_i and d_bias terms", 2, 3), ("dalpha, dl", 3, 4),
                ("d_xr, d_xl, d_att terms", 4, 5),
                ("partials out, count-in, stores", 5, 6)]
    if n <= 32:
        return [("staging", 0, 1),
                ("pair logits and dots, softmax, dl (a warp per row)", 1, 3),
                ("triples", 3, 4), ("partial sums and stores beside the "
                                    "graph's sums", 4, 5),
                ("count-in", 5, 6)]
    return [("staging", 0, 1), ("pair logits and dots", 1, 2),
            ("softmax, dl", 2, 3), ("triples", 3, 4),
            ("CTA sums, cluster barrier", 4, 5),
            ("count-in, column exchange, stores", 5, 6)]


def attention_phase(torch, dev, smi, parent):
    """Phase 3: the forward and backward attention kernels against their
    plain versions at every shape and aggregation, timed at mean
    aggregation; the parent's kernels in turns where ``parent`` (forward,
    backward or None) is built.  Returns the forward's timings by shape
    and largest error, and the backward's."""
    from gsc_tpu_torch.ops.gat_attention import (attention_backward_plain,
                                                 attention_plain,
                                                 gat_attention,
                                                 gat_attention_backward)

    fmt = lambda v: "not measured" if v is None else f"{v:.5f} ms"
    parent, parent_bwd = parent[:2] if parent is not None else (None, None)
    max_err = bwd_err = 0.0
    timings, bwd_timings = {}, {}
    print(f"attention kernels vs plain (forward rtol {KERNEL_RTOL}, atol "
          f"{KERNEL_ATOL}; backward {BWD_SCALE} of each tensor's largest "
          f"entry + {BWD_ATOL}) on {smi}:")
    for b, n, f in SHAPES:
        for mean in (True, False):
            args = gat_inputs(b, n, f, seed=b * 1000 + n, torch=torch,
                              device=dev)
            xl, xr, att, _, adj = args
            grad = grad_input(b, n, f, seed=b * 1000 + n + 1, torch=torch,
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
            print(f"  B={b:3d} N={n:2d} F={f} {aggr:4s}: forward max abs err "
                  f"{err:.2e} rel {rel:.2e}, max |out| "
                  f"{float(want.abs().max()):.2f} (vs f64: kernel "
                  f"{k64:.2e}, plain {p64:.2e})", flush=True)
            check(torch.allclose(got, want, rtol=KERNEL_RTOL,
                                 atol=KERNEL_ATOL),
                  f"kernel != plain at {(b, n, f)} {aggr}: "
                  f"max abs err {err}")
            check(k64 <= F64_RATIO * max(p64, F64_FLOOR),
                  f"kernel is {k64} from float64 at {(b, n, f)} {aggr}, "
                  f"the plain version {p64}")
            empty = ~adj.any(dim=-1)
            check(bool(empty.any()) and bool((got[empty] == 0).all()),
                  f"rows without a neighbour are not exactly 0 at {(b, n, f)}")
            e, line = check_backward(args, grad, mean, f"{(b, n, f)} {aggr}",
                                     torch)
            bwd_err = max(bwd_err, e)
            print(f"    {line}", flush=True)
            if not mean:
                continue
            fwd = lambda op=gat_attention: op.launch(*args, True)
            dev_of = lambda op: profile_device_ms(
                lambda: fwd(op), torch, kernel="gat_attention_kernel")
            if parent is not None:
                check(torch.allclose(fwd(parent), got, rtol=KERNEL_RTOL,
                                     atol=KERNEL_ATOL),
                      f"the parent kernel differs at {(b, n, f)}")
                order = (parent, gat_attention, gat_attention, parent)
                turns_ms = [cuda_time_ms(lambda: fwd(op), torch)
                            for op in order]
                turns_dev = [dev_of(op) for op in order]
                ms, dev_ms = turns_ms[1], turns_dev[1]
            else:
                ms, dev_ms = cuda_time_ms(fwd, torch), dev_of(gat_attention)
            plain_ms = cuda_time_ms(lambda: attention_plain(*args, True),
                                    torch, reps=50)
            plain_dev_ms = profile_device_ms(
                lambda: attention_plain(*args, True), torch)
            bound_ms, bound_by = gat_bound(args)
            timings[(b, n, f)] = (ms, plain_ms, bound_ms, bound_by)
            print(f"    forward per call (events, wrapper) {ms:.4f} ms, "
                  f"device time (profiler) {fmt(dev_ms)}; plain {plain_ms:.4f}"
                  f" ms per call, {fmt(plain_dev_ms)} device; bound "
                  f"{bound_ms:.6f} ms ({bound_by})", flush=True)
            if parent is not None:
                print(f"    parent forward kernel vs this one in turns "
                      f"(parent, kernel, kernel, parent): device time "
                      f"{', '.join(fmt(t) for t in turns_dev)}; per call "
                      f"{', '.join(f'{t:.5f} ms' for t in turns_ms)}",
                      flush=True)
            bwd_call = lambda: gat_attention_backward.launch(
                grad, xl, xr, att, adj, True)
            vjp = lambda: dense_vjp(args, grad, True, torch)
            turns = [cuda_time_ms(fn, torch, reps=50, warmup=5)
                     for fn in (vjp, bwd_call, bwd_call, vjp)]
            b_ms = cuda_time_ms(bwd_call, torch)
            b_dev = profile_device_ms(bwd_call, torch,
                                      kernel="gat_attention_backward")
            b_plain = cuda_time_ms(
                lambda: attention_backward_plain(grad, xl, xr, att, adj,
                                                 True), torch, reps=50)
            b_bound, b_by = gat_backward_bound(args, grad)
            bwd_timings[(b, n, f)] = (b_ms, b_plain, b_bound, b_by)
            if parent is not None and (b, n, f) == MAIN_SHAPE:
                for what, pfn, fn, kern in (
                        ("forward", lambda: fwd(parent), fwd,
                         "gat_attention_kernel"),
                        ("backward", lambda: parent_bwd.launch(
                            grad, xl, xr, att, adj, True), bwd_call,
                         "gat_attention_backward")):
                    if what == "backward" and parent_bwd is None:
                        continue
                    res = alternating_pairs(pfn, fn, kern, torch)
                    if res is not None:
                        print(f"    parent vs this {what} kernel in "
                              f"{res[3]} alternating pairs: device time "
                              f"median {res[0]:.5f} ms (parent), "
                              f"{res[1]:.5f} ms (this), ratio "
                              f"{res[1] / res[0]:.4f}; this one faster in "
                              f"{res[2]} of {res[3]}", flush=True)
            if parent_bwd is not None:
                p_call = lambda: parent_bwd.launch(grad, xl, xr, att, adj,
                                                   True)
                for x, y in zip(p_call(), bwd_call()):
                    check(torch.allclose(x, y, rtol=BWD_SCALE,
                                         atol=BWD_ATOL),
                          f"the parent backward kernel differs at "
                          f"{(b, n, f)}")
                order = (p_call, bwd_call, bwd_call, p_call)
                p_turns = [cuda_time_ms(fn, torch) for fn in order]
                p_dev = [profile_device_ms(
                    fn, torch, kernel="gat_attention_backward")
                    for fn in order]
                print(f"    parent backward kernel vs this one in turns "
                      f"(parent, kernel, kernel, parent): device time "
                      f"{', '.join(fmt(t) for t in p_dev)}; per call "
                      f"{', '.join(f'{t:.5f} ms' for t in p_turns)}",
                      flush=True)
            print(f"    backward per call (events, wrapper) {b_ms:.4f} ms, "
                  f"device time (profiler) {fmt(b_dev)}; plain "
                  f"{b_plain:.4f} ms per call; bound {b_bound:.6f} ms "
                  f"({b_by}); dense VJP vs backward kernel per call in turns "
                  f"(VJP, kernel, kernel, VJP): "
                  f"{', '.join(f'{t:.5f} ms' for t in turns)}", flush=True)
    # a softmax saturated as trained weights make it (where the textbook
    # dl = alpha (dalpha - sum alpha dalpha) cancels to its rounding)
    b, n, f = MAIN_SHAPE
    for mean in (True, False):
        aggr = "mean" if mean else "sum"
        args = saturated_inputs(b, n, f, seed=b * 1000 + n, torch=torch,
                                device=dev)
        grad = 0.2 * grad_input(b, n, f, seed=b * 1000 + n + 1, torch=torch,
                                device=dev)
        got = gat_attention.launch(*args, mean)
        want = attention_plain(*args, mean)
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
              f"kernel != plain at saturated {(b, n, f)} {aggr}: max abs "
              f"err {err}")
        e, line = check_backward(args, grad, mean,
                                 f"saturated {(b, n, f)} {aggr}", torch)
        max_err, bwd_err = max(max_err, err), max(bwd_err, e)
        print(f"  B={b:3d} N={n:2d} F={f} {aggr:4s} saturated softmax: "
              f"forward max abs err {err:.2e}; {line}", flush=True)
    return timings, max_err, bwd_timings, bwd_err


def bf16_ulp(t) -> float:
    """One bf16 ulp at the largest magnitude of ``t``."""
    import math

    m = float(t.float().abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 2.0 ** -133


def to_bf16(args):
    """Attention inputs with xl and xr rounded to bf16 (att, bias f32)."""
    import torch

    xl, xr, att, bias, adj = args
    return [xl.to(torch.bfloat16), xr.to(torch.bfloat16), att, bias, adj]


def check_backward_bf16(args, grad, mean, what, torch, sums_to_f64=False):
    """The bf16 backward kernel against its plain version on one input:
    d_xl, d_xr within one bf16 ulp of the tensor's largest entry and no
    further from float64 than twice the plain version (floored at a
    quarter ulp); d_att, d_bias as the f32 kernel's (``sums_to_f64`` as
    there); d_xr 0 on rows without a neighbour; two launches bit for bit
    the same."""
    from gsc_tpu_torch.ops.gat_attention import (attention_backward_plain,
                                                 attention_backward_wide,
                                                 gat_attention_backward_bf16)

    xl, xr, att, _, adj = args
    op = gat_attention_backward_bf16
    bwd = op.launch(grad, xl, xr, att, adj, mean)
    again = op.launch(grad, xl, xr, att, adj, mean)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(bwd, again)),
          f"two bf16 backward launches differ at {what}")
    want = attention_backward_plain(grad, xl, xr, att, adj, mean)
    ref = attention_backward_wide(grad, xl, xr, att, adj, mean,
                                  torch.float64)
    worst, parts = 0.0, []
    for k, (key, g, w, r) in enumerate(zip(
            ("d_xl", "d_xr", "d_att", "d_bias"), bwd, want, ref)):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"bf16 backward {key} is {g.dtype} {tuple(g.shape)} at {what}")
        e = float((g.float() - w.float()).abs().max())
        k64 = float((g.double() - r).abs().max())
        p64 = float((w.double() - r).abs().max())
        scale = float(w.float().abs().max())
        worst = max(worst, e)
        if k < 2:
            ulp = bf16_ulp(w)
            differ = int((g != w).sum())
            parts.append(f"{key} {e:.2e} (1 ulp {ulp:.2e}, {differ} of "
                         f"{g.numel()} differ; f64 {k64:.2e}/{p64:.2e})")
            check(e <= ulp + BWD_ATOL, f"bf16 backward {key} != plain at "
                  f"{what}: max abs err {e}, one ulp {ulp}")
            check(k64 <= 2.0 * max(p64, ulp / 4, F64_FLOOR),
                  f"bf16 backward {key} is {k64} from float64 at {what}, "
                  f"the plain version {p64}")
        else:
            parts.append(f"{key} {e:.2e} (f64 {k64:.2e}/{p64:.2e}, max "
                         f"{scale:.3g})")
            check(e <= BWD_SCALE * scale + BWD_ATOL or sums_to_f64,
                  f"bf16 backward {key} != plain at {what}: max abs err "
                  f"{e}, largest entry {scale}")
            check(k64 <= F64_RATIO * max(p64, F64_FLOOR),
                  f"bf16 backward {key} is {k64} from float64 at {what}, "
                  f"the plain version {p64}")
    empty = ~adj.any(dim=-1)
    check(bool((bwd[1][empty] == 0).all()),
          f"bf16 d_xr of rows without a neighbour is not 0 at {what}")
    return worst, ("bf16 backward max abs err (vs f64 kernel/plain): "
                   + "; ".join(parts) + "; relaunch bit-identical")


def attention_phase_bf16(torch, dev, smi, parent_bwd=None):
    """Phase 9: the bf16 attention kernels against their plain versions at
    phase 3's shapes and aggregations and the saturated learn-burst
    inputs; at mean aggregation their times in turns with the f32
    kernels', and the bf16 backward's in turns with the parent's where
    ``parent_bwd`` (the parent commit's bf16 backward) is built, in
    PARENT_PAIRS alternating pairs at MAIN_SHAPE.  Returns the forward's
    timings by shape and largest error, and the backward's."""
    from gsc_tpu_torch.ops.gat import attention_bf16
    from gsc_tpu_torch.ops.gat_attention import (attention_backward_plain,
                                                 attention_plain,
                                                 gat_attention,
                                                 gat_attention_backward,
                                                 gat_attention_backward_bf16,
                                                 gat_attention_bf16)

    fmt = lambda v: "not measured" if v is None else f"{v:.5f} ms"
    max_err = bwd_err = 0.0
    timings, bwd_timings = {}, {}
    print(f"bf16 attention kernels vs plain (bf16 outputs within one bf16 "
          f"ulp of each tensor's largest entry; d_att, d_bias {BWD_SCALE} "
          f"of the largest entry + {BWD_ATOL}) on {smi}:", flush=True)
    cases = [(b, n, f, False) for b, n, f in SHAPES] + [(*MAIN_SHAPE, True)]
    for b, n, f, saturated in cases:
        for mean in (True, False):
            seed = b * 1000 + n
            if saturated:
                args32 = saturated_inputs(b, n, f, seed=seed, torch=torch,
                                          device=dev)
                grad32 = 0.2 * grad_input(b, n, f, seed=seed + 1,
                                          torch=torch, device=dev)
            else:
                args32 = gat_inputs(b, n, f, seed=seed, torch=torch,
                                    device=dev)
                grad32 = grad_input(b, n, f, seed=seed + 1, torch=torch,
                                    device=dev)
            args = to_bf16(args32)
            grad = grad32.to(torch.bfloat16)
            xl, xr, att, _, adj = args
            aggr = ("mean" if mean else "sum") + (" saturated"
                                                  if saturated else "")
            what = f"{(b, n, f)} {aggr}"
            got = gat_attention_bf16.launch(*args, mean)
            torch.cuda.synchronize()
            want = attention_plain(*args, mean)
            check(got.dtype == want.dtype == torch.bfloat16,
                  f"bf16 forward returned {got.dtype} at {what}")
            ulp = bf16_ulp(want)
            err = float((got.float() - want.float()).abs().max())
            ref = attention_bf16(*args, mean, wide=torch.float64)
            k64 = float((got.double() - ref).abs().max())
            p64 = float((want.double() - ref).abs().max())
            differ = int((got != want).sum())
            max_err = max(max_err, err)
            print(f"  B={b:3d} N={n:2d} F={f} {aggr}: bf16 forward max abs "
                  f"err {err:.2e} (1 ulp {ulp:.2e}; {differ} of "
                  f"{got.numel()} entries differ), max |out| "
                  f"{float(want.float().abs().max()):.2f} (vs f64: kernel "
                  f"{k64:.2e}, plain {p64:.2e})", flush=True)
            check(err <= ulp, f"bf16 kernel != plain at {what}: max abs err "
                  f"{err}, one ulp {ulp}")
            check(k64 <= 2.0 * max(p64, ulp / 4),
                  f"bf16 kernel is {k64} from float64 at {what}, the plain "
                  f"version {p64}")
            empty = ~adj.any(dim=-1)
            check(bool(empty.any()) and bool((got[empty] == 0).all()),
                  f"bf16 rows without a neighbour are not exactly 0 at {what}")
            e, line = check_backward_bf16(args, grad, mean, what, torch)
            bwd_err = max(bwd_err, e)
            print(f"    {line}", flush=True)
            if not mean or saturated:
                continue
            f32 = lambda: gat_attention.launch(*args32, True)
            h16 = lambda: gat_attention_bf16.launch(*args, True)
            turns = [cuda_time_ms(fn, torch) for fn in (f32, h16, h16, f32)]
            dev_turns = [profile_device_ms(fn, torch,
                                           kernel="gat_attention_kernel")
                         for fn in (f32, h16, h16, f32)]
            plain_ms = cuda_time_ms(lambda: attention_plain(*args, True),
                                    torch, reps=50)
            bound_ms, bound_by = gat_bound(args)
            ms = turns[1]
            timings[(b, n, f)] = (ms, plain_ms, bound_ms, bound_by)
            print(f"    bf16 forward per call (events, wrapper) in turns "
                  f"with f32 (f32, bf16, bf16, f32): "
                  f"{', '.join(f'{t:.5f} ms' for t in turns)}; device time "
                  f"(profiler) {', '.join(fmt(t) for t in dev_turns)}; "
                  f"plain bf16 {plain_ms:.4f} ms per call; bound "
                  f"{bound_ms:.6f} ms ({bound_by})", flush=True)
            g32 = lambda: gat_attention_backward.launch(
                grad32, args32[0], args32[1], att, adj, True)
            g16 = lambda: gat_attention_backward_bf16.launch(
                grad, xl, xr, att, adj, True)
            b_turns = [cuda_time_ms(fn, torch) for fn in (g32, g16, g16, g32)]
            b_dev = [profile_device_ms(fn, torch,
                                       kernel="gat_attention_backward")
                     for fn in (g32, g16, g16, g32)]
            b_plain = cuda_time_ms(
                lambda: attention_backward_plain(grad, xl, xr, att, adj,
                                                 True), torch, reps=50)
            b_bound, b_by = gat_backward_bound(args, grad)
            bwd_timings[(b, n, f)] = (b_turns[1], b_plain, b_bound, b_by)
            print(f"    bf16 backward per call in turns with f32 (f32, "
                  f"bf16, bf16, f32): "
                  f"{', '.join(f'{t:.5f} ms' for t in b_turns)}; device "
                  f"time {', '.join(fmt(t) for t in b_dev)}; plain bf16 "
                  f"{b_plain:.4f} ms per call; bound {b_bound:.6f} ms "
                  f"({b_by})", flush=True)
            if parent_bwd is None:
                continue
            p16 = lambda: parent_bwd.launch(grad, xl, xr, att, adj, True)
            order = (p16, g16, g16, p16)
            p_turns = [cuda_time_ms(fn, torch) for fn in order]
            p_dev = [profile_device_ms(fn, torch,
                                       kernel="gat_attention_backward")
                     for fn in order]
            print(f"    parent bf16 backward kernel vs this one in turns "
                  f"(parent, kernel, kernel, parent): device time "
                  f"{', '.join(fmt(t) for t in p_dev)}; per call "
                  f"{', '.join(f'{t:.5f} ms' for t in p_turns)}",
                  flush=True)
            if (b, n, f) == MAIN_SHAPE:
                res = alternating_pairs(p16, g16, "gat_attention_backward",
                                        torch)
                if res is not None:
                    print(f"    parent vs this bf16 backward kernel in "
                          f"{res[3]} alternating pairs: device time median "
                          f"{res[0]:.5f} ms (parent), {res[1]:.5f} ms "
                          f"(this), ratio {res[1] / res[0]:.4f}; this one "
                          f"faster in {res[2]} of {res[3]}", flush=True)
    return timings, max_err, bwd_timings, bwd_err


def attention_stage_clocks(fwd, bwd, torch, dev, parent_bwd=None):
    """Where one attention launch's time goes, mean aggregation: the
    stage-clocks builds' block-0 cycles per stage, median over 30
    launches, each build's results bit-equal to the kernel's; the forward
    at MAIN_SHAPE, the backward in both forms (this build's and, where
    ``parent_bwd`` is built, the parent's) at the learn bursts' shapes,
    MAIN_SHAPE and BURST_LARGE_SHAPES."""
    import statistics

    from gsc_tpu_torch.ops.gat_attention import (gat_attention,
                                                 gat_attention_backward,
                                                 gat_attention_backward_bf16)

    def bf16_of(op):
        # the same stage-clocks library, launched on bf16 features
        return type(op)(source=op.source, stage_clocks=True,
                        dtype=torch.bfloat16)

    common = [("staging", 0, 1), ("pair logits", 1, 7), ("softmax", 7, 2)]
    for b, n, f in [MAIN_SHAPE] + BURST_LARGE_SHAPES:
        args = gat_inputs(b, n, f, seed=b * 1000 + n, torch=torch, device=dev)
        grad = grad_input(b, n, f, seed=b * 1000 + n + 1, torch=torch,
                          device=dev)
        xl, xr, att, _, adj = args
        bwd_run = lambda op: list(op.launch(grad, xl, xr, att, adj, True))
        h_ins = (grad.to(torch.bfloat16), xl.to(torch.bfloat16),
                 xr.to(torch.bfloat16), att, adj, True)
        h_run = lambda op: list(op.launch(*h_ins))
        runs = [("backward", bwd, bwd_run, gat_attention_backward,
                 backward_spans(bwd.source, n)),
                ("bf16 backward", bf16_of(bwd), h_run,
                 gat_attention_backward_bf16, backward_spans(bwd.source, n))]
        if parent_bwd is not None:
            runs += [("parent backward", parent_bwd, bwd_run, None,
                      backward_spans(parent_bwd.source, n)),
                     ("parent bf16 backward", bf16_of(parent_bwd), h_run,
                      None, backward_spans(parent_bwd.source, n))]
        if (b, n, f) == MAIN_SHAPE:
            runs.insert(0, ("forward", fwd,
                            lambda op: [op.launch(*args, True)],
                            gat_attention, common + [("aggregation", 2, 3)]))
        for what, op, run, kernel, spans in runs:
            if kernel is not None:
                check(all(torch.equal(x, y)
                          for x, y in zip(run(op), run(kernel))),
                      f"the stage-clocks {what} build's results differ")
            last = spans[-1][2]
            rows = []
            for _ in range(30):
                run(op)
                c = op.read_stage_clocks()
                rows.append([c[e] - c[s] for _, s, e in spans]
                            + [c[last] - c[0]])
            med = [statistics.median(r[k] for r in rows)
                   for k in range(len(spans) + 1)]
            print(f"  {what} stage clocks at {(b, n, f)} (block 0, median "
                  f"of 30 launches): {med[-1]:.0f} cycles; " + ", ".join(
                      f"{name} {m:.0f} ({100.0 * m / med[-1]:.1f}%)"
                      for (name, _, _), m in zip(spans, med)), flush=True)


def ambiguous_rows(pre, thr=0.1, n_dst=24, tol=THRESH_TOL):
    """Destination rows where a value before either threshold pass lies
    within ``tol`` of the threshold."""
    import numpy as np

    rows = np.clip(pre, 0.0, 1.0).reshape(pre.shape[:-1] + (-1, n_dst))
    amb = np.zeros(rows.shape[:-1], bool)
    for _ in range(2):
        amb |= (np.abs(rows - thr) < tol).any(-1)
        kept = np.where(rows >= thr, rows, 0.0)
        total = kept.sum(-1, keepdims=True)
        rows = np.where(total > 0, kept / np.maximum(total, 1e-30),
                        1.0 / n_dst)
    return amb


def compare_answers(got, want, pre, what, rtol=ANSWER_RTOL,
                    atol=ANSWER_ATOL, thresh_tol=THRESH_TOL, n_dst=24):
    """Exact zero pattern and close values outside ambiguous rows (rows of
    ``n_dst`` destinations)."""
    import numpy as np

    amb = ambiguous_rows(pre, n_dst=n_dst, tol=thresh_tol)
    g = got.reshape(-1, n_dst)[~amb.reshape(-1)]
    w = want.reshape(-1, n_dst)[~amb.reshape(-1)]
    check(np.array_equal(g == 0, w == 0),
          f"{what}: thresholded entries differ outside ambiguous rows")
    err = float(np.max(np.abs(g - w))) if g.size else 0.0
    check(np.allclose(g, w, rtol=rtol, atol=atol),
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
    """Every answer of one burst: finite, [action dim] (1728 at the
    flagship), rows summing to 1, equal to an unbatched call and to the
    plain actor.  Returns the largest difference and the count of
    ambiguous rows."""
    import numpy as np

    from gsc_tpu_torch.env.observations import GraphObs

    ddpg = report.ddpg
    n_dst = ddpg.env.limits.max_nodes
    worst = 0.0
    ambiguous = 0
    for k, ans in report.answers:
        check(ans.shape == (ddpg.action_dim,) and
              bool(np.isfinite(ans).all()),
              f"answer for pool obs {k} is {ans.shape} or not finite")
        check(np.allclose(ans.reshape(-1, n_dst).sum(-1), 1.0, rtol=1e-5),
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
                                 f"kernel vs plain actor, obs {k}",
                                 n_dst=n_dst)
        worst = max(worst, e1)
        ambiguous += a1
        for kk, ans in report.answers:
            if kk == k:
                e2, _ = compare_answers(ans, single, pre,
                                        f"batched vs unbatched, obs {k}",
                                        n_dst=n_dst)
                worst = max(worst, e2)
    return worst, ambiguous


def parent_megakernel():
    """The parent commit's megakernel, bound through its own C interface
    (the same argument struct without the fields added since), or None
    when its source is absent."""
    if not PARENT_SOURCE.exists():
        return None
    import ctypes

    from gsc_tpu_torch.ops import substep
    from gsc_tpu_torch.ops.build import build_library

    class ParentMegakernel(substep.SubstepMegakernel):
        def library(self):
            with self._lock:
                if self._lib is None:
                    lib, self.build_log = build_library(PARENT_SOURCE,
                                                        substep.EXTRA_FLAGS)
                    lib.substep_megakernel.argtypes = [
                        ctypes.POINTER(substep.SubstepArgs), ctypes.c_void_p]
                    lib.substep_megakernel.restype = ctypes.c_int
                    self._lib = lib
                return self._lib

        def launch(self, engine, state, topo, traffic, cap_now, noise=None,
                   substeps=None):
            import torch

            dev = state.t.device
            args, new = self._prepare(
                engine, state, topo, traffic, cap_now, noise, substeps,
                torch.zeros(1, dtype=torch.int64, device=dev), None)
            code = self.library().substep_megakernel(
                ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
            check(code == 0, f"parent megakernel launch failed ({code})")
            self.launches += 1
            return new

    return ParentMegakernel()


def megakernel_smem_bytes(op, max_flows, limits=None):
    """The megakernel's shared memory per CTA with ``max_flows`` slots on
    the tables of ``limits`` (default: Abilene's, N=24, E=37, P=3), from
    its own layout function."""
    import ctypes

    from gsc_tpu_torch.config.catalog import abc_service
    from gsc_tpu_torch.config.schema import EnvLimits
    from gsc_tpu_torch.ops.substep import SubstepArgs

    lim = limits or EnvLimits.for_service(abc_service())
    args = SubstepArgs(M=max_flows, N=lim.max_nodes, C=lim.num_sfcs,
                       S=lim.max_sfs, P=lim.sf_pool, E=lim.max_edges)
    return op.library().substep_smem_bytes(ctypes.byref(args))


def build_kernels(ops):
    """Build every kernel library at once (one nvcc each, started
    together); returns the seconds each took."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(op):
        t0 = time.perf_counter()
        op.library()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(ops)) as ex:
        futs = {name: ex.submit(timed, op) for name, op in ops.items()}
        return {name: f.result() for name, f in futs.items()}


def single_substep_check(case, start, torch, dev):
    """One substep (``substeps=1``) from the start of an interval: the
    kernel against the plain substep on the card and on the CPU."""
    from gsc_tpu_torch.ops.substep import substep_megakernel, substep_plain
    from gsc_tpu_torch.sim import cases

    eng = case.engine
    b = case.batch
    z = case.noise(0)

    def inputs(where):
        st = start.to(where)
        traffic = case.traffic.to(where)
        st, cap = eng.begin_interval(st, traffic, case.schedule.to(where),
                                     case.placement.to(where))
        noise = None if z is None else z[:, :1].to(where)
        return st, case.topo.to(where).expand(b), traffic, cap, noise

    got = substep_megakernel.launch(eng, *inputs(dev), substeps=1)
    worst = 0.0
    for where in (dev, torch.device("cpu")):
        want = substep_plain(eng, *inputs(where), substeps=1)
        worst = max(worst, cases.compare_states(
            got, want, SUB_RTOL, SUB_ATOL,
            f"{case.name} single substep vs plain on {where.type}: "))
    return worst


def substep_battery(torch, dev):
    """Phase 5: the megakernel against its plain version on every case;
    returns the largest float difference."""
    from gsc_tpu_torch.sim import cases

    from gsc_tpu_torch.ops.substep import substep_megakernel

    worst = 0.0
    for case in cases.all_cases(abilene_batch=64):
        t0 = time.perf_counter()
        substep_megakernel.serial_rounds = 0
        got = cases.run_case(case, dev)
        torch.cuda.synchronize()
        serial = substep_megakernel.serial_rounds
        if case.name == WIDE_CASE:
            check(serial > 0, f"{case.name}: no admission round took the "
                  "sequential scan")
        else:
            check(serial == 0, f"{case.name}: {serial} admission rounds "
                  "took the sequential scan")
        on_card = cases.run_case(case, dev, plain=True)
        on_cpu = cases.run_case(case, "cpu", plain=True)
        e_card = e_cpu = e_plain = 0.0
        for i in range(case.intervals):
            what = f"{case.name} interval {i}"
            e_card = max(e_card, cases.compare_states(
                got[i], on_card[i], SUB_RTOL, SUB_ATOL,
                f"{what}, kernel vs plain on card: "))
            e_cpu = max(e_cpu, cases.compare_states(
                got[i], on_cpu[i], SUB_RTOL, SUB_ATOL,
                f"{what}, kernel vs plain on CPU: "))
            e_plain = max(e_plain, cases.compare_states(
                on_card[i], on_cpu[i], SUB_RTOL, SUB_ATOL,
                f"{what}, plain on card vs CPU: "))
            check(cases.bit_equal(got[i].to("cpu"), on_cpu[i]),
                  f"{what}: the kernel is not bit-equal to the plain "
                  "version on CPU copies")
        again = cases.run_case(case, dev)
        check(all(cases.bit_equal(a, g) for a, g in zip(again, got)),
              f"{case.name}: two launches on the same inputs differ")
        start = got[-2] if case.intervals > 1 else case.engine.init(
            case.batch, dev)
        e_one = single_substep_check(case, start, torch, dev)
        m = got[-1].metrics
        worst = max(worst, e_card, e_cpu, e_one)
        print(f"  {case.name:18s} M={case.engine.M:4d} B={case.batch:3d} "
              f"x{case.intervals} intervals: max float diff "
              f"kernel-plain(card) {e_card:.2e}, kernel-plain(CPU) "
              f"{e_cpu:.2e} (bit-equal), plain card-CPU {e_plain:.2e}, "
              f"single substep {e_one:.2e}; serial rounds {serial}; "
              f"bit-identical relaunch; generated "
              f"{int(m.generated.sum())}, dropped {int(m.dropped.sum())} "
              f"reasons {m.drop_reasons.sum(0).tolist()} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return worst


def substep_bound(engine, before, after, batch):
    """Least time for one interval of ``batch`` replicas, from the bytes it
    must touch: every state leaf read once and every leaf the substep
    writes written once, except the two release rings, of which only the
    rows the interval releases (one per substep from the interval's first)
    and the rows it adds holds into are read and written; the topology
    (shared by the replicas), the interval's capacities, the traffic
    records the interval admitted and one arrival time per substep (the
    next record's, to see that it is not due) read once.  Against a lower
    count of the slots' operations over the f32 rate."""
    import torch

    from gsc_tpu_torch.sim.cases import state_leaves

    read_only = ("sf_startup", "placed", "schedule")
    rings = ("rel_node", "rel_edge")
    nbytes = 0
    for name, t in state_leaves(before).items():
        if name == "run_idx" or name in rings:
            continue
        n = t.numel() * t.element_size()
        nbytes += n if name in read_only else 2 * n
    h, k = engine.H, engine.substeps
    g0 = torch.round(before.t / engine.dt).long() % h               # [B]
    rows = torch.arange(h, device=g0.device)
    released = (rows[None] - g0[:, None]) % h < k                    # [B, H]
    ring_rows = 0
    for name in rings:
        a, z = getattr(before, name), getattr(after, name)
        a = a.reshape(a.shape[0], h, -1)
        z = z.reshape(z.shape[0], h, -1)
        touched = int((released | (a != z).any(-1)).sum())
        ring_rows += touched
        nbytes += 2 * touched * a.shape[-1] * a.element_size()
    n_nn, e = engine.N * engine.N, engine.E
    nbytes += 3 * n_nn * 4 + 2 * e * 4 + batch * engine.N * 4
    admitted = int((after.cursor - before.cursor).sum())
    nbytes += admitted * 7 * 4 + k * batch * 4
    ops = OPS_PER_SLOT_SUBSTEP * engine.M * k * batch
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ring_rows


def substep_timings(torch, dev, smi, clocked, parent):
    """Phase 7: per-interval times at the SUB_TIMING_BATCHES; the parent
    kernel's device time in turns with this kernel's where ``parent`` is
    built; at SUB_MAIN_BATCH the attribution runs and the stage clocks of
    ``clocked``."""
    from gsc_tpu_torch.config.schema import replace
    from gsc_tpu_torch.ops.substep import (STAGES, substep_megakernel,
                                           substep_plain)
    from gsc_tpu_torch.sim import cases
    from gsc_tpu_torch.sim.engine import SimEngine

    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    out = {}
    for b in SUB_TIMING_BATCHES:
        case = cases.abilene_case(batch=b, intervals=2, seed=7)
        states = cases.run_case(case, dev)
        eng = case.engine
        topo = case.topo.to(dev).expand(b)
        traffic = case.traffic.to(dev)
        st, cap = eng.begin_interval(states[-1], traffic,
                                     case.schedule.to(dev),
                                     case.placement.to(dev))
        run = lambda op, e=eng: op.launch(e, st, topo, traffic, cap)
        device_ms = lambda op: profile_device_ms(
            lambda: run(op), torch, reps=10,
            kernel="substep_megakernel_kernel")
        after = run(substep_megakernel)
        ms = cuda_time_ms(lambda: run(substep_megakernel), torch, reps=20,
                          warmup=3)
        turns = []
        if parent is not None:
            check(cases.bit_equal(run(parent), after),
                  f"B={b}: the parent kernel's interval differs")
            turns.append(device_ms(parent))
        dev_ms = device_ms(substep_megakernel)
        if parent is not None:
            turns += [dev_ms, device_ms(substep_megakernel),
                      device_ms(parent)]
        plain_ms = cuda_time_ms(
            lambda: substep_plain(eng, st, topo, traffic, cap), torch,
            reps=2, warmup=1)
        bound_ms, bound_by, nbytes, ring_rows = substep_bound(eng, st,
                                                              after, b)
        out[b] = (ms, dev_ms, plain_ms, bound_ms, bound_by)
        print(f"  B={b:3d}: per interval (100 substeps) kernel {ms:.4f} ms "
              f"(events, wrapper included), device time {fmt(dev_ms)}; "
              f"plain engine {plain_ms:.2f} ms; bound {bound_ms:.6f} ms "
              f"({bound_by}: {nbytes} bytes, {ring_rows} ring rows of "
              f"{2 * b * eng.H}) on {smi}", flush=True)
        if turns:
            print(f"    parent kernel vs this kernel, device time in turns "
                  f"(parent, kernel, kernel, parent): "
                  f"{', '.join(fmt(t) for t in turns)}; the same interval "
                  "bit for bit", flush=True)
        if b == SUB_MAIN_BATCH:
            # where the interval's time goes: the same inputs with fewer
            # admission rounds and WRR rank levels (other results, the
            # same chain of stages otherwise)
            for kw in ({"admission_iters": 0}, {"admission_iters": 1},
                       {"wrr_rank_levels": 1}):
                var = SimEngine(eng.service, replace(eng.cfg, **kw),
                                eng.limits)
                t = profile_device_ms(lambda: run(substep_megakernel, var),
                                      torch, reps=10,
                                      kernel="substep_megakernel_kernel")
                print(f"    attribution at B={b}: {kw} device time "
                      f"{fmt(t)} per interval", flush=True)
            # the clocked build: thread 0's cycles between stage barriers
            check(cases.bit_equal(run(clocked), after),
                  "the clocked build's interval differs")
            clk_ms = device_ms(clocked)
            cyc = clocked.stage_clocks.double().mean(0)
            total = float(cyc.sum())
            k_n = eng.substeps
            print(f"    stage clocks at B={b} (clocked build, device time "
                  f"{fmt(clk_ms)} per interval; {total / k_n:.0f} cycles "
                  f"per substep, mean over replicas):", flush=True)
            for name, c in zip(STAGES, cyc.tolist()):
                print(f"      {name:16s} {c / k_n:9.0f} cycles/substep "
                      f"{100.0 * c / total:6.2f}%", flush=True)
    return out


class plain_attention:
    """While active, the networks' attention (``models.gnn.attention_op``)
    is the kernels' plain versions on any device: ``attention_plain``
    forward, ``attention_backward_plain`` as its gradient."""

    def __init__(self, torch):
        from gsc_tpu_torch.ops.gat_attention import (attention_backward_plain,
                                                     attention_plain)

        class PlainAttention(torch.autograd.Function):
            @staticmethod
            def forward(ctx, xl, xr, att, bias, adj, mean):
                ctx.save_for_backward(xl, xr, att, adj)
                ctx.mean = mean
                return attention_plain(xl, xr, att, bias, adj, mean)

            @staticmethod
            def backward(ctx, grad):
                xl, xr, att, adj = ctx.saved_tensors
                return (*attention_backward_plain(grad.contiguous(), xl, xr,
                                                  att, adj, ctx.mean),
                        None, None)

        self.op = lambda xl, xr, att, bias, adj, mean=True: \
            PlainAttention.apply(xl, xr, att, bias, adj, bool(mean))

    def __enter__(self):
        from gsc_tpu_torch.models import gnn

        self.saved = gnn.attention_op
        gnn.attention_op = lambda dtype: self.op
        return self

    def __exit__(self, *exc):
        from gsc_tpu_torch.models import gnn

        gnn.attention_op = self.saved


def train_slice(torch, dev, smi, precision="f32", checkpoint=None,
                args=None, label="", result_dir=True):
    """Phase 8 (f32) or 10 (bf16): two training episodes through the CLI
    under ``precision`` (saving a checkpoint to ``checkpoint`` when
    given), with every kernel count set to 0 before it; returns the
    launch counts of the path's kernels in that run and its rollout
    env-steps/s and learn-burst seconds.  ``args`` replaces
    ``TRAIN_ARGS`` (phase 14's networks), ``label`` names the run;
    without ``result_dir`` the run writes no rewards.csv and saves no
    checkpoint (phase 14's runs that nothing reads back)."""
    import math
    import tempfile
    from types import SimpleNamespace

    from gsc_tpu_torch import cli
    from gsc_tpu_torch.models.nets import Actor, QNetwork
    from gsc_tpu_torch.ops.gat_attention import (gat_attention,
                                                 gat_attention_backward,
                                                 gat_attention_backward_bf16,
                                                 gat_attention_bf16)
    from gsc_tpu_torch.ops.substep import substep_megakernel
    from gsc_tpu_torch.parallel.dp import ParallelDDPG
    from gsc_tpu_torch.utils.checkpoint import (read_checkpoint_meta,
                                                verify_checkpoint)

    bf16 = precision == "bf16"
    sfx = "_bf16" if bf16 else ""
    ops = {"gat_attention": gat_attention,
           "gat_attention_backward": gat_attention_backward,
           "gat_attention_bf16": gat_attention_bf16,
           "gat_attention_backward_bf16": gat_attention_backward_bf16,
           "substep_megakernel": substep_megakernel}
    fwd_name, bwd_name = "gat_attention" + sfx, "gat_attention_backward" + sfx
    spans = {"rollout": [], "learn_burst": []}

    def synced(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            spans[key].append(time.perf_counter() - t0)
            return res
        return run

    saved = (ParallelDDPG.rollout_episodes, ParallelDDPG.learn_burst)
    ParallelDDPG.rollout_episodes = synced(saved[0], "rollout")
    ParallelDDPG.learn_burst = synced(saved[1], "learn_burst")
    args = TRAIN_ARGS if args is None else args
    argv = args + ["--precision", precision]
    if checkpoint:
        argv += ["--checkpoint", checkpoint]
    try:
        with tempfile.TemporaryDirectory() as d:
            for op in ops.values():
                op.launches = 0
            res = cli.run_train(argv + (["--result-dir", d] if result_dir
                                        else []))
            counts = {k: op.launches for k, op in ops.items()}
            rewards = res["trainer"].history
            if result_dir:
                with open(f"{d}/rewards.csv") as f:
                    rewards = f.read().split()[1:]
    finally:
        ParallelDDPG.rollout_episodes, ParallelDDPG.learn_burst = saved
    trainer, state, buffers = res["trainer"], res["state"], res["buffers"]
    agent = trainer.agent_cfg
    check(agent.precision == precision and
          res["summary"]["precision"] == precision,
          f"the run trained under {agent.precision}, not {precision}")
    b = int(args[args.index("--replicas") + 1])
    episodes = int(args[args.index("--episodes") + 1])
    steps = episodes * agent.episode_steps
    acting = sum(1 for g in range(steps) if g >= agent.nb_steps_warmup_critic)
    grad_steps = episodes * (agent.learn_steps or agent.episode_steps)
    check(len(rewards) == episodes, f"{len(rewards)} episodes' rewards for "
          f"{episodes} episodes")
    for row in trainer.history:
        for k in ("episodic_return", "critic_loss", "actor_loss",
                  "q_values"):
            check(math.isfinite(row[k]), f"episode {row['episode']}: {k} "
                  f"is {row[k]}")
    # the run ends with one greedy evaluation episode on one env
    eval_steps = agent.episode_steps
    check(counts["substep_megakernel"] == steps + eval_steps,
          f"{counts['substep_megakernel']} megakernel launches for "
          f"{steps} env steps and {eval_steps} evaluation steps (want 1 per "
          "step)")
    want_gat = 3 * acting + 15 * grad_steps + 3 * eval_steps
    check(counts[fwd_name] == want_gat,
          f"{counts[fwd_name]} {fwd_name} launches, want 3 x {acting} acting "
          f"steps + 15 x {grad_steps} gradient steps + 3 x {eval_steps} "
          f"evaluation steps = {want_gat}")
    want_bwd = 6 * grad_steps
    check(counts[bwd_name] == want_bwd,
          f"{counts[bwd_name]} {bwd_name} launches, want 6 x {grad_steps} "
          f"gradient steps = {want_bwd}")
    others = {k: n for k, n in counts.items()
              if k not in (fwd_name, bwd_name, "substep_megakernel")}
    check(not any(others.values()),
          f"the {precision} run launched the other dtype's kernels: {others}")
    cap = max(agent.mem_limit // b, 1)
    want_fill = min(steps, cap)
    check(bool((buffers.size == want_fill).all()),
          f"replay holds {buffers.size.tolist()[:4]}..., want {want_fill}")
    # masters and Adam states f32, replay float leaves in the policy's dtype
    for net in ("actor", "critic", "target_actor", "target_critic"):
        check(all(p.dtype == torch.float32
                  for p in getattr(state, net).parameters()),
              f"{net} has parameters that are not f32")
    for opt in (state.actor_opt, state.critic_opt):
        check(all(st["exp_avg"].dtype == st["exp_avg_sq"].dtype ==
                  torch.float32 for st in opt.state.values()),
              "an Adam state is not f32")
    replay_dt = torch.bfloat16 if bf16 else torch.float32
    for leaf in ("obs.nodes", "next_obs.nodes", "obs.mask", "action"):
        check(buffers.data[leaf].dtype == replay_dt,
              f"replay leaf {leaf} is {buffers.data[leaf].dtype}")
    for leaf in ("reward", "done"):
        check(buffers.data[leaf].dtype == torch.float32,
              f"replay leaf {leaf} is {buffers.data[leaf].dtype}")
    if checkpoint:
        meta = read_checkpoint_meta(checkpoint)
        check(meta.get("precision") == precision and
              verify_checkpoint(checkpoint),
              f"checkpoint sidecar {meta} does not record {precision} or "
              "its checksum")
    # every parameter moved from its seeded initial value
    fresh = ParallelDDPG(trainer.env, agent, b, device=dev).init(
        torch.Generator().manual_seed(trainer.seed))
    for net, init in (("actor", fresh.actor), ("critic", fresh.critic)):
        final = dict(getattr(state, net).named_parameters())
        for name, p0 in init.named_parameters():
            check(not torch.equal(p0, final[name]),
                  f"{net}.{name} did not move in training")
    # gradients through the kernels' autograd.Function vs a reference of
    # the same precision: the dense path (f32), the kernels' plain versions
    # (bf16; the dense bf16 path's autograd rounds its cotangents to bf16
    # and is only printed)
    pddpg = trainer.pddpg
    batch = pddpg.sample_across(buffers)

    def copies(impl):
        nets = {}
        for net in ("actor", "critic", "target_actor", "target_critic"):
            src = getattr(state, net)
            cls = Actor if "actor" in net else QNetwork
            copy = cls(agent, src.action_dim, gnn_impl=impl,
                       sched_shape=getattr(src, "sched_shape", None)).to(dev)
            copy.load_state_dict(src.state_dict())
            nets[net] = copy
        return SimpleNamespace(**nets)

    def grads_of(st):
        out = {}
        for kind in ("critic", "actor"):
            net = getattr(st, kind)
            loss = (pddpg.ddpg.critic_loss(st, batch)[0] if kind == "critic"
                    else pddpg.ddpg.actor_loss(st, batch))
            out[kind] = dict(zip(
                [n for n, _ in net.named_parameters()],
                torch.autograd.grad(loss, list(net.parameters()))))
        return out

    def worst_ratio(got, ref):
        return max(float((g - ref[k][n]).abs().max())
                   / max(float(ref[k][n].abs().max()), GRAD_ATOL)
                   for k in got for n, g in got[k].items())

    kernel_grads = grads_of(state)
    dense_grads = grads_of(copies("dense"))
    if bf16:
        with plain_attention(torch):
            ref_grads = grads_of(copies("pallas"))
        ref_name, scale_tol = "the kernels' plain versions", GRAD_BF16_SCALE
    else:
        ref_grads, ref_name, scale_tol = dense_grads, "the dense path", \
            GRAD_RTOL
    for kind, grads in kernel_grads.items():
        for name, g in grads.items():
            d = ref_grads[kind][name]
            err = float((g - d).abs().max())
            scale = float(d.abs().max())
            check(err <= scale_tol * scale + GRAD_ATOL,
                  f"{precision} {kind}.{name}: gradient through the kernels "
                  f"differs from {ref_name} by {err} (largest entry "
                  f"{scale})")
    worst = worst_ratio(kernel_grads, ref_grads)
    dense_note = ""
    if bf16:
        dense_note = (f"; the dense bf16 path's autograd (bf16 cotangents, "
                      f"as the JAX package's VJP) lies "
                      f"{worst_ratio(dense_grads, ref_grads):.2e} of a "
                      "tensor's largest entry from the plain versions")
    roll_steps = steps * b
    roll_s = sum(spans["rollout"])
    print(f"train{label} {precision}: {episodes} episodes x {agent.episode_steps} "
          f"steps at B={b}: returns "
          f"{[round(r['episodic_return'], 4) for r in trainer.history]}, "
          f"final success {[round(r['final_succ_ratio'], 4) for r in trainer.history]}, "
          f"critic loss {[r['critic_loss'] for r in trainer.history]}, "
          f"actor loss {[r['actor_loss'] for r in trainer.history]}, "
          f"q {[r['q_values'] for r in trainer.history]}; every actor and "
          f"critic parameter moved; masters and Adam states f32; replay "
          f"{want_fill} per replica, float leaves {replay_dt}", flush=True)
    print(f"train{label} {precision} launches (every count 0 before the run): "
          f"megakernel {counts['substep_megakernel']} (1 per env step and "
          f"evaluation step), {fwd_name} {counts[fwd_name]} (3 x {acting} "
          f"acting steps + 15 x {grad_steps} gradient steps + 3 x "
          f"{eval_steps} evaluation steps), {bwd_name} {counts[bwd_name]} (6 x "
          f"{grad_steps} gradient steps), other attention kernels {others}; "
          f"GATv2/actor/critic gradients through the kernels vs {ref_name}: "
          f"max abs diff / largest entry {worst:.2e} (limit {scale_tol:g})"
          f"{dense_note}", flush=True)
    sps = roll_steps / roll_s
    print(f"train{label} {precision} timing on {smi}: rollout {roll_steps} env "
          f"steps in {roll_s:.2f} s = {sps:.1f} env-steps/s; learn bursts "
          f"{[round(t, 3) for t in spans['learn_burst']]} s "
          f"({grad_steps // episodes} gradient steps each); wall "
          f"{res['summary']['wall_s']:.1f} s", flush=True)
    print(f"train_summary{label} {precision}: " + json.dumps(res["summary"]))
    own = {k: counts[k] for k in (fwd_name, bwd_name, "substep_megakernel")}
    return own, {"sps": sps, "bursts": list(spans["learn_burst"]),
                 "summary": res["summary"]}


def serve_from_checkpoint(torch, dev, smi, checkpoint):
    """Phase 11: ``run_serve`` on a bf16 checkpoint, with every attention
    count set to 0 before it; answers held against the plain bf16 actor
    on CPU copies.  Returns the bf16 forward kernel's launches."""
    import numpy as np

    from gsc_tpu_torch.env.observations import GraphObs
    from gsc_tpu_torch.models.nets import Actor
    from gsc_tpu_torch.ops.gat_attention import (gat_attention,
                                                 gat_attention_bf16)
    from gsc_tpu_torch.serve import run_serve

    gat_attention.launches = gat_attention_bf16.launches = 0
    reports = [run_serve(device=dev, pool_steps=POOL_STEPS, requests=r,
                         concurrency=c, buckets=BUCKETS, deadline_ms=dl,
                         seed=0, checkpoint=checkpoint)
               for r, c, dl in BF16_BURSTS]
    calls = sum(len(rep.flushes) + len(rep.startup["buckets"])
                for rep in reports)
    check(gat_attention.launches == 0,
          f"the bf16 server launched the f32 kernel "
          f"{gat_attention.launches} times")
    check(gat_attention_bf16.launches == 3 * calls,
          f"{gat_attention_bf16.launches} bf16 kernel launches for {calls} "
          "dispatches and warm-up calls (want 3 per call)")
    for (r, c, dl), report in zip(BF16_BURSTS, reports):
        summ = report.summary()
        ddpg = report.ddpg
        check(ddpg.agent.precision == "bf16",
              f"served under {ddpg.agent.precision}, not the checkpoint's "
              "bf16")
        check(not report.errors, f"serve errors: {report.errors[:3]}")
        check(len(report.answers) == r, f"{len(report.answers)} of {r} "
              "answered")
        plain = Actor(ddpg.agent, ddpg.action_dim, gnn_impl="dense")
        plain.load_state_dict({k: v.cpu() for k, v in
                               ddpg.actor.state_dict().items()})
        worst, ambiguous, pre_diff = 0.0, 0, 0.0
        for k, ans in report.answers:
            check(ans.shape == (1728,) and bool(np.isfinite(ans).all()),
                  f"answer for pool obs {k} is {ans.shape} or not finite")
            check(np.allclose(ans.reshape(-1, 24).sum(-1), 1.0, rtol=1e-5),
                  "a destination row does not sum to 1")
        for k in sorted({k for k, _ in report.answers}):
            obs = GraphObs(**{f: torch.from_numpy(np.asarray(v))[None]
                              for f, v in vars(report.pool[k]).items()})
            with torch.inference_mode():
                pre = ddpg.actor(obs.to(dev))[0].cpu().numpy()
                single = ddpg.greedy_action(obs.to(dev))[0].cpu().numpy()
                plain_pre = plain(obs)
                want = ddpg.env.process_action(
                    plain_pre.clamp(0.0, 1.0))[0].numpy()
            pre_diff = max(pre_diff, float(np.abs(
                pre - plain_pre[0].numpy()).max()))
            for got, what in [(single, "kernel vs plain bf16 actor on CPU")] \
                    + [(a, "batched vs plain bf16 actor on CPU")
                       for kk, a in report.answers if kk == k]:
                e, amb = compare_answers(got, want, pre, f"{what}, obs {k}",
                                         ANSWER_BF16_RTOL, ANSWER_BF16_ATOL,
                                         THRESH_BF16_TOL)
                worst = max(worst, e)
                ambiguous = max(ambiguous, amb)
        print(f"serve bf16 burst from the checkpoint: {summ['completed']} "
              f"requests at concurrency {c}, deadline {dl:g} ms, "
              f"{summ['dispatches']} dispatches (buckets "
              f"{sorted({b for _, b in report.flushes})}); "
              f"{summ['requests_per_s']:.1f} req/s, p50 {summ['p50_ms']:.3f} "
              f"ms, p99 {summ['p99_ms']:.3f} ms, startup "
              f"{summ['startup_s']:.2f} s on {smi}; answers vs the plain "
              f"bf16 actor on CPU copies max abs diff {worst:.2e} (up to "
              f"{ambiguous} ambiguous rows per answer; actor outputs "
              f"before the threshold max abs diff {pre_diff:.2e})",
              flush=True)
        print(f"serve_summary bf16 c={c}: " + json.dumps(summ))
    return gat_attention_bf16.launches


def learner_tensors(state, buffer, draws):
    """Every tensor of a training run's carries: the four networks, both
    Adam states, the replay leaves with ``pos`` and ``size``, and the
    ``Draws`` generator state."""
    out = {}
    for net in ("actor", "critic", "target_actor", "target_critic"):
        for k, v in getattr(state, net).state_dict().items():
            out[f"{net}.{k}"] = v
    for opt in ("actor_opt", "critic_opt"):
        for i, st in getattr(state, opt).state_dict()["state"].items():
            for k, v in st.items():
                out[f"{opt}.{i}.{k}"] = v
    for k, v in buffer.data.items():
        out[f"replay.{k}"] = v
    out["replay.pos"], out["replay.size"] = buffer.pos, buffer.size
    out["draws"] = draws.generator.get_state()
    return out


def single_env_split(torch, dev, trainer, state, ring):
    """Phase 13 (e): ``GEN_PROFILE_STEPS`` acting single-env rollout steps
    under ``torch.profiler`` (wall and device time per step, the
    megakernel's part, kernel launches and device-to-host reads per step),
    then the last of their megakernel launches (B=1, the trained policy's
    schedule) against the plain version on the card and on CPU copies;
    returns the split and that launch's largest float difference."""
    from torch.profiler import ProfilerActivity, profile

    from gsc_tpu_torch.ops.substep import substep_megakernel, substep_plain
    from gsc_tpu_torch.sim import cases

    agent = trainer.agent_cfg
    ddpg, draws = trainer.ddpg, trainer.draws
    step0 = GEN_EPISODES * agent.episode_steps
    topo, traffic = trainer._episode(GEN_EPISODES)
    es, obs = trainer.env.reset(topo, traffic, batch=1)
    ddpg.rollout_episode(state, ring, es, obs, topo, traffic, step0, draws,
                         num_steps=2)
    last = {}
    launch = substep_megakernel.launch

    def kept(engine, *a, **k):
        last["args"], last["out"] = (engine, *a), launch(engine, *a, **k)
        return last["out"]

    substep_megakernel.launch = kept
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ddpg.rollout_episode(state, ring, es, obs, topo, traffic, step0,
                                 draws, num_steps=GEN_PROFILE_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del substep_megakernel.launch
    ka = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    n = GEN_PROFILE_STEPS
    out = {"wall_ms": 1e3 * wall / n,
           "device_ms": sum(dev_us(e) for e in ka) / 1e3 / n,
           "mega_ms": sum(dev_us(e) for e in ka
                          if "substep_megakernel" in e.key) / 1e3 / n,
           "launches": sum(e.count for e in ka
                           if e.key in ("cudaLaunchKernel",
                                        "cuLaunchKernel")) / n,
           "syncs": sum(e.count for e in ka
                        if e.key == "aten::_local_scalar_dense") / n}
    check(out["device_ms"] > 0, "the profiler recorded no device time")
    out["idle"] = 1.0 - out["device_ms"] / out["wall_ms"]

    engine, *args = last["args"]
    got = last["out"]
    check(got.batch == 1, f"the single-env megakernel ran at B={got.batch}")
    on_cpu = [a.to("cpu") if hasattr(a, "to") else a for a in args]
    want_card = substep_plain(engine, *args)
    want_cpu = substep_plain(engine, *on_cpu)
    what = "single-env megakernel launch on the trained state"
    err = cases.compare_states(got, want_card, SUB_RTOL, SUB_ATOL,
                               f"{what}, kernel vs plain on card: ")
    check(cases.bit_equal(got.to("cpu"), want_cpu),
          f"{what}: the kernel is not bit-equal to the plain version on "
          "CPU copies")
    out["flows"] = int(got.metrics.generated.sum())
    return out, err


def generalization_slice(torch, dev, smi):
    """Phase 13: ``init-configs``, single-env training over a switching
    schedule of GraphML networks with an unseen inference network, exact
    resume and ``infer``, at the flagship widths on the card.  Returns the
    launch counts of the kernels in the straight run (every count 0
    before it) and the run's numbers."""
    import math
    from collections import Counter

    from gsc_tpu_torch import cli
    from gsc_tpu_torch.agents.ddpg import DDPG
    from gsc_tpu_torch.ops.gat_attention import (gat_attention,
                                                 gat_attention_backward,
                                                 gat_attention_backward_bf16,
                                                 gat_attention_bf16)
    from gsc_tpu_torch.ops.substep import substep_megakernel
    from gsc_tpu_torch.topology.compiler import load_topology
    from gsc_tpu_torch.utils.checkpoint import (read_checkpoint_meta,
                                                verify_checkpoint)

    ops = {"gat_attention": gat_attention,
           "gat_attention_backward": gat_attention_backward,
           "gat_attention_bf16": gat_attention_bf16,
           "gat_attention_backward_bf16": gat_attention_backward_bf16,
           "substep_megakernel": substep_megakernel}
    root = tempfile.mkdtemp(prefix="gsc_generalization_")
    laps = Laps()
    parts = laps.seconds
    try:
        # (a) the config set and the GraphML networks, the port's writer
        cfg = os.path.join(root, "cfg")
        cli.init_configs(cfg)
        nets = os.path.join(cfg, "networks")
        bt = load_topology(os.path.join(
            nets, "bteurope-in2-rand-cap1-2.graphml"))
        caps = set(bt.node_cap[bt.node_mask].tolist())
        check(int(bt.n_nodes) == 24 and int(bt.n_edges) == 37
              and caps <= {1.0, 2.0},
              f"bteurope-in2 read back as {int(bt.n_nodes)} nodes, "
              f"{int(bt.n_edges)} edges, caps {sorted(caps)}")
        sched = os.path.join(root, "scheduler.yaml")
        with open(sched, "w") as f:
            f.write("training_network_files:\n"
                    f"  - {nets}/abilene-in4.graphml\n"
                    f"  - {nets}/claranet-in4-cap1.graphml\n"
                    f"inference_network: {nets}/compuserve-in4-cap1.graphml\n"
                    f"period: {GEN_PERIOD}\n")
        base = ["--scheduler", sched, "--replicas", "1", "--seed", "0",
                "--simulator-config", os.path.join(cfg, "simulator.yaml"),
                "--service", os.path.join(cfg, "service_abc.yaml")]
        laps.lap("a")

        # (b) the straight run, timed and counted
        spans = {"rollout": [], "learn_burst": []}
        shapes = Counter()

        def synced(fn, key):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn(*a, **k)
                torch.cuda.synchronize()
                spans[key].append(time.perf_counter() - t0)
                return res
            return run

        def counted(op):
            launch = op.launch

            def run(xl, *a, **k):
                shapes[tuple(xl.shape[:-2])] += 1
                return launch(xl, *a, **k)
            return run

        saved = (DDPG.rollout_episode, DDPG.learn_burst)
        DDPG.rollout_episode = synced(saved[0], "rollout")
        DDPG.learn_burst = synced(saved[1], "learn_burst")
        gat_attention.launch = counted(gat_attention)
        try:
            for op in ops.values():
                op.launches = 0
            res_b = cli.run_train(base + [
                "--episodes", str(GEN_EPISODES), "--result-dir",
                os.path.join(root, "b")])
            counts = {k: op.launches for k, op in ops.items()}
        finally:
            DDPG.rollout_episode, DDPG.learn_burst = saved
            del gat_attention.launch
        trainer = res_b["trainer"]
        agent = trainer.agent_cfg
        steps = GEN_EPISODES * agent.episode_steps
        acting = sum(1 for g in range(steps)
                     if g >= agent.nb_steps_warmup_critic)
        grad_steps = GEN_EPISODES * (agent.learn_steps or agent.episode_steps)
        eval_steps = agent.episode_steps
        driver = trainer.driver
        names = [driver.topology_name_for(ep) for ep in range(GEN_EPISODES)]
        check(len(set(names)) == 2 and all(
            a != b for a, b in zip(names, names[1:])),
            f"the schedule did not switch every episode: {names}")
        infer_net = driver.inference_topology
        check(int(infer_net.n_nodes) == 14 and all(
            not torch.equal(infer_net.node_mask, t.node_mask)
            or not torch.equal(infer_net.adj_edge_id, t.adj_edge_id)
            for t in driver.topologies),
            "the inference network is one of the training networks")
        for row in trainer.history:
            for k in ("episodic_return", "critic_loss", "actor_loss",
                      "q_values"):
                check(math.isfinite(row[k]), f"episode {row['episode']}: "
                      f"{k} is {row[k]}")
        check(len(spans["learn_burst"]) == GEN_EPISODES,
              f"{len(spans['learn_burst'])} learn bursts in {GEN_EPISODES} "
              "episodes (each ends at or after the warm-up)")
        buf = res_b["buffers"]
        topo_idx = buf.data["topo_idx"][:steps].view(GEN_EPISODES, -1)
        want_idx = [ep // GEN_PERIOD % 2 for ep in range(GEN_EPISODES)]
        check(int(buf.size) == min(steps, agent.mem_limit) and all(
            bool((topo_idx[ep] == want_idx[ep]).all())
            for ep in range(GEN_EPISODES)),
            f"replay size {int(buf.size)}, topo_idx per episode "
            f"{[sorted(set(r.tolist())) for r in topo_idx]}")
        check(counts["substep_megakernel"] == steps + eval_steps,
              f"{counts['substep_megakernel']} megakernel launches, want 1 "
              f"per env step ({steps}) and evaluation step ({eval_steps})")
        want_gat = 3 * acting + 15 * grad_steps + 3 * eval_steps
        check(counts["gat_attention"] == want_gat,
              f"{counts['gat_attention']} attention launches, want 3 x "
              f"{acting} acting + 15 x {grad_steps} gradient + 3 x "
              f"{eval_steps} evaluation steps = {want_gat}")
        check(counts["gat_attention_backward"] == 6 * grad_steps,
              f"{counts['gat_attention_backward']} backward launches, want "
              f"6 x {grad_steps}")
        check(counts["gat_attention_bf16"] == 0 and
              counts["gat_attention_backward_bf16"] == 0,
              "the f32 run launched a bf16 kernel")
        want_shapes = {(1,): 3 * (acting + eval_steps),
                       (agent.batch_size,): 15 * grad_steps}
        check(dict(shapes) == want_shapes,
              f"attention launches per batch shape {dict(shapes)}, want "
              f"{want_shapes}")
        fresh = DDPG(trainer.env, agent, device=dev).init_state(
            torch.Generator().manual_seed(trainer.seed))
        for net in ("actor", "critic"):
            final = dict(getattr(res_b["state"], net).named_parameters())
            for name, p0 in getattr(fresh, net).named_parameters():
                check(not torch.equal(p0, final[name]),
                      f"{net}.{name} did not move in training")
        ck_b = res_b["summary"]["checkpoint"]
        meta = read_checkpoint_meta(ck_b)
        check(verify_checkpoint(ck_b) and meta.get("episode") == GEN_EPISODES
              and meta.get("precision") == "f32",
              f"final checkpoint sidecar {meta}")
        ev = res_b["eval"]
        check(math.isfinite(ev["mean_return"])
              and 0.0 <= ev["final_succ_ratio"] <= 1.0,
              f"evaluation on the inference network: {ev}")
        laps.lap("b")

        # (c) two episodes, a checkpoint, a resumed third: bit for bit
        res_c = cli.run_train(base + ["--episodes", str(GEN_EPISODES - 1),
                                      "--result-dir",
                                      os.path.join(root, "c")])
        laps.lap("c")
        res_r = cli.run_train(base + [
            "--episodes", str(GEN_EPISODES), "--resume",
            res_c["summary"]["checkpoint"], "--result-dir",
            os.path.join(root, "r")])
        check(res_r["summary"]["start_episode"] == GEN_EPISODES - 1,
              f"resumed at {res_r['summary']['start_episode']}")
        want = learner_tensors(res_b["state"], buf, trainer.draws)
        got = learner_tensors(res_r["state"], res_r["buffers"],
                              res_r["trainer"].draws)
        check(set(got) == set(want), "the resumed run's tensors differ in "
              "name from the straight run's")
        differ = [k for k, v in want.items()
                  if got[k].dtype != v.dtype or not torch.equal(got[k], v)]
        check(not differ, f"resumed != straight on {len(differ)} of "
              f"{len(want)} tensors: {differ[:6]}")
        check(res_r["trainer"].history[-1]["episodic_return"]
              == trainer.history[-1]["episodic_return"],
              "the resumed episode's return differs from the straight one")
        laps.lap("resume")

        # (d) infer on the straight run's checkpoint, the unseen network
        res_d = cli.run_infer(base[:2] + base[6:] + [
            "--checkpoint", ck_b, "--episodes", "1"])
        check(res_d["eval"]["mean_return"] == ev["mean_return"]
              and res_d["eval"]["final_succ_ratio"] == ev["final_succ_ratio"],
              f"infer {res_d['eval']} differs from the run's own evaluation "
              f"{ev}")
        laps.lap("d")

        # (e) where a single-env step goes: a profile of acting rollout
        # steps, whose last megakernel launch is held against its plain
        # version
        split, split_err = single_env_split(torch, dev, trainer,
                                            res_b["state"], buf)
        laps.lap("e")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    sps = steps / sum(spans["rollout"])
    s = res_b["summary"]
    print(f"generalization: {GEN_EPISODES} episodes x {agent.episode_steps} "
          f"steps on one env over {names} (period {GEN_PERIOD}), inference "
          f"on compuserve-in4-cap1 (unseen): returns "
          f"{[round(r['episodic_return'], 4) for r in trainer.history]}, "
          f"final success {[round(r['final_succ_ratio'], 4) for r in trainer.history]}, "
          f"critic loss {[r['critic_loss'] for r in trainer.history]}; "
          f"evaluation {json.dumps(ev)}; infer {json.dumps(res_d['eval'])}",
          flush=True)
    print(f"generalization resume: {GEN_EPISODES - 1} episodes, checkpoint, "
          f"resumed to {GEN_EPISODES}: torch.equal to the straight run on "
          f"all {len(want)} tensors (networks, targets, Adam states, replay "
          f"leaves, pos/size, Draws state)", flush=True)
    print(f"generalization launches (every count 0 before the straight "
          f"run): megakernel {counts['substep_megakernel']} at B=1, "
          f"gat_attention {counts['gat_attention']} (B=1: "
          f"{shapes[(1,)]}, B={agent.batch_size}: "
          f"{shapes[(agent.batch_size,)]}), gat_attention_backward "
          f"{counts['gat_attention_backward']} at B={agent.batch_size}",
          flush=True)
    print(f"generalization timing on {smi}: single-env rollout {steps} env "
          f"steps in {sum(spans['rollout']):.3f} s = {sps:.1f} "
          f"env-steps/s; learn bursts "
          f"{[round(t, 3) for t in spans['learn_burst']]} s; evaluation "
          f"compile_warmup_s {ev['compile_warmup_s']} steady_s "
          f"{ev['steady_s']} (infer: {res_d['eval']['compile_warmup_s']} / "
          f"{res_d['eval']['steady_s']}); checkpoint save "
          f"{s['ckpt_save_s']:.3f} s, load (resume) "
          f"{res_r['summary']['ckpt_load_s']:.3f} s", flush=True)
    print(f"generalization split on {smi}: {GEN_PROFILE_STEPS} acting "
          f"single-env steps under the profiler: {split['wall_ms']:.3f} ms "
          f"per step, device busy {split['device_ms']:.3f} ms per step "
          f"(idle share {split['idle']:.3f}), megakernel "
          f"{split['mega_ms']:.3f} ms; per step {split['launches']:.1f} "
          f"kernel launches and {split['syncs']:.1f} device-to-host reads; "
          f"the last megakernel launch (B=1, {split['flows']} flows "
          f"generated) vs plain: bit-equal on CPU copies, max float diff "
          f"on the card {split_err:.2e}", flush=True)
    print("generalization part seconds: (a) init-configs "
          f"{parts['a']:.3f}, (b) straight run {parts['b']:.3f}, (c) "
          f"{GEN_EPISODES - 1} episodes + checkpoint {parts['c']:.3f}, "
          f"resume to {GEN_EPISODES} {parts['resume']:.3f}, (d) infer "
          f"{parts['d']:.3f}, (e) split {parts['e']:.3f}; phase 13 "
          f"{sum(parts.values()):.3f}", flush=True)
    print("generalization_summary: " + json.dumps(s))
    own = {k: counts[k] for k in ("gat_attention", "gat_attention_backward",
                                  "substep_megakernel")}
    return own, {"sps": sps, "bursts": list(spans["learn_burst"]),
                 "max_abs_err": split_err}


def large_attention_checks(torch, dev, smi, parent=None):
    """Phase 14 (a): kernel #1's four forms at interroute's and rung 5's
    graph sizes (LARGE_SHAPES) against their plain versions, plain and
    saturated inputs, both aggregations, with phase 3's and phase 9's
    tolerances, forward relaunches bit-identical (check_backward and
    check_backward_bf16 relaunch the backward; on saturated inputs d_att
    and d_bias are held to float64, as ``sums_to_f64`` says why); at mean
    aggregation each
    form's device time per launch, time per call, its plain version's time
    and its bound.  Then both backward forms at the learn bursts' batch
    (BURST_LARGE_SHAPES): checked at mean aggregation and timed, and timed
    in turns with ``parent`` (the parent commit's f32 and bf16 backward
    wrappers) where built.  Returns the largest errors by form and the
    times by (form, N) and, at batch 100, (form, N, B)."""
    from gsc_tpu_torch.ops.gat import attention_bf16
    from gsc_tpu_torch.ops.gat_attention import (attention_backward_plain,
                                                 attention_plain,
                                                 gat_attention,
                                                 gat_attention_backward,
                                                 gat_attention_backward_bf16,
                                                 gat_attention_bf16)

    fmt = lambda v: "not measured" if v is None else f"{v:.5f} ms"
    errs = {"gat_attention": 0.0, "gat_attention_backward": 0.0,
            "gat_attention_bf16": 0.0, "gat_attention_backward_bf16": 0.0}
    times = {}
    for b, n, f in LARGE_SHAPES:
        for saturated in (False, True):
            for mean in (True, False):
                seed = b * 1000 + n
                what = (f"{(b, n, f)} {'mean' if mean else 'sum'}"
                        + (" saturated" if saturated else ""))
                if saturated:
                    args = saturated_inputs(b, n, f, seed, torch, dev)
                    grad = 0.2 * grad_input(b, n, f, seed + 1, torch, dev)
                else:
                    args = gat_inputs(b, n, f, seed, torch, dev)
                    grad = grad_input(b, n, f, seed + 1, torch, dev)
                adj = args[4]
                empty = ~adj.any(dim=-1)
                got = gat_attention.launch(*args, mean)
                again = gat_attention.launch(*args, mean)
                torch.cuda.synchronize()
                want = attention_plain(*args, mean)
                ref = attention_plain(*[a.double() if a.is_floating_point()
                                        else a for a in args], mean)
                err = float((got - want).abs().max())
                k64 = float((got.double() - ref).abs().max())
                p64 = float((want.double() - ref).abs().max())
                check(torch.equal(got, again),
                      f"two forward launches differ at {what}")
                check(torch.allclose(got, want, rtol=KERNEL_RTOL,
                                     atol=KERNEL_ATOL),
                      f"kernel != plain at {what}: max abs err {err}")
                check(k64 <= F64_RATIO * max(p64, F64_FLOOR),
                      f"kernel is {k64} from float64 at {what}, the plain "
                      f"version {p64}")
                check(bool((got[empty] == 0).all()),
                      f"rows without a neighbour are not 0 at {what}")
                e_b, line = check_backward(args, grad, mean, what, torch,
                                           sums_to_f64=saturated)
                h_args, h_grad = to_bf16(args), grad.to(torch.bfloat16)
                h_got = gat_attention_bf16.launch(*h_args, mean)
                h_again = gat_attention_bf16.launch(*h_args, mean)
                torch.cuda.synchronize()
                h_want = attention_plain(*h_args, mean)
                h_ref = attention_bf16(*h_args, mean, wide=torch.float64)
                ulp = bf16_ulp(h_want)
                h_err = float((h_got.float() - h_want.float()).abs().max())
                hk64 = float((h_got.double() - h_ref).abs().max())
                hp64 = float((h_want.double() - h_ref).abs().max())
                check(torch.equal(h_got, h_again),
                      f"two bf16 forward launches differ at {what}")
                check(h_err <= ulp, f"bf16 kernel != plain at {what}: max "
                      f"abs err {h_err}, one ulp {ulp}")
                check(hk64 <= 2.0 * max(hp64, ulp / 4),
                      f"bf16 kernel is {hk64} from float64 at {what}, the "
                      f"plain version {hp64}")
                check(bool((h_got[empty] == 0).all()),
                      f"bf16 rows without a neighbour are not 0 at {what}")
                e_hb, h_line = check_backward_bf16(h_args, h_grad, mean,
                                                   what, torch,
                                                   sums_to_f64=saturated)
                for key, e in (("gat_attention", err),
                               ("gat_attention_backward", e_b),
                               ("gat_attention_bf16", h_err),
                               ("gat_attention_backward_bf16", e_hb)):
                    errs[key] = max(errs[key], e)
                print(f"  {what}: forward max abs err {err:.2e} (vs f64 "
                      f"{k64:.2e}/{p64:.2e}), bf16 forward {h_err:.2e} (1 "
                      f"ulp {ulp:.2e}); {line}; {h_line}", flush=True)
                if not mean or saturated:
                    continue
                xl, xr, att, _, adj = args
                hxl, hxr = h_args[0], h_args[1]
                forms = {
                    "gat_attention": (
                        lambda: gat_attention.launch(*args, True),
                        lambda: attention_plain(*args, True),
                        gat_bound(args), "gat_attention_kernel"),
                    "gat_attention_backward": (
                        lambda: gat_attention_backward.launch(
                            grad, xl, xr, att, adj, True),
                        lambda: attention_backward_plain(grad, xl, xr, att,
                                                         adj, True),
                        gat_backward_bound(args, grad),
                        "gat_attention_backward"),
                    "gat_attention_bf16": (
                        lambda: gat_attention_bf16.launch(*h_args, True),
                        lambda: attention_plain(*h_args, True),
                        gat_bound(h_args), "gat_attention_kernel"),
                    "gat_attention_backward_bf16": (
                        lambda: gat_attention_backward_bf16.launch(
                            h_grad, hxl, hxr, att, adj, True),
                        lambda: attention_backward_plain(h_grad, hxl, hxr,
                                                         att, adj, True),
                        gat_backward_bound(h_args, h_grad),
                        "gat_attention_backward")}
                for name, (fn, plain, (bound, by), kern) in forms.items():
                    call_ms = cuda_time_ms(fn, torch, reps=50, warmup=5)
                    dev_ms = profile_device_ms(fn, torch, kernel=kern)
                    plain_ms = cuda_time_ms(plain, torch, reps=5, warmup=1)
                    times[(name, n)] = (dev_ms, call_ms, plain_ms, bound, by)
                    print(f"    {name} at {(b, n, f)}: device time "
                          f"{fmt(dev_ms)} per launch, {call_ms:.5f} ms per "
                          f"call (events, wrapper); plain {plain_ms:.4f} ms;"
                          f" bound {bound:.6f} ms ({by}) on {smi}",
                          flush=True)
    # the backward at the learn bursts' batch: checked at mean
    # aggregation, timed, and timed in turns with the parent's where built
    for b, n, f in BURST_LARGE_SHAPES:
        seed = b * 1000 + n
        args = gat_inputs(b, n, f, seed, torch, dev)
        grad = grad_input(b, n, f, seed + 1, torch, dev)
        h_args, h_grad = to_bf16(args), grad.to(torch.bfloat16)
        what = f"{(b, n, f)} mean"
        e_b, line = check_backward(args, grad, True, what, torch)
        e_hb, h_line = check_backward_bf16(h_args, h_grad, True, what, torch)
        errs["gat_attention_backward"] = max(errs["gat_attention_backward"],
                                             e_b)
        errs["gat_attention_backward_bf16"] = max(
            errs["gat_attention_backward_bf16"], e_hb)
        print(f"  {what}: {line}; {h_line}", flush=True)
        xl, xr, att, _, adj = args
        hxl, hxr = h_args[0], h_args[1]
        forms = [("gat_attention_backward", gat_attention_backward,
                  (grad, xl, xr, att, adj), args, 0),
                 ("gat_attention_backward_bf16", gat_attention_backward_bf16,
                  (h_grad, hxl, hxr, att, adj), h_args, 1)]
        for name, op, ins, a, k in forms:
            fn = lambda: op.launch(*ins, True)
            call_ms = cuda_time_ms(fn, torch, reps=50, warmup=5)
            dev_ms = profile_device_ms(fn, torch,
                                       kernel="gat_attention_backward")
            plain_ms = cuda_time_ms(
                lambda: attention_backward_plain(*ins, True), torch, reps=3,
                warmup=1)
            bound, by = gat_backward_bound(a, ins[0])
            times[(name, n, b)] = (dev_ms, call_ms, plain_ms, bound, by)
            turns = ""
            if parent is not None and parent[k] is not None:
                pfn = lambda: parent[k].launch(*ins, True)
                order = (pfn, fn, fn, pfn)
                p_dev = [profile_device_ms(g, torch,
                                           kernel="gat_attention_backward")
                         for g in order]
                p_ms = [cuda_time_ms(g, torch, reps=20, warmup=3)
                        for g in order]
                turns = (f"; parent in turns (parent, kernel, kernel, "
                         f"parent): device time "
                         f"{', '.join(fmt(t) for t in p_dev)}, per call "
                         f"{', '.join(f'{t:.5f} ms' for t in p_ms)}")
            print(f"    {name} at {(b, n, f)}: device time {fmt(dev_ms)} "
                  f"per launch, {call_ms:.5f} ms per call (events, "
                  f"wrapper); plain {plain_ms:.4f} ms; bound {bound:.6f} ms "
                  f"({by}){turns} on {smi}", flush=True)
    return errs, times


def large_megakernel_checks(torch, dev, smi):
    """Phase 14 (b): kernel #2 on one interval of bench.py's interroute
    stack (M = 1024, N = 128) and one of its rung-5 stack (M = 1024, N =
    256, 2 chains over 5 SFs): bit-equal to its plain version on CPU
    copies, a relaunch bit-identical, its shared memory, device time and
    bound.  Returns the times by N and the largest difference to the
    plain version on the card."""
    from gsc_tpu_torch.ops.substep import substep_megakernel, substep_plain
    from gsc_tpu_torch.sim import cases

    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    times, worst = {}, 0.0
    for make in (cases.interroute_case, cases.rung5_case):
        case = make(batch=2, intervals=1)
        eng, b = case.engine, case.batch
        got = cases.run_case(case, dev)
        want = cases.run_case(case, "cpu", plain=True)
        on_card = cases.run_case(case, dev, plain=True)
        for i, (g, w, c) in enumerate(zip(got, want, on_card)):
            check(cases.bit_equal(g.to("cpu"), w),
                  f"{case.name} interval {i}: the kernel is not bit-equal to "
                  "its plain version on CPU copies")
            worst = max(worst, cases.compare_states(
                g, c, SUB_RTOL, SUB_ATOL, f"{case.name} on the card: "))
        check(cases.bit_equal(cases.run_case(case, dev)[-1], got[-1]),
              f"{case.name}: a relaunch is not bit-identical")
        # the second interval, from the first one's state
        topo = case.topo.to(dev).expand(b)
        traffic = case.traffic.to(dev)
        st, cap = eng.begin_interval(got[-1], traffic, case.schedule.to(dev),
                                     case.placement.to(dev))
        run = lambda: substep_megakernel.launch(eng, st, topo, traffic, cap)
        after = run()
        ms = cuda_time_ms(run, torch, reps=5, warmup=1)
        dev_ms = profile_device_ms(run, torch, reps=5,
                                   kernel="substep_megakernel_kernel")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        substep_plain(eng, st, topo, traffic, cap)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        bound, by, _, _ = substep_bound(eng, st, after, b)
        smem = megakernel_smem_bytes(substep_megakernel, eng.M, eng.limits)
        m = got[-1].metrics
        times[eng.N] = (dev_ms, ms, plain_ms, bound, by)
        print(f"  megakernel, {case.name} (B={b}, M={eng.M}, N={eng.N}, "
              f"E={eng.E}, C={eng.C}, P={eng.P}; {smem} bytes of shared "
              f"memory per CTA): bit-equal to the plain version on CPU "
              f"copies, relaunch bit-identical; generated "
              f"{m.generated.tolist()}, processed {m.processed.tolist()}, "
              f"dropped {m.dropped.tolist()}; per interval device time "
              f"{fmt(dev_ms)}, {ms:.4f} ms with the wrapper, plain engine "
              f"{plain_ms:.1f} ms, bound {bound:.6f} ms ({by}) on {smi}",
              flush=True)
    return times, worst


def serve_large(torch, dev, smi, agent, sim_cfg, checkpoint):
    """Phase 14 (e): ``run_serve`` of the interroute checkpoint's f32
    (factored) actor, LARGE_SERVE requests, every count 0 before it;
    answers held against an unbatched call and the plain (dense) actor."""
    from gsc_tpu_torch.config import abc_service
    from gsc_tpu_torch.models.nets import Actor
    from gsc_tpu_torch.ops.gat_attention import gat_attention
    from gsc_tpu_torch.ops.substep import substep_megakernel
    from gsc_tpu_torch.serve import run_serve
    from gsc_tpu_torch.topology import synthetic

    requests, concurrency = LARGE_SERVE
    net = dict(zip(INTERROUTE_NET[::2], INTERROUTE_NET[1::2]))
    gat_attention.launches = substep_megakernel.launches = 0
    report = run_serve(agent, sim_cfg, abc_service(),
                       getattr(synthetic, net["--network"])(), seed=0,
                       pool_steps=POOL_STEPS, requests=requests,
                       concurrency=concurrency, buckets=BUCKETS,
                       deadline_ms=5.0, max_nodes=int(net["--max-nodes"]),
                       max_edges=int(net["--max-edges"]), device=dev,
                       checkpoint=checkpoint)
    calls = len(report.flushes) + len(report.startup["buckets"])
    counts = {"gat_attention": gat_attention.launches,
              "substep_megakernel": substep_megakernel.launches}
    check(not report.errors, f"serve errors: {report.errors[:3]}")
    check(len(report.answers) == requests,
          f"{len(report.answers)} of {requests} answered")
    check(counts["gat_attention"] == 3 * calls,
          f"{counts['gat_attention']} attention launches for {calls} "
          "dispatches and warm-up calls (want 3 per call)")
    check(counts["substep_megakernel"] == POOL_STEPS,
          f"{counts['substep_megakernel']} megakernel launches for a pool "
          f"of {POOL_STEPS} env steps")
    ddpg = report.ddpg
    check(ddpg.actor.factored, "the served interroute actor is not factored")
    plain = Actor(ddpg.agent, ddpg.action_dim, gnn_impl="dense",
                  sched_shape=ddpg.env.limits.scheduling_shape).to(dev)
    plain.load_state_dict(ddpg.actor.state_dict())
    worst, ambiguous = check_answers(report, plain, torch, dev)
    summ = report.summary()
    print(f"serve interroute (factored f32 actor from the checkpoint, "
          f"action dim {ddpg.action_dim}): {summ['completed']} requests at "
          f"concurrency {concurrency}, {summ['dispatches']} dispatches "
          f"(buckets {sorted({b for _, b in report.flushes})}); "
          f"{summ['requests_per_s']:.1f} req/s, p50 {summ['p50_ms']:.3f} ms, "
          f"p99 {summ['p99_ms']:.3f} ms, startup {summ['startup_s']:.2f} s "
          f"on {smi}; answers vs unbatched and plain actor max abs diff "
          f"{worst:.2e} ({ambiguous} ambiguous rows); launches: attention "
          f"{counts['gat_attention']} (3 per call), megakernel "
          f"{counts['substep_megakernel']} (the request pool)", flush=True)
    print("serve_summary interroute: " + json.dumps(summ))
    return counts


def large_network_slice(torch, dev, smi, parent=None):
    """Phase 14: bench.py's interroute and rung-5 stacks on the card.
    (a) kernel #1's four forms at N = 128 and 256, (b) kernel #2 on one
    interroute and one rung-5 interval, (c) ``cli train`` on interroute
    (128 nodes / 192 edges, abc chain, 1024 slots, 200-step episodes,
    mem_limit 2048, the factored heads) at 8 replicas for 2 f32 episodes
    with a checkpoint, then (d) 1 bf16 episode, (e) ``run_serve`` of the
    f32 checkpoint's actor, and (f) ``cli train`` on rung 5
    (``random_network(200, num_ingress=8, seed=11)`` written to GraphML,
    padded to 256 / 384, the mixed catalog, 1024 slots, mem_limit 1024) at
    2 replicas for one 20-step episode with a 20-step learn burst.
    Returns the launches of each kernel in (c)-(f), each count 0 before
    its run, the kernels' times at N = 128 and 256, the largest errors,
    and each run's rollout env-steps/s and burst seconds."""
    import tempfile

    from gsc_tpu_torch.config.loader import load_agent, load_sim
    from gsc_tpu_torch.topology import synthetic

    laps = Laps()
    print(f"phase 14, kernel #1 at N = 128 and 256 vs plain (phase 3's and "
          f"9's tolerances) on {smi}:", flush=True)
    errs, att_times = large_attention_checks(torch, dev, smi, parent)
    laps.lap("(a) kernel #1")
    print("phase 14, kernel #2 at bench.py's large stacks:", flush=True)
    sub_times, sub_err = large_megakernel_checks(torch, dev, smi)
    laps.lap("(b) kernel #2")
    launches, runs = {}, {}
    d = tempfile.mkdtemp(prefix="gsc_large_")
    try:
        paths = {}
        for name, text in (("sim.yaml", LARGE_SIM_YAML),
                           ("interroute.yaml", INTERROUTE_AGENT_YAML),
                           ("rung5.yaml", RUNG5_AGENT_YAML),
                           ("mixed.yaml", MIXED_SERVICE_YAML)):
            paths[name] = os.path.join(d, name)
            with open(paths[name], "w") as fh:
                fh.write(text)
        paths["rung5.graphml"] = os.path.join(d, "rung5.graphml")
        synthetic.write_graphml(
            synthetic.random_network(200, num_ingress=8, seed=11),
            paths["rung5.graphml"])
        interroute = INTERROUTE_NET + [
            "--agent-config", paths["interroute.yaml"],
            "--simulator-config", paths["sim.yaml"]]
        ck = os.path.join(d, "interroute_checkpoint")

        def add(counts):
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n

        counts, runs["interroute f32"] = train_slice(
            torch, dev, smi, "f32", checkpoint=ck, label=" interroute",
            args=interroute + ["--replicas", "8", "--chunk", "50",
                               "--episodes", "2"])
        add(counts)
        laps.lap("(c) interroute f32")
        counts, runs["interroute bf16"] = train_slice(
            torch, dev, smi, "bf16", label=" interroute", result_dir=False,
            args=interroute + ["--replicas", "8", "--chunk", "50",
                               "--episodes", "1"])
        add(counts)
        laps.lap("(d) interroute bf16")
        add(serve_large(torch, dev, smi, load_agent(paths["interroute.yaml"]),
                        load_sim(paths["sim.yaml"]), ck))
        laps.lap("(e) serve")
        counts, runs["rung5 f32"] = train_slice(
            torch, dev, smi, "f32", label=" rung5", result_dir=False,
            args=["--network", paths["rung5.graphml"], "--max-nodes", "256",
                  "--max-edges", "384", "--service", paths["mixed.yaml"],
                  "--agent-config", paths["rung5.yaml"],
                  "--simulator-config", paths["sim.yaml"], "--replicas", "2",
                  "--chunk", "20", "--episodes", "1"])
        add(counts)
        laps.lap("(f) rung5")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for name, run in runs.items():
        print(f"phase 14 {name} on {smi}: rollout {run['sps']:.1f} "
              f"env-steps/s, learn bursts "
              f"{[round(t, 3) for t in run['bursts']]} s, evaluation "
              f"compile_warmup_s {run['summary']['compile_warmup_s']} "
              f"steady_s {run['summary']['steady_s']}", flush=True)
    print("phase 14 launches (each count 0 before its run): "
          + json.dumps(launches))
    print("phase 14 parts, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in laps.seconds.items()), flush=True)
    return launches, att_times, sub_times, errs, sub_err


def ledger_burst_profile(torch, trainer, state, buffer):
    """``LEDGER_PROFILE_STEPS`` gradient steps of ``trainer``'s learner
    (its ledger as configured) under ``torch.profiler``: kernel launches
    per gradient step and device ms per step.  Updates ``state``."""
    from torch.profiler import ProfilerActivity, profile

    from gsc_tpu_torch.agents.buffer import buffer_sample

    ddpg, n = trainer.ddpg, LEDGER_PROFILE_STEPS
    sample = lambda: buffer_sample(buffer, trainer.draws,
                                   trainer.agent_cfg.batch_size)
    ddpg.learn_burst(state, sample, steps=1)       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = ddpg.learn_burst(state, sample, steps=n)
        float(m["state_finite"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    return {"launches": sum(e.count for e in ka if e.key in (
                "cudaLaunchKernel", "cuLaunchKernel",
                "cudaLaunchKernelExC")) / n,
            "device_ms": sum(dev_us(e) for e in ka) / 1e3 / n,
            "wall_ms": 1e3 * wall / n}


def default_run_slice(torch, dev, smi):
    """Phase 15: the default ``cli train`` run (pipeline, observer, learn
    ledger, rollback) on phase 13's schedule at the flagship widths,
    episodes cut to ``DEFAULT_RUN_STEPS`` steps: (a) 2 episodes with the
    defaults against the same 2 with ``--no-pipeline --no-learn-obs``,
    ``torch.equal`` on every state, replay and random-source tensor,
    burst seconds and launches per gradient step of both; (b) a fault
    plan's recoveries; (c) one bf16 episode; (d) the run's artefacts and
    ``tools/obs_report.py``; (e) ``cli simulate`` on the card and on the
    CPU.  Returns the kernels' launches summed over the runs (each count 0
    before its run) and the phase's numbers."""
    import math

    from gsc_tpu_torch import cli
    from gsc_tpu_torch.agents.ddpg import DDPG
    from gsc_tpu_torch.ops.gat_attention import (gat_attention,
                                                 gat_attention_backward,
                                                 gat_attention_backward_bf16,
                                                 gat_attention_bf16)
    from gsc_tpu_torch.ops.substep import substep_megakernel
    from gsc_tpu_torch.resilience.guard import all_finite

    ops = {"gat_attention": gat_attention,
           "gat_attention_backward": gat_attention_backward,
           "gat_attention_bf16": gat_attention_bf16,
           "gat_attention_backward_bf16": gat_attention_backward_bf16,
           "substep_megakernel": substep_megakernel}
    total = {k: 0 for k in ops}
    root = tempfile.mkdtemp(prefix="gsc_default_run_")
    laps = Laps()
    bursts = []
    saved = DDPG.learn_burst

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = saved(*a, **k)
        torch.cuda.synchronize()
        bursts.append(time.perf_counter() - t0)
        return res

    def counted_run(argv):
        """``cli.run_train(argv)`` with every count 0 before it; returns
        the run and its counts (added to the phase's)."""
        for op in ops.values():
            op.launches = 0
        res = cli.run_train(argv)
        counts = {k: op.launches for k, op in ops.items()}
        for k, n in counts.items():
            total[k] += n
        return res, counts

    try:
        cfg = os.path.join(root, "cfg")
        cli.init_configs(cfg)
        nets = os.path.join(cfg, "networks")
        sched = os.path.join(root, "scheduler.yaml")
        with open(sched, "w") as f:
            f.write("training_network_files:\n"
                    f"  - {nets}/abilene-in4.graphml\n"
                    f"  - {nets}/claranet-in4-cap1.graphml\n"
                    f"inference_network: {nets}/compuserve-in4-cap1.graphml\n"
                    f"period: {GEN_PERIOD}\n")
        agent_yaml = os.path.join(root, "agent.yaml")
        with open(os.path.join(cfg, "agent.yaml")) as f:
            text = f.read()
        with open(agent_yaml, "w") as f:
            f.write(text.replace("episode_steps: 200",
                                 f"episode_steps: {DEFAULT_RUN_STEPS}")
                    .replace("nb_steps_warmup_critic: 200",
                             f"nb_steps_warmup_critic: {DEFAULT_RUN_STEPS}")
                    + "gnn_impl: pallas\n")
        base = ["--scheduler", sched, "--seed", "0", "--agent-config",
                agent_yaml, "--simulator-config",
                os.path.join(cfg, "simulator.yaml"), "--service",
                os.path.join(cfg, "service_abc.yaml")]
        laps.lap("setup")

        # (a) the defaults against the serial, ledger-free run
        DDPG.learn_burst = timed
        try:
            run_dir = os.path.join(root, "a")
            res_a, counts_a = counted_run(base + ["--episodes", "2",
                                                  "--result-dir", run_dir])
            bursts_on = list(bursts)
            bursts.clear()
            laps.lap("a defaults")
            res_s, counts_s = counted_run(base + [
                "--episodes", "2", "--no-pipeline", "--no-learn-obs",
                "--result-dir", os.path.join(root, "s")])
            bursts_off = list(bursts)
            bursts.clear()
        finally:
            DDPG.learn_burst = saved
        laps.lap("a serial")
        want = learner_tensors(res_s["state"], res_s["buffers"],
                               res_s["trainer"].draws)
        got = learner_tensors(res_a["state"], res_a["buffers"],
                              res_a["trainer"].draws)
        check(set(got) == set(want), "pipelined and serial runs hold "
              "different tensors")
        differ = [k for k, v in want.items()
                  if got[k].dtype != v.dtype or not torch.equal(got[k], v)]
        check(not differ, f"pipeline+ledger != serial on {len(differ)} of "
              f"{len(want)} tensors: {differ[:6]}")
        check(counts_a == counts_s, f"launches differ: defaults {counts_a}, "
              f"serial {counts_s}")
        check(res_a["trainer"].learn_obs is not None
              and res_s["trainer"].learn_obs is None,
              "the ledger was not on in the default run only")
        prof_on = ledger_burst_profile(torch, res_a["trainer"],
                                       res_a["state"], res_a["buffers"])
        prof_off = ledger_burst_profile(torch, res_s["trainer"],
                                        res_s["state"], res_s["buffers"])
        laps.lap("a profile")

        # (d) the default run's artefacts
        for name in ("events.jsonl", "metrics.json", "series.json",
                     "curves.json", "result.yaml", "run.log"):
            check(os.path.isfile(os.path.join(run_dir, name)),
                  f"the default run wrote no {name}")
        with open(os.path.join(run_dir, "events.jsonl")) as f:
            kinds = [json.loads(line)["event"] for line in f]
        for kind in ("run_start", "precision", "episode", "learn_signal",
                     "eval_episode", "run_end"):
            check(kind in kinds, f"no {kind} event in the default run")
        with open(os.path.join(run_dir, "metrics.json")) as f:
            metrics = json.load(f)["metrics"]
        gauges = {k: v for k, v in metrics.items()
                  if k.startswith("gsc_device_")}
        check(gauges and all(v > 0 for v in gauges.values()),
              f"device gauges {gauges}")
        rep = subprocess.run([sys.executable, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tools",
            "obs_report.py"), run_dir], capture_output=True, text=True,
            timeout=120)
        check(rep.returncode == 0, f"obs_report exited {rep.returncode}: "
              f"{rep.stderr[-2000:]}")
        laps.lap("d artefacts")

        # (b) a fault plan: a retried dispatch and a rollback
        res_b, counts_b = counted_run(base + [
            "--episodes", "3", "--fault-plan", DEFAULT_RUN_PLAN,
            "--result-dir", os.path.join(root, "b")])
        with open(os.path.join(root, "b", "events.jsonl")) as f:
            rec = [json.loads(line) for line in f]
        got_rec = [(e["site"], e["action"], e["episode"]) for e in rec
                   if e["event"] == "recovery"]
        check(got_rec == DEFAULT_RUN_RECOVERIES,
              f"recoveries {got_rec}, want {DEFAULT_RUN_RECOVERIES}")
        check(float(all_finite(res_b["state"])) == 1.0
              and math.isfinite(res_b["eval"]["mean_return"]),
              "the fault-plan run did not end finite")
        laps.lap("b faults")

        # (c) one bf16 episode under the defaults
        res_c, counts_c = counted_run(base + [
            "--episodes", "1", "--precision", "bf16",
            "--result-dir", os.path.join(root, "c")])
        check(counts_c["gat_attention_bf16"] > 0
              and counts_c["gat_attention_backward_bf16"] > 0
              and counts_c["gat_attention"] == 0
              and counts_c["gat_attention_backward"] == 0,
              f"bf16 run launches {counts_c}")
        check(math.isfinite(res_c["trainer"].history[-1]["critic_loss"]),
              "bf16 run's loss is not finite")
        laps.lap("c bf16")

        # (e) simulate on the card and on the CPU
        sim_args = ["-d", "500", "-n", os.path.join(nets,
                                                    "abilene-in4.graphml"),
                    "-sf", os.path.join(cfg, "service_abc.yaml"), "-c",
                    os.path.join(cfg, "simulator.yaml")]
        for op in ops.values():
            op.launches = 0
        t0 = time.perf_counter()
        on_card = cli.run_simulate(sim_args)
        sim_card_s = time.perf_counter() - t0
        sim_launches = substep_megakernel.launches
        total["substep_megakernel"] += sim_launches
        on_cpu = cli.run_simulate(sim_args + ["--device", "cpu"])
        check(substep_megakernel.launches == sim_launches,
              "the CPU simulate launched the kernel")
        check(sim_launches == 5, f"simulate launched the megakernel "
              f"{sim_launches} times for 5 intervals")
        for k in ("total_flows", "successful_flows", "dropped_flows",
                  "drop_reasons"):
            check(on_card[k] == on_cpu[k], f"simulate {k}: card "
                  f"{on_card[k]}, cpu {on_cpu[k]}")
        check(on_card["total_flows"] > 0 and math.isclose(
            on_card["avg_end2end_delay"], on_cpu["avg_end2end_delay"],
            rel_tol=SUB_RTOL, abs_tol=SUB_ATOL),
            f"simulate delay: card {on_card}, cpu {on_cpu}")
        laps.lap("e simulate")
    finally:
        DDPG.learn_burst = saved
        shutil.rmtree(root, ignore_errors=True)

    ps = laps.seconds
    print(f"default run: 2 episodes x {DEFAULT_RUN_STEPS} steps with the "
          "defaults (pipeline, observer, learn ledger, rollback) and with "
          f"--no-pipeline --no-learn-obs: torch.equal on all {len(want)} "
          "tensors; returns "
          f"{[round(r['episodic_return'], 4) for r in res_a['trainer'].history]}",
          flush=True)
    print(f"default run learn bursts on {smi}: ledger on "
          f"{[round(t, 3) for t in bursts_on]} s, off "
          f"{[round(t, 3) for t in bursts_off]} s; per gradient step "
          f"(profiled, {LEDGER_PROFILE_STEPS} steps): ledger on "
          f"{prof_on['launches']:.1f} launches, {prof_on['wall_ms']:.3f} ms "
          f"wall, {prof_on['device_ms']:.3f} ms device; off "
          f"{prof_off['launches']:.1f} launches, {prof_off['wall_ms']:.3f} "
          f"ms wall, {prof_off['device_ms']:.3f} ms device", flush=True)
    print(f"default run fault plan {DEFAULT_RUN_PLAN!r}: recoveries "
          f"{got_rec}; final state finite; bf16 episode launches {counts_c}",
          flush=True)
    print(f"default run simulate -d 500 on Abilene: card {json.dumps(on_card)} "
          f"({sim_launches} megakernel launches, {sim_card_s:.3f} s), cpu "
          f"{json.dumps(on_cpu)}", flush=True)
    print("default run launches (each count 0 before its run): "
          + json.dumps(total), flush=True)
    print("phase 15 parts, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ps.items())
          + f"; phase 15 {sum(ps.values()):.3f}", flush=True)
    return total, {"bursts_on": bursts_on, "bursts_off": bursts_off,
                   "prof_on": prof_on, "prof_off": prof_off}


def main() -> int:
    import torch

    t_start = time.perf_counter()
    phases = Laps()
    # ---- 1. device -----------------------------------------------------
    check(torch.cuda.is_available(), "CUDA is not available")
    from gsc_tpu_torch.device import resolve_device
    from gsc_tpu_torch.models.nets import Actor
    from gsc_tpu_torch.ops.gat_attention import (BACKWARD_SOURCE, SOURCE,
                                                 GatAttention,
                                                 GatAttentionBackward,
                                                 gat_attention,
                                                 gat_attention_backward,
                                                 gat_attention_backward_bf16,
                                                 gat_attention_bf16)
    from gsc_tpu_torch.ops.build import MAX_SMEM_BYTES
    from gsc_tpu_torch.ops.substep import SOURCE as SUB_SOURCE
    from gsc_tpu_torch.ops.substep import (SubstepMegakernel,
                                           substep_megakernel)
    from gsc_tpu_torch.serve import run_serve
    from gsc_tpu_torch.sim import cases

    dev = resolve_device()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"device: {name} (x{count}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    phases.lap("1")
    # ---- 2. build ------------------------------------------------------
    clocked = SubstepMegakernel(stage_clocks=True)
    clocked_fwd = GatAttention(stage_clocks=True)
    clocked_bwd = GatAttentionBackward(stage_clocks=True)
    parent = parent_megakernel()
    parent_att = parent_gat()
    ops = {"gat_attention": gat_attention,
           "gat_attention_backward": gat_attention_backward,
           "gat_attention_bf16": gat_attention_bf16,
           "gat_attention_backward_bf16": gat_attention_backward_bf16,
           "substep_megakernel": substep_megakernel,
           "substep_megakernel (stage clocks)": clocked,
           "gat_attention (stage clocks)": clocked_fwd,
           "gat_attention_backward (stage clocks)": clocked_bwd}
    if parent is not None:
        ops["substep_megakernel (parent)"] = parent
    if parent_att is not None:
        ops["gat_attention (parent)"] = parent_att[0]
        if parent_att[1] is not None:
            ops["gat_attention_backward (parent)"] = parent_att[1]
            ops["gat_attention_backward (parent, stage clocks)"] = \
                parent_att[3]
    built = build_kernels(ops)
    print("build: " + ", ".join(f"{k} {v:.2f} s" for k, v in built.items()),
          flush=True)
    for key, op in ops.items():
        for line in op.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {key}: {line.strip()}")
    from gsc_tpu_torch.config import abc_service, mixed_service
    from gsc_tpu_torch.config.schema import EnvLimits
    for m_slots, lim, net in (
            (128, None, "Abilene (N=24, E=37, P=3)"),
            (1024, None, "Abilene (N=24, E=37, P=3)"),
            (1024, EnvLimits.for_service(abc_service(), 128, 192),
             "interroute (N=128, E=192, P=3)"),
            (1024, EnvLimits.for_service(mixed_service(), 256, 384),
             "rung 5 (N=256, E=384, C=2, P=5)")):
        smem = megakernel_smem_bytes(substep_megakernel, m_slots, lim)
        print(f"  megakernel shared memory per CTA at M={m_slots}, {net}: "
              f"{smem} bytes", flush=True)
        check(smem <= MAX_SMEM_BYTES, f"M={m_slots} on {net} needs {smem} "
              "bytes of shared memory")
    for n in (24, 128, 256):
        fwd = [gat_attention._smem_bytes(gat_attention.library(), n, 22),
               gat_attention_bf16._smem_bytes(gat_attention.library(), n,
                                              22)]
        bwd = [op._smem_bytes(op.library(), n, 22)
               for op in (gat_attention_backward,
                          gat_attention_backward_bf16)]
        print(f"  attention shared memory per CTA at N={n}, F=22 (f32, "
              f"bf16): forward {fwd}, backward {bwd} bytes; "
              f"{gat_attention_backward.library().gat_attention_backward_tiles(n)}"
              " CTAs per graph", flush=True)

    phases.lap("2")
    # ---- 3. attention kernels vs plain on the card ----------------------
    timings, max_err, bwd_timings, bwd_err = attention_phase(torch, dev, smi,
                                                             parent_att)
    attention_stage_clocks(clocked_fwd, clocked_bwd, torch, dev,
                           parent_att[3] if parent_att else None)

    phases.lap("3")
    # ---- 4. the slice: run_serve on the card ----------------------------
    gat_attention.launches = 0
    substep_megakernel.launches = 0
    reports, serve_wall = [], []
    for r, c, deadline in BURSTS:
        t0 = time.perf_counter()
        reports.append(run_serve(device=dev, pool_steps=POOL_STEPS,
                                 requests=r, concurrency=c, buckets=BUCKETS,
                                 deadline_ms=deadline, seed=0))
        serve_wall.append(time.perf_counter() - t0)
    launches = gat_attention.launches
    pool_launches = substep_megakernel.launches
    calls = sum(len(rep.flushes) + len(rep.startup["buckets"])
                for rep in reports)
    check(launches == 3 * calls,
          f"{launches} kernel launches for {calls} dispatches and warm-up "
          "calls (want 3 per call)")
    check(pool_launches == POOL_STEPS * len(BURSTS),
          f"{pool_launches} megakernel launches for {len(BURSTS)} request "
          f"pools of {POOL_STEPS} env steps (want 1 per step)")
    served = set()
    for (r, c, deadline), report in zip(BURSTS, reports):
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
              f"deadline {deadline:g} ms, "
              f"{summ['dispatches']} dispatches (buckets {used}); "
              f"{summ['requests_per_s']:.1f} req/s, p50 {summ['p50_ms']:.3f} ms, "
              f"p99 {summ['p99_ms']:.3f} ms, startup {summ['startup_s']:.2f} s on "
              f"{smi}; answers vs unbatched and plain actor max abs diff "
              f"{worst:.2e} ({ambiguous} ambiguous rows)", flush=True)
        print(f"serve_summary c={c}: " + json.dumps(summ))
    check(served == set(BUCKETS),
          f"buckets {sorted(set(BUCKETS) - served)} served no request")
    print(f"serve: {sum(b[0] for b in BURSTS)} requests through buckets "
          f"{sorted(served)}, {launches} attention kernel launches; "
          f"{pool_launches} megakernel launches building the request pools; "
          f"run_serve wall {[round(w, 3) for w in serve_wall]} s (pool, "
          f"start-up and requests)", flush=True)
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

    phases.lap("4")
    # ---- 5. megakernel vs plain on the card ------------------------------
    print(f"megakernel vs plain (rtol {SUB_RTOL}, atol {SUB_ATOL}; integers "
          f"exact) on {smi}:", flush=True)
    sub_err = substep_battery(torch, dev)

    phases.lap("5")
    # ---- 6. golden trajectory on the kernel path -------------------------
    before = substep_megakernel.launches
    golden = cases.check_golden(cases.run_case(cases.golden_case(), dev)[-1])
    check(substep_megakernel.launches - before == 20,
          "the golden run did not launch the megakernel once per interval")
    print(f"golden Abilene on the kernel path: {json.dumps(golden)}",
          flush=True)

    phases.lap("6")
    # ---- 7. megakernel timings ------------------------------------------
    print("megakernel timings:", flush=True)
    sub_times = substep_timings(torch, dev, smi, clocked, parent)

    phases.lap("7")
    # ---- 8. the training slice -------------------------------------------
    train_launches, f32_train = train_slice(torch, dev, smi)
    for kernel, n in train_launches.items():
        check(n > 0, f"{kernel} was not launched on the training path")

    phases.lap("8")
    # ---- 9. bf16 attention kernels vs plain on the card ------------------
    h_timings, h_err, hb_timings, hb_err = attention_phase_bf16(
        torch, dev, smi, parent_att[2] if parent_att else None)

    phases.lap("9")
    # ---- 10. the bf16 training slice, saving a checkpoint ----------------
    ck_root = tempfile.mkdtemp(prefix="gsc_bf16_ck_")
    try:
        ck = os.path.join(ck_root, "checkpoint")
        bf16_launches, bf16_train = train_slice(torch, dev, smi, "bf16",
                                                checkpoint=ck)
        for kernel, n in bf16_launches.items():
            check(n > 0, f"{kernel} was not launched on the bf16 training "
                  "path")
        print(f"train bf16 beside f32 on {smi}: rollout "
              f"{bf16_train['sps']:.1f} env-steps/s (f32 "
              f"{f32_train['sps']:.1f}); learn bursts "
              f"{[round(t, 3) for t in bf16_train['bursts']]} s (f32 "
              f"{[round(t, 3) for t in f32_train['bursts']]} s)", flush=True)

        # ---- 11. bf16 serving from that checkpoint -----------------------
        serve_bf16 = serve_from_checkpoint(torch, dev, smi, ck)
        print(f"serve bf16: {serve_bf16} bf16 attention launches, 0 f32",
              flush=True)
    finally:
        shutil.rmtree(ck_root, ignore_errors=True)

    phases.lap("10-11")

    # ---- 13. the generalization slice ------------------------------------
    gen_launches, gen_train = generalization_slice(torch, dev, smi)
    phases.lap("13")
    for kernel, n in gen_launches.items():
        check(n > 0, f"{kernel} was not launched on the single-env path")
    print(f"train single-env beside B=64 on {smi}: rollout "
          f"{gen_train['sps']:.1f} env-steps/s (B=64: "
          f"{f32_train['sps']:.1f}); learn bursts "
          f"{[round(t, 3) for t in gen_train['bursts']]} s (B=64: "
          f"{[round(t, 3) for t in f32_train['bursts']]} s)", flush=True)
    # ---- 14. bench.py's interroute and rung-5 stacks --------------------
    (large_launches, large_att, large_sub, large_errs,
     large_sub_err) = large_network_slice(
         torch, dev, smi, parent_att[1:3] if parent_att else None)
    phases.lap("14")
    for kernel in ("gat_attention", "gat_attention_backward",
                   "gat_attention_bf16", "gat_attention_backward_bf16",
                   "substep_megakernel"):
        check(large_launches.get(kernel, 0) > 0,
              f"{kernel} was not launched on the large networks' path")
    # ---- 15. the default train run ---------------------------------------
    run_launches, _ = default_run_slice(torch, dev, smi)
    phases.lap("15")
    for kernel, n in run_launches.items():
        check(n > 0, f"{kernel} was not launched on the default run's path")
    path_launches = {k: train_launches.get(k, 0) + bf16_launches.get(k, 0)
                     + gen_launches.get(k, 0) + large_launches.get(k, 0)
                     + run_launches.get(k, 0)
                     for k in ("gat_attention", "gat_attention_backward",
                               "gat_attention_bf16",
                               "gat_attention_backward_bf16",
                               "substep_megakernel")}
    max_err = max(max_err, large_errs["gat_attention"])
    bwd_err = max(bwd_err, large_errs["gat_attention_backward"])
    h_err = max(h_err, large_errs["gat_attention_bf16"])
    hb_err = max(hb_err, large_errs["gat_attention_backward_bf16"])
    sub_err = max(sub_err, large_sub_err)

    # ---- 12. kernels line -----------------------------------------------
    ms, plain_ms, bound_ms, bound_by = timings[MAIN_SHAPE]
    b_ms, b_plain_ms, b_bound_ms, b_bound_by = bwd_timings[MAIN_SHAPE]
    s_ms, _, s_plain_ms, s_bound_ms, s_bound_by = sub_times[SUB_MAIN_BATCH]
    h_ms, h_plain_ms, h_bound_ms, h_bound_by = h_timings[MAIN_SHAPE]
    hb_ms, hb_plain_ms, hb_bound_ms, hb_bound_by = hb_timings[MAIN_SHAPE]
    rel = lambda src: str(src.relative_to(src.parents[2]))
    kernels = {"kernels": [{
        "name": "gat_attention",
        "route": "cuda",
        "source": rel(SOURCE),
        "replaces": "gsc_tpu/ops/pallas_gat.py:45",
        "launches": path_launches["gat_attention"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "gat_attention_backward",
        "route": "cuda",
        "source": rel(BACKWARD_SOURCE),
        "replaces": "gsc_tpu/ops/pallas_gat.py:150",
        "launches": path_launches["gat_attention_backward"],
        "max_abs_err": bwd_err,
        "ms": b_ms,
        "plain_ms": b_plain_ms,
        "bound_ms": b_bound_ms,
        "bound_by": b_bound_by,
        "library_ms": None,
    }, {
        "name": "gat_attention_bf16",
        "route": "cuda",
        "source": rel(SOURCE),
        "replaces": "gsc_tpu/ops/pallas_gat.py:45",
        "launches": path_launches["gat_attention_bf16"],
        "max_abs_err": h_err,
        "ms": h_ms,
        "plain_ms": h_plain_ms,
        "bound_ms": h_bound_ms,
        "bound_by": h_bound_by,
        "library_ms": None,
    }, {
        "name": "gat_attention_backward_bf16",
        "route": "cuda",
        "source": rel(BACKWARD_SOURCE),
        "replaces": "gsc_tpu/ops/pallas_gat.py:150",
        "launches": path_launches["gat_attention_backward_bf16"],
        "max_abs_err": hb_err,
        "ms": hb_ms,
        "plain_ms": hb_plain_ms,
        "bound_ms": hb_bound_ms,
        "bound_by": hb_bound_by,
        "library_ms": None,
    }, {
        "name": "substep_megakernel",
        "route": "cuda",
        "source": rel(SUB_SOURCE),
        "replaces": "gsc_tpu/ops/pallas_substep.py:530",
        "launches": path_launches["substep_megakernel"],
        "max_abs_err": max(sub_err, gen_train["max_abs_err"]),
        "ms": s_ms,
        "plain_ms": s_plain_ms,
        "bound_ms": s_bound_ms,
        "bound_by": s_bound_by,
        "library_ms": None,
    }]}
    print("phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.seconds.items()), flush=True)
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
