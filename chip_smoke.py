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
   and, on the cases of PLAIN_ON_CARD_CASES (the plain version on the card
   costs seconds per case; the other cases compare on CPU
   copies only, for the time limit), within the tolerance below of the
   plain version on the card (each side's distance is printed); two
   launches on the same inputs must be
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
   prints the rollout's env-steps/s and each learn burst's seconds; the
   run saves the f32 checkpoint that phase 17 serves;
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
12. (printed after phase 25) a JSON line
   of the kernels (name, route, source, the TPU kernel it replaces,
   launches summed over the runs of phases 8, 10, 13-25, max abs
   error, ms, plain ms, bound ms and what bounds it, library ms);
13. the generalization slice, the reference's own training path at the
   flagship widths: ``cli.init_configs`` writes the yaml set and the
   GraphML networks with the port's writer (bteurope-in2 must read back
   as 24 nodes, 37 edges and caps in 1-2); ``cli.run_train --scheduler
   --replicas 1`` trains one env for GEN_EPISODES episodes (2, for the
   time limit) on a schedule of
   abilene-in4 and claranet-in4-cap1 switching every episode, each
   episode ending in a 200-step learn burst, and evaluates greedily on
   compuserve-in4-cap1, which no episode trained on.  With every count 0
   before it: the megakernel once per env and evaluation step (at B=1),
   the attention kernel 3 times per acting and evaluation step at B=1 and
   15 times per gradient step at B=100, its backward 6 times per gradient
   step, no bf16 kernel; returns and losses finite, every parameter
   moved, the replay's ``topo_idx`` naming each episode's network, the
   checkpoint's sidecar its episode count.  Then GEN_EPISODES - 1
   episodes, a checkpoint and ``--resume`` to GEN_EPISODES must give the
   straight run's tensors
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
   at 8 replicas for one f32 episode with a checkpoint and (d) one bf16
   episode, with phase 8's checks (launch counts per step, every
   parameter moved, replay fill, gradients through the kernels against
   the dense path or the plain versions); (e) ``run_serve`` of 16
   requests at concurrency 4 from the f32 checkpoint's factored actor,
   answers against unbatched calls and the plain actor; (f)
   ``cli.run_train`` on rung 5 (``random_network(200, num_ingress=8,
   seed=11)`` through GraphML, padded to 256 / 384, the mixed catalog,
   ``mem_limit`` 1024) at 2 replicas for one 20-step episode and burst;
   (g) (f)'s run again with ``--perf`` (``rung5_ledger_memory``; its
   ``--no-perf`` twin gave way to the time limit): the peak
   allocated device bytes, the cost ledger's held inputs settled
   mid-call, every entry whole.
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
16. generalization training (``generalization_training_slice``): (a)
   the megakernel on ``cases.generalization_cases()`` (a mixed batch of
   five networks at B=8, a link and a node zeroed from interval 1, 16
   scenario-factory draws with shapes and faults) against its plain
   version, bit for bit on CPU copies, 0 serial rounds, relaunch
   bit-identical, and its device time per interval on a mixed B=64 batch
   in turns with homogeneous Abilene at B=64; (b) the attention kernel
   and its backward on a mixed batch of graphs with 4-24 real nodes at
   (100, 24, 22) within phase 3's tolerances; (c) ``DeviceTraffic`` on the
   card bit-equal to the host generator on the init-configs traffic over
   Abilene (200 intervals), and one ``sample_batch`` and one factory
   draw at B=64: wall ms and kernel launches; (d) ``cli.run_train`` at
   B=64 for 2 episodes of GEN_MIX_STEPS steps (the first all warm-up)
   under ``GEN_REGISTRY_MIX`` and (e) under
   ``GEN_FACTORY_MIX`` with the TD curriculum, each with phase 8's checks
   (15 forward and 6 backward attention launches per gradient step, one
   megakernel launch per env step, every parameter moved, finite losses,
   gradients through the kernels against the dense path), the replay's
   per-replica ``topo_idx`` (the replica's mix entry; factory families),
   per-entry returns, curriculum weights summing to 1 with every family
   at or above floor/K; (f) one B=64 and one single-env episode of
   GEN_MIX_STEPS steps with ``shuffle_nodes: true`` (launch counts
   checked).  Prints each part's
   seconds, (d) and (e)'s env-steps/s and burst seconds beside the card's
   name and power limit; the kernels line's launch counts include this
   phase's;
17. serving, whole (``serving_slice``), at the flagship serving widths
   (Abilene at 24/37, the abc chain, GATv2 22x2x2, actor hidden 256,
   M = 128, buckets 1, 4, 8): (a) ``cli serve`` without a checkpoint
   serves the SPR tier, every answer equal to ``spr_schedule_action``,
   the pool's megakernel launches and no attention launch; (b) a fleet of
   two continuous workers, FLEET_REQUESTS requests at concurrency
   SERVE_CONCURRENCY, from phase 8's f32 checkpoint and from phase 10's
   bf16 one: every answer bit-identical to ``greedy_action`` at its
   bucket, 3 attention launches per dispatch and warm-up call, kernel #1
   on the served batches against its plain version within phase 3's
   (f32) and phase 9's (bf16) tolerances; (c) train-while-serve:
   ``cli train --replicas 64 --hot-swap-dir`` for TWS_EPISODES episodes
   of TWS_STEPS steps (warm-up TWS_WARMUP), publishing every episode,
   while a two-worker fleet
   watching that directory serves closed-loop load: zero errors and
   rejections, every version adopted once by each worker, every answer
   bit-identical to a single-shot call at its bucket under the weights of
   its stamped version, p50/p99 before and while training, each swap's
   ``swap_ms``; (d) ``cli serve --trace-sample 1 --slo-p99-ms 10``:
   ``slo.json``, each span's decomposition within 1e-2 ms of its latency,
   the exported trace valid, and the device-to-host copies per flush
   (``torch.profiler``) equal with tracing on and off; (e) a fleet with a
   queue bound of 1 overloaded into overflow: every shed request answered
   by the SPR tier and counted in ``serve_brownout_total``.  Prints each
   part's numbers beside the card's name and power limit; the kernels
   line's launch counts include this phase's;
18. per-flow control (``perflow_slice``): (a) the megakernel's
   per-flow mode (external decisions, place-on-decision, the
   ``vnf_timeout`` expiry; one launch per substep) against its plain
   version, every leaf bit for bit on CPU copies of the inputs, over
   ``cases.perflow_cases()``: the local policy on line3-egress under
   tests/assets/perflow_config.yaml (which must also meet the
   reference's frozen numbers: generated 201 +- 2, processed 197,
   dropped 0, average end-to-end delay 35.0), random decisions with
   about a third parked on Abilene at B=64 across two interval
   boundaries, the expiry at ``vnf_timeout`` 30 (placed, then gone), a
   link-fault timeline and stochastic processing delays; and a
   duration-style ``apply`` under a per-flow config (the expiry without
   decisions); (b) 100 one-substep launches bit-equal to one 100-substep
   launch in duration mode at B = 1 and 64; (c) ``cli.run_simulate -d
   300`` on Abilene under the duration controller and under per-flow
   control with ``--per-flow-algo local`` and ``spr``, each on the card
   (one per-flow launch per substep) and on the CPU (no launch):
   integers equal, the mean delay within SUB_RTOL, three different
   outcomes, each per-flow run processing more than it drops, and
   ``spr`` under the duration controller refused; (d) one single-env
   episode of PREDICTION_STEPS steps under ``prediction: true`` on phase
   13's schedule, every observation's ingress column equal to
   ``predict_ingress_traffic``, and a ``DummyEngine`` env step on the
   card; (e) at B = 1 and 64 a per-flow interval's wall and device time,
   kernel launches and device idle share, one per-flow launch's device
   time against its bound and the plain substep, and the duration
   interval's times, beside the card's name and power limit; the kernels
   line lists the per-flow mode as ``substep_megakernel_perflow`` with
   its launches from (c);
19. resource-function plugins (``plugin_slice``), under two sets:
   ``cases.PLUGINS`` (a quadratic, a capped ``where``, a square root
   with a division) and ``cases.MATH_PLUGINS`` (a saturating tanh, a
   log1p overhead, ``** 1.5`` behind a where: the double forms of
   ``csrc/rf_math.cuh``): (a) both builds of kernel #2 with their
   generated headers (built in phase 2 beside the other kernels), their
   nvcc seconds and ptxas registers and spills beside the build without
   plugins (and the parent's), and the header's functions on the card
   (the probe kernel ``csrc/rf_math_probe.cu``) bit for bit against
   ``ops/rf_math.py`` over a grid of f32 loads; (b) each build over the
   battery (``cases.all_cases`` with Abilene at B =
   PLUGIN_ABILENE_BATCH) and over the per-flow cases (cut to
   PLUGIN_PERFLOW_SUBSTEPS substeps: the kPerFlow instantiation), every
   leaf bit for bit against the plain version on CPU copies; (c) a
   plugin that does not trace refused on the card, saying so, and never
   called on a tensor; (d) device time per interval at B=64 in 10
   alternating pairs without plugins against ``PLUGINS`` and
   ``PLUGINS`` against ``MATH_PLUGINS``, the plain engine and the
   bounds; (e) where ``_parent/substep_megakernel.cu`` exists, the build
   without plugins against it in 10 alternating pairs at B = 1, 64, 256
   (device medians, the same interval bit for bit); (f) ``cli simulate
   -d PLUGIN_SIM_MS`` and ``cli train`` (PLUGIN_TRAIN_ARGS, episodes of
   PLUGIN_EPISODE_STEPS) with ``--resource-functions-path`` and a
   service yaml naming each set's files (PLUGIN_FILES,
   MATH_PLUGIN_FILES), on the card (one plugin launch per interval and
   env step, none of the build without plugins) and on the CPU:
   simulate's integers equal and its mean delay within SUB_RTOL; the
   training runs' episodes, replay sizes and cursors equal (their random
   draws differ between the devices).  The kernels line lists the two
   plugin builds as ``substep_megakernel_plugin`` and
   ``substep_megakernel_plugin_math`` with their launches from (f);
20. decoupled actor/learner training (``async_slice``) at B=64 over
   ASYNC_ARGS (3 episodes of ASYNC_STEPS steps, the first all warm-up;
   the init-configs agent otherwise): (a) ``cli train`` (the
   synchronous ``train_parallel``) and ``cli train --async`` with 2
   actor threads (each on its own CUDA stream; ``--max-staleness``
   ASYNC_STALENESS), each with phase 8's launch counts per env step and
   gradient step; under ``--async`` produced == ingested steps, no
   transition lost, one burst per episode, at least one publish adopted
   by an actor; prints env-steps/s, bursts/s, the idle fractions, the
   largest policy lag and the final-window return and mean return of
   each run beside the card's name and power limit; (b) one actor with
   publishing frozen (``--publish-bursts 1000000``), exploration noise
   on, ASYNC_FROZEN_EPISODES episodes, twice: both replays
   bit-identical (``--learn-ratio 0.5``: one burst, which the replay
   does not depend on); phase 25 (a) reruns it on two ranks; (c)
   ``--fault-plan ASYNC_FAULT_PLAN``: an actor restart and a quarantined
   block, nothing lost, a finite final state;
21. the mesh on the card (``mesh_slice``): ``train --replicas 64 --mesh
   DPxMP`` at the flagship widths on Abilene, 50-step episodes
   (``MESH_AGENT_YAML``), the ``sharded`` book unless named.  (a) one
   episode with ``--mesh 1x1`` (NCCL, world 1), MESH_ONE_RUNS times in
   one rank process (the first run cold, the later ones warm), and once
   without a mesh: learner state and replay ``torch.equal``, the
   env-steps/s of each run printed; (b) 4 ranks, then 2, sharing the
   card (``devices=["cuda:0"] * n``, gloo), one episode within the 200
   warm-up steps: 2x2, then 2x1, 1x2 (sharded and replicated), each
   final learner state ``torch.equal`` to (a)'s run without a mesh, the
   leaves split by each mp > 1 leg printed (> 0); (c) warm-up 50 steps,
   2 episodes (the warm-up episode and one more, each ending in a learn
   burst): 4x1 equals 2x2, the largest difference to
   the run without a mesh printed, beside a witness of its cause
   (``acting_rows_witness``: the actor on the 64 acting rows of one step
   against the same rows in 2 slices of 32 and 4 of 16, the row counts
   the ranks act on); (d) elastic resume: (b)'s 2x2 leg checkpoints
   every episode, ``--resume auto`` continues it under 2x1 and, from the
   same checkpoint, with no mesh: episodes 1 and 2 in both,
   ``run_start`` recording the new mesh; (e) with two or
   more cards 2x1 and 1x2 again on NCCL, one card per rank (4x1 and 2x2
   with four), ``torch.equal`` to (b), else one line saying it did not
   run; (f) a rank raising through the launcher's hook fails the launch
   within its deadline and leaves no rank running; (g) the cost ledger
   on a mesh: first in (b)'s 2-rank processes, 2x1 with ``--perf``,
   warm-up 50 steps, 2 episodes, rank 0's ``perf.json`` held as phase
   22 holds its own (``check_perf_doc``) with ``chunk_step_sharded``'s
   collectives > 0.  Prints per leg the
   env-steps/s, the seconds per learn burst, the batch gather's ms per
   gradient step, the ranks' start-up seconds and each rank's launches
   (every rank must launch every kernel of the path), beside the card's
   name and power limit; the kernels line's launch counts include this
   phase's, summed over ranks;
22. the device-cost ledger and the runtime sentinels (``perf_slice``):
   ``cli train`` on the flagship single env with ``--perf`` (its
   ``--no-perf`` twin gave way to the time limit),
   ``--replicas 64`` under ``assert_no_retrace``, which a forced load
   trips,
   and the server in phase 4's bursts (the mesh's ledger: phase 21
   (g)): every ``perf.json`` entry available and whole (``launches``
   and ``device_s`` recorded: every kernel launch call matched to its
   device record, the hand kernels' launches from the profiler equal to
   their wrappers' posts), every timed entry 0 < mfu <= 1.05;
   host syncs, device seconds, launches and capture seconds per entry
   printed; a ``compile`` event of every library phase 2 built and
   loaded; the kernels' bounds from ``ops.cost`` equal to the formulas
   this script held before (the earlier phases run with ``--no-perf``,
   so their numbers stay comparable); how many of PROFILE_ROUNDS short
   profiles of 9 fixed launches lost device records, opened bare (the
   profiler started right before the work, no primer) and through the
   ledger's ``DeviceProfile`` (none may); the kernels line's launch
   counts include this phase's;
23. flat observations and the MLP actor and critic (``flat_slice``):
   ``init-configs``' agent with ``graph_mode: false`` (observation 24 x 3
   = 72 floats, action 1,728, actor hidden 256, critic hidden 64): (a)
   ``cli train --replicas 64`` for one 200-step episode with its learn
   burst and its evaluation (rollout env-steps/s, burst seconds,
   kernel #2's launches: one per env step and evaluation step, no
   attention launch; every loss finite, every parameter moved; the
   sidecar records ``graph_mode`` false) with one of the run's B=64
   kernel #2 launches held against its plain version on the card and
   bit for bit on CPU copies; (b) single-env ``cli train`` of one
   50-step episode, then ``cli infer`` on its checkpoint, equal to the
   run's own evaluation; (c) ``run_serve`` (the body of ``cli serve``) of
   (a)'s checkpoint for FLAT_SERVE[0] closed-loop requests (requests/s,
   p50, p99; every answer finite, rows summing to 1, equal to an
   unbatched ``greedy_action`` outside ambiguous rows); (d) the
   single-env dispatch region (``env.reset`` plus ``episode_step`` with
   its burst, traffic sampled beforehand, episode 0 outside) in graph
   mode (the flagship, attention kernels) and in flat mode: one episode
   recording every synchronizing CUDA operation and every value read
   into Python (none allowed), one under ``analysis.no_host_sync`` and
   one under ``torch.cuda.set_sync_debug_mode("error")``, the stats
   drained after the region; under ``controller: per_flow``
   (init-configs' simulator plus that key): (e) ``cli train --replicas
   64`` of one FLAT_PERFLOW_STEPS-step episode with its burst and
   evaluation (kernel #2's idle-instance expiry, its ``gc`` switch, in
   every launch; one B=64 launch bit for bit against its plain version
   on CPU copies), (f) a single-env episode and ``infer`` equal to its
   evaluation; (g) a flat ``cli train --replicas 64 --hot-swap-dir``
   of FLAT_TWS[0] episodes publishing every episode beside a
   two-worker fleet serving (a)'s checkpoint: every version adopted once
   by each worker, ``swap_ms``, p50/p99 before and while training, every
   answer bit-identical to a single-shot call under its stamped version;
   the kernels line's launch counts include this phase's;
24. the linkcap oracle, the native traffic sampler and the linter
   (``oracle_traffic_slice``): (a) the one coordsim oracle whose inputs
   are all in the repo (tests/assets/line3-linkcap2.graphml and
   linkcap_config.yaml, 50 uniform intervals at seed 1234, the frozen
   numbers of tests/test_reference_parity.py:106-123) through
   ``sim.oracle.uniform_engine_run`` on the card, one kernel #2 launch
   per interval: the constants within their bounds (generated exact,
   processed, dropped and LINK_CAP within 30 flows, the other reasons
   zero, the mean end-to-end delay within 5%), and every interval's
   counters against the plain engine's run on the CPU (integers exact,
   the end-to-end sum within the phase 5 tolerance); (b) one 200-interval
   episode of bench.py's Abilene stack under random traffic from the
   native sampler (exponential arrivals, Pareto sizes, noisy data rates;
   ``cases.stochastic_abilene_case``) through kernel #2, every interval
   against the plain version on CPU copies (phase 5's tolerance, and bit
   for bit); (c) host seconds per episode of traffic for 64 Abilene
   replicas (``EpisodeDriver.replica_traffic``) with the native sampler
   and with the numpy path, median of 5 each, in a process aside, printed
   beside the host's name and CPU count and the card's ``nvidia-smi``
   line: host numbers; (d) ``python -m gsc_tpu_torch.analysis.lint`` over
   ``gsc_tpu_torch/`` and ``chip_smoke.py`` exits 0 under this machine's
   Python; the CPU references of (a) and (b) start after phase 5 in the
   processes aside, (c) and (d) before phase 23 (``host_checks``), so
   all of them run beside other phases; the kernels line's launch counts
   include (a) and (b);
25. ``train --async --mesh`` (``async_mesh_slice``): one launch of 2
   ranks sharing the card (gloo) runs, as legs of ``cli.mesh_legs``:
   (a) phase 20 (b)'s frozen-publish run, exploration noise on, on
   ``--mesh 2x1`` (one actor per rank, its rows ``plan.rows(64)``, its
   noise the rows of the 64 the one process draws): the gathered replay
   bit-identical to phase 20 (b)'s one-process replay; (b) 2 actors per
   rank, publishing, ASYNC_MESH_EPISODES 50-step episodes after a
   50-step warm-up: every episode drained on both ranks, at least one
   publish, equal burst counts; prints env-steps/s summed over ranks,
   bursts/s, the policy lag, the learner's and actors' idle fractions
   and the batch gather's ms per gradient step beside phase 20's
   one-process numbers of this call; (c) a flat agent (the same widths,
   ``graph_mode: false``) under ``--async --mesh 2x1 --partition-rules
   sharded``, one 50-step episode whose second half is past the
   warm-up, drained on both ranks; (d) in (c)'s run a ``watcher_stall``
   fault holds actor 0 in its adoption for ASYNC_MESH_STALL[0] s against
   a watchdog budget of ASYNC_MESH_STALL[1] s: rank 0's observer
   (``events.jsonl``) and rank 1's own hub each record a ``stall``
   naming ``actor0`` in phase ``adopt``.  Every leg: both ranks' learner
   states bit-equal (``state_sha256``), 0 collectives from actor threads
   and from ingests, produced == ingested steps, kernel #2 launched on
   every rank (kernel #1 too, but for the flat agent); prints each leg's
   seconds; the kernels line's launch counts include this phase's,
   summed over ranks;
26. last line: ``{"ok": true, "device": {"platform": "gpu", ...}}``.

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

import atexit
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# the kernels' work counts and the card's rates (one H100 SXM, NVIDIA data
# sheet: HBM3, f32 outside the tensor cores, dense bf16) live in the
# package, where the cost ledger reads them too
from gsc_tpu_torch.ops.cost import (attention_backward_work, attention_work,
                                    least_ms, substep_work)

KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-5
# the backward kernel against its plain version, per output tensor: the
# largest difference within BWD_SCALE of the tensor's largest entry plus
# BWD_ATOL (see the docstring)
BWD_SCALE, BWD_ATOL = 1e-5, 1e-5
ANSWER_RTOL, ANSWER_ATOL = 1e-5, 1e-6
THRESH_TOL = 1e-4
F64_RATIO, F64_FLOOR = 4.0, 1e-7
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
# the earlier phases' runs keep their numbers without the cost ledger
# (phase 22 runs it)
TRAIN_ARGS = ["--replicas", "64", "--chunk", "50", "--episodes", "2",
              "--seed", "0", "--no-perf"]
# phase 16: the registry mix (the schedule's Abilene, a shaped Abilene,
# a star with a dead link from interval 3, a seeded random network) and
# the factory mix; the flagship agent with node shuffling
GEN_REGISTRY_MIX = "schedule,abilene+bursty,star12~link@3.0,random12:7"
# the mixes' and the shuffled runs' episodes (and the mixes' warm-up),
# cut from the agent's 200 steps for the time limit
GEN_MIX_STEPS = 50
GEN_FACTORY_MIX = "factory:all+shapes~faults"
SHUFFLE_AGENT_YAML = (f"episode_steps: {GEN_MIX_STEPS}\nobjective: prio-flow\n"
                      "gnn_impl: pallas\nshuffle_nodes: true\n")
# phase 15: the default train run on phase 13's schedule, its episodes
# cut from 200 to DEFAULT_RUN_STEPS steps (warm-up as long, so every
# episode ends in a burst of as many gradient steps)
DEFAULT_RUN_STEPS = 50
# phase 18: the batches timed, cli simulate's -d, the prediction episode
PERFLOW_BATCHES = (1, 64)
PERFLOW_SIM_MS = 300
PREDICTION_STEPS = 20
DEFAULT_RUN_PLAN = "nan_grads@1;dispatch_transient@2"
DEFAULT_RUN_RECOVERIES = [("dispatch", "retry", 2),
                          ("learner_state", "rollback", 1)]
# gradient steps profiled per learn burst, ledger on and off
LEDGER_PROFILE_STEPS = 5
# phase 13: single-env episodes over the schedule (switching every
# GEN_PERIOD episodes)
GEN_EPISODES = 2
GEN_PERIOD = 1
# profiled rollout steps of its split of a single-env step
GEN_PROFILE_STEPS = 20
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
# phase 17: requests of the SPR tier, of each learned fleet, of the
# traced run and of the device-to-host count, the closed-loop clients;
# train-while-serve's episodes, their length, the watchers' poll and the
# requests answered before training starts (and after the last swap); the
# overloaded fleet's requests and clients
SPR_REQUESTS, FLEET_REQUESTS, TRACE_REQUESTS, D2H_REQUESTS = 64, 256, 64, 64
SERVE_CONCURRENCY = 8
TWS_EPISODES, TWS_STEPS, TWS_POLL_S, TWS_WARM = 1, 50, 0.05, 200
# train-while-serve's warm-up: half its one episode, which then ends in a
# learn burst and a publish (one episode of two gave way to the time
# limit)
TWS_WARMUP = TWS_STEPS // 2
# train-while-serve's clients: fewer than the fleets' SERVE_CONCURRENCY,
# since every client thread takes the interpreter from the trainer
TWS_CONCURRENCY = 4
BROWNOUT_REQUESTS, BROWNOUT_CONCURRENCY = 128, 32
# copies of the parent commit's megakernel source and attention kernel
# source and wrapper, present only in a run that compares them (never
# committed)
ROOT = Path(__file__).resolve().parent
PARENT_DIR = ROOT / "_parent"
PARENT_SOURCE = PARENT_DIR / "substep_megakernel.cu"
PARENT_GAT_SOURCE = PARENT_DIR / "gat_attention.cu"
PARENT_GAT_WRAPPER = PARENT_DIR / "gat_attention.py"
PARENT_GAT_BACKWARD_SOURCE = PARENT_DIR / "gat_attention_backward.cu"
# the battery case whose data rates span more than a double holds
WIDE_CASE = "wide_range_dr"
# processes that run the plain versions on CPU copies beside the card
# (phases 5, 18 and 19)
PLAIN_WORKERS = 4
# phase 5's cases that also run the plain version on the card
PLAIN_ON_CARD_CASES = ("node_cap", "wide_range_dr", "abilene_b64",
                       "abilene_b4_m1024")
# phase 19: reference-style plugin files (the plugins of
# gsc_tpu_torch.sim.cases.PLUGINS), the abc chain naming one per SF,
# cli simulate's -d, the short replica training run and its agent
PLUGIN_FILES = {
    "rf_quadratic.py": ("def resource_function(load):\n"
                        "    return load * load * 0.25 + load\n"),
    "rf_capped.py": ("import torch\n\n\ndef resource_function(load):\n"
                     "    return torch.where(load > 2.0, "
                     "2.0 + 0.5 * (load - 2.0), load)\n"),
    "rf_sqrt_ratio.py": ("import torch\n\n\ndef resource_function(load):\n"
                         "    return torch.sqrt(torch.relu(load)) "
                         "+ load / 3.0\n"),
}
# the second set (gsc_tpu_torch.sim.cases.MATH_PLUGINS): functions kernel
# #2 evaluates in double (csrc/rf_math.cuh)
MATH_PLUGIN_FILES = {
    "rf_tanh.py": ("import torch\n\n\ndef resource_function(load):\n"
                   "    return 2.0 * torch.tanh(load / 2.0)\n"),
    "rf_log1p.py": ("import torch\n\n\ndef resource_function(load):\n"
                    "    return torch.where(load > 0.0, torch.log1p(load) "
                    "+ 0.1 * load, torch.zeros_like(load))\n"),
    "rf_pow15.py": ("import torch\n\n\ndef resource_function(load):\n"
                    "    return torch.where(load > 1.0, load ** 1.5, load)\n"),
}


def plugin_service_yaml(files) -> str:
    """The abc chain naming one plugin file's stem per SF."""
    return "sfc_list:\n  sfc_1: [a, b, c]\nsf_list:\n" + "".join(
        f"  {n}:\n    processing_delay_mean: 5.0\n"
        f"    processing_delay_stdev: 0.0\n    resource_function_id: "
        f"{rf[:-3]}\n" for n, rf in zip("abc", files))


PLUGIN_SIM_MS = 500
PLUGIN_EPISODE_STEPS = 10
PLUGIN_TRAIN_ARGS = ["--replicas", "4", "--chunk", str(PLUGIN_EPISODE_STEPS),
                     "--episodes", "1", "--seed", "0"]
PLUGIN_AGENT_YAML = (f"episode_steps: {PLUGIN_EPISODE_STEPS}\n"
                     "objective: prio-flow\ngnn_impl: pallas\n")
# the battery's Abilene batch and the substeps of each per-flow case under
# plugins
PLUGIN_ABILENE_BATCH = 16
PLUGIN_PERFLOW_SUBSTEPS = 50
# phase 20: decoupled training at B=64 (episodes of ASYNC_STEPS steps,
# the first all warm-up), the staleness bound (one episode's steps at
# B=64, so that the actors wait for the learner's first publish and adopt
# it), the frozen-publish runs and the fault plan
ASYNC_ARGS = ["--replicas", "64", "--chunk", "25", "--episodes", "3",
              "--seed", "0"]
# the init-configs agent with episodes (and warm-up) of ASYNC_STEPS steps
# (cut from the agent's 200 for the time limit; two chunks of 25, so that
# an actor adopts a publish within an episode)
ASYNC_STEPS = 50
ASYNC_STALENESS = 64 * ASYNC_STEPS
ASYNC_FAULT_PLAN = "actor_die@a1:1;ring_poison@2"
# phase 20 (b), which phase 25 (a) reruns on two ranks: the same agent,
# one actor, publishing frozen, exploration noise on (the second episode
# acts through the actor)
ASYNC_FROZEN_EPISODES = 2
# phase 25: (b)'s episodes (the first all warm-up), (c)'s warm-up within
# its one flat episode, (d)'s hold of actor 0 in its adoption and the
# watchdog's budget, seconds
ASYNC_MESH_EPISODES = 2
ASYNC_MESH_FLAT_WARMUP = 25
ASYNC_MESH_STALL = (3.0, 1.0)


# phase 21: the flagship agent with 50-step episodes (warm-up 200 steps:
# (a), (b), (d); 50: (c)), B=64 on Abilene, and the launches' deadline
MESH_AGENT_YAML = (
    "GNN_aggr: mean\nGNN_features: 22\nGNN_num_iter: 2\n"
    "GNN_num_layers: 2\nactor_hidden_layer_nodes: [256]\nbatch_size: 100\n"
    "critic_hidden_layer_nodes: [64]\nepisode_steps: 50\ngraph_mode: true\n"
    "mem_limit: 10000\nnb_steps_warmup_critic: {warmup}\n"
    "objective: prio-flow\n"
    "observation_space: [ingress_traffic, node_load, node_cap]\n"
    "target_success: auto\ngnn_impl: pallas\n")
MESH_ARGS = ["--replicas", "64", "--chunk", "50", "--seed", "0",
             "--no-perf"]
MESH_DEADLINE_S = 600.0
# 1x1 runs in one rank process (the warm second gave way to the time
# limit)
MESH_ONE_RUNS = 1
# phase 22 and phase 21 (g): the cost ledger on MESH_AGENT_YAML's
# flagship agent with a 50-step warm-up (every episode ends in a learn
# burst), 2 episodes of 50 steps: the observed one, left out of the
# timings, and one timed
PERF_WARMUP = 50
PERF_EPISODES = 2
PERF_MFU_MAX = 1.05
# phase 22 (e): short profiles of a fixed sequence of launches
PROFILE_ROUNDS = 200
# phase 24: the linkcap oracle's inputs, intervals and seed and its
# frozen numbers (tests/test_reference_parity.py:106-123, the reference
# coordsim's), one episode of bench.py's Abilene stack under random
# traffic, and the replicas and repeats of the host traffic timing
LINKCAP_NETWORK = ROOT / "tests" / "assets" / "line3-linkcap2.graphml"
LINKCAP_CONFIG = ROOT / "tests" / "assets" / "linkcap_config.yaml"
LINKCAP_STEPS, LINKCAP_SEED = 50, 1234
LINKCAP_ORACLE = {
    "generated": 2500, "processed": 151, "dropped": 2348,
    "drop_reasons": {"TTL": 0, "DECISION": 0, "LINK_CAP": 2348,
                     "NODE_CAP": 0},
    "avg_e2e": 22.94701986754967, "atol_flows": 30, "e2e_rel": 0.05}
STOCHASTIC_INTERVALS = 200
TRAFFIC_REPLICAS, TRAFFIC_REPEATS = 64, 5
# phase 23: init-configs' agent in flat mode ({steps}-step episodes and
# as long a warm-up, so each episode ends in a learn burst); (a)'s run,
# (b)'s episode length, (c)'s requests, concurrency and deadline, (d)'s
# episode length
FLAT_AGENT_YAML = (
    "observation_space: [ingress_traffic, node_load, node_cap]\n"
    "graph_mode: {graph}\nepisode_steps: {steps}\nobjective: prio-flow\n"
    "target_success: auto\nGNN_features: 22\nGNN_num_layers: 2\n"
    "GNN_num_iter: 2\nGNN_aggr: mean\nactor_hidden_layer_nodes: [256]\n"
    "critic_hidden_layer_nodes: [64]\nmem_limit: 10000\nbatch_size: 100\n"
    "nb_steps_warmup_critic: {steps}\ngnn_impl: pallas\n")
FLAT_REPLICAS = 64
FLAT_ARGS = ["--replicas", str(FLAT_REPLICAS), "--chunk", "50",
             "--episodes", "1", "--seed", "0", "--no-perf"]
FLAT_STEPS = 200
FLAT_SINGLE_STEPS = 50
FLAT_SERVE = (300, 8, 5.0)
SYNC_STEPS = 50
# phase 23 (e)-(g): the per-flow episodes' length and the flat
# train-while-serve: episodes, client threads, the watchers' poll, the
# requests answered before and after training
FLAT_PERFLOW_STEPS = 50
FLAT_TWS = (1, 4, 0.05, 100)


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


_PLAIN_POOL = None


def _plain_worker_init():
    import torch

    torch.set_num_threads(1)


def on_cpu_aside(fn, *args, **kwargs):
    """A future of ``fn(*args, **kwargs)`` (a plain version on CPU copies)
    in one of PLAIN_WORKERS processes of its own, so that the CPU's
    reference runs beside the card's work; ``stop_cpu_aside`` ends
    them."""
    global _PLAIN_POOL
    if _PLAIN_POOL is None:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        _PLAIN_POOL = ProcessPoolExecutor(
            PLAIN_WORKERS, mp_context=mp.get_context("spawn"),
            initializer=_plain_worker_init)
    return _PLAIN_POOL.submit(fn, *args, **kwargs)


def stop_cpu_aside():
    global _PLAIN_POOL
    if _PLAIN_POOL is not None:
        _PLAIN_POOL.shutdown(wait=True, cancel_futures=True)
        _PLAIN_POOL = None


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


def profile_device_ms(fn, torch, reps=20, kernel=None, host_launches=False):
    """Device time per call of ``fn`` from the profiler's CUDA events: all
    kernels per call when ``kernel`` is None, else per launch of the
    kernels whose name contains ``kernel``, averaged over the launches
    the profiler recorded (some profiles hold only part of a window's
    launches, which an average over ``reps`` would halve).  None when the
    profiler records no device time.  With ``host_launches`` the CPU is
    traced too and the result is (that time, kernel launches the host
    made per call)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host_launches:
        activities.append(ProfilerActivity.CPU)
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:   # a machine that refuses tracing: no number
        print(f"  profiler unavailable ({e}); device time not measured")
        return (None, 0) if host_launches else None
    total_us, launches, host = 0.0, 0, 0
    for evt in prof.key_averages():
        if evt.key in ("cudaLaunchKernel", "cuLaunchKernel",
                       "cudaLaunchKernelExC"):
            host += evt.count
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us and (kernel is None or kernel in evt.key):
            total_us += dev_us
            launches += evt.count
    ms = (None if total_us <= 0 else
          total_us / (reps if kernel is None else launches) / 1e3)
    return (ms, host // reps) if host_launches else ms


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


def gat_bound(args):
    """Least time for the attention stage on these inputs: every input
    read once and the output written once (in the inputs' dtype) over the
    HBM rate, against the operations this adjacency needs over the peak
    rate for the features' dtype (``ops.cost.attention_work``)."""
    return least_ms(attention_work(*args), args[0].dtype)


def gat_backward_bound(args, grad):
    """Least time for the attention stage's gradient on these inputs:
    grad_out, xl, xr, att and adj read once and d_xl, d_xr (in the
    features' dtype), d_att, d_bias (f32) written once over the HBM rate,
    against the operations the closed form needs on this adjacency over
    the peak rate for the features' dtype
    (``ops.cost.attention_backward_work``)."""
    xl, xr, att, _, adj = args
    return least_ms(attention_backward_work(grad, xl, xr, att, adj),
                    xl.dtype)


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
    battery = cases.all_cases(abilene_batch=64)
    aside = [on_cpu_aside(cases.run_case, case, "cpu", plain=True)
             for case in battery]
    for case, cpu_run in zip(battery, aside):
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
        on_card = (cases.run_case(case, dev, plain=True)
                   if case.name in PLAIN_ON_CARD_CASES else None)
        on_cpu = cpu_run.result()
        e_card = e_cpu = e_plain = 0.0
        for i in range(case.intervals):
            what = f"{case.name} interval {i}"
            e_cpu = max(e_cpu, cases.compare_states(
                got[i], on_cpu[i], SUB_RTOL, SUB_ATOL,
                f"{what}, kernel vs plain on CPU: "))
            if on_card is not None:
                e_card = max(e_card, cases.compare_states(
                    got[i], on_card[i], SUB_RTOL, SUB_ATOL,
                    f"{what}, kernel vs plain on card: "))
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
        card = ("not run" if on_card is None else
                f"{e_card:.2e}, plain card-CPU {e_plain:.2e}")
        print(f"  {case.name:18s} M={case.engine.M:4d} B={case.batch:3d} "
              f"x{case.intervals} intervals: max float diff "
              f"kernel-plain(CPU) {e_cpu:.2e} (bit-equal), "
              f"kernel-plain(card) {card}, "
              f"single substep {e_one:.2e}; serial rounds {serial}; "
              f"bit-identical relaunch; generated "
              f"{int(m.generated.sum())}, dropped {int(m.dropped.sum())} "
              f"reasons {m.drop_reasons.sum(0).tolist()} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return worst


def substep_bound(engine, before, after, batch, substeps=None, written=(),
                  extra_bytes=0, skip=()):
    """Least time for one interval (or ``substeps`` substeps) of ``batch``
    replicas (``ops.cost.substep_work``), with the two release rings'
    rows it touches and the traffic records it admitted read from the
    state ``after`` it: every state leaf read once and every leaf the
    substep writes written once (``placed`` and ``sf_startup`` only where
    named in ``written``, as per-flow control writes them; the leaves
    named in ``skip`` not at all, as per-flow control touches neither the
    WRR schedule nor its counts), of the release rings only the rows the
    interval releases (one per substep from the interval's first) and
    the rows it adds holds into; the topology, the interval's
    capacities, the admitted records, one arrival time per substep and
    ``extra_bytes`` (per-flow decisions) read once.  Against a lower
    count of the slots' operations over the f32 rate.  Returns (ms,
    "bytes" or "operations", bytes, ring rows)."""
    import torch

    h = engine.H
    k = engine.substeps if substeps is None else substeps
    g0 = torch.round(before.t / engine.dt).long() % h               # [B]
    rows = torch.arange(h, device=g0.device)
    released = (rows[None] - g0[:, None]) % h < k                    # [B, H]
    ring_rows = {}
    for name in ("rel_node", "rel_edge"):
        a, z = getattr(before, name), getattr(after, name)
        a = a.reshape(a.shape[0], h, -1)
        z = z.reshape(z.shape[0], h, -1)
        ring_rows[name] = int((released | (a != z).any(-1)).sum())
    admitted = int((after.cursor - before.cursor).sum())
    work = substep_work(engine, before, batch, k, written, skip, extra_bytes,
                        ring_rows, admitted)
    ms, by = least_ms(work)
    return ms, by, int(work.bytes), sum(ring_rows.values())


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


def rung5_ledger_memory(torch, smi, args):
    """Phase 14 (g): ``cli.run_train`` of ``args`` (rung 5) with
    ``--perf``: its peak allocated device bytes printed, and how often
    the ledger's capture let go of more than
    ``analysis.launches.HOLD_BYTES`` of held inputs mid-call (a learn
    burst builds an adjacency of 100 x 256 x 256 per forward; each
    settle starts a new profile segment); the ledger's entries available
    and whole, its ``perf.json`` on the card."""
    from gsc_tpu_torch import cli
    from gsc_tpu_torch.analysis.launches import HOLD_BYTES
    from gsc_tpu_torch.obs import perf as perf_mod

    settle = perf_mod._Capture._settle
    settles = []

    def counted(self):
        settles.append(self.counter.held_bytes)
        return settle(self)

    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        perf_mod._Capture._settle = counted
        try:
            cli.run_train(args + ["--perf", "--obs-dir", d])
        finally:
            perf_mod._Capture._settle = settle
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(d, "perf.json")) as f:
            doc = json.load(f)
    entries = doc["entries"]
    check(doc["backend"] == "gpu" and set(entries) == {"chunk_step",
                                                       "learn_burst"}
          and all(e["available"] and e["launches"] is not None
                  and e["device_s"] is not None for e in entries.values()),
          f"rung 5 --perf: entries "
          f"{ {k: e.get('error') or e.get('no_profile', 'ok') for k, e in entries.items()} }")
    check(len(settles) > 0, "rung 5 --perf: the capture never let go of "
          f"its held inputs (HOLD_BYTES {HOLD_BYTES})")
    print(f"phase 14 (g) rung5 peak allocated device bytes with --perf "
          f"{peak}; every entry whole; the capture let go "
          f"of its held inputs {len(settles)} times mid-call at "
          f"{max(settles)} bytes held (HOLD_BYTES {HOLD_BYTES}); "
          f"learn_burst {entries['learn_burst']['flops']:.6g} FLOP, "
          f"host_syncs {entries['learn_burst']['host_syncs']}, capture_s "
          f"{entries['learn_burst']['capture_s']} on {smi}", flush=True)


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
    argv = args + ["--precision", precision, "--no-perf"]
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
                 "summary": res["summary"], "result": res}


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
              f"{summ['rps']:.1f} req/s, p50 {summ['p50_ms']:.3f} "
              f"ms, p99 {summ['p99_ms']:.3f} ms, startup "
              f"{summ['startup']['startup_s']:.2f} s on {smi}; answers vs the plain "
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
                "--no-perf", "--episodes", str(GEN_EPISODES), "--result-dir",
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

        # (c) one episode less, a checkpoint, a resumed last: bit for bit
        res_c = cli.run_train(base + ["--no-perf", "--episodes",
                                      str(GEN_EPISODES - 1), "--result-dir",
                                      os.path.join(root, "c")])
        laps.lap("c")
        res_r = cli.run_train(base + [
            "--no-perf", "--episodes", str(GEN_EPISODES), "--resume",
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
          f"{summ['rps']:.1f} req/s, p50 {summ['p50_ms']:.3f} ms, "
          f"p99 {summ['p99_ms']:.3f} ms, startup {summ['startup']['startup_s']:.2f} s "
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
                               "--episodes", "1"])
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
        rung5 = ["--network", paths["rung5.graphml"], "--max-nodes", "256",
                 "--max-edges", "384", "--service", paths["mixed.yaml"],
                 "--agent-config", paths["rung5.yaml"],
                 "--simulator-config", paths["sim.yaml"], "--replicas", "2",
                 "--chunk", "20", "--episodes", "1"]
        counts, runs["rung5 f32"] = train_slice(
            torch, dev, smi, "f32", label=" rung5", result_dir=False,
            args=rung5)
        add(counts)
        laps.lap("(f) rung5")
        rung5_ledger_memory(torch, smi, rung5)
        laps.lap("(g) rung5 ledger")
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


def launches_of(fn, torch):
    """(wall ms of one call of ``fn``, the kernels it launched) from one
    profiled call; launches None when the profiler records none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:   # a machine that refuses tracing
        print(f"  profiler unavailable ({e}); launches not measured")
        return None
    n = sum(evt.count for evt in prof.key_averages()
            if (getattr(evt, "self_device_time_total", None)
                or getattr(evt, "self_cuda_time_total", 0.0)))
    return n or None


def generalization_case_reference(name):
    """The plain version's states over ``cases.generalization_cases()``'s
    case ``name`` on the CPU (a worker process of phase 16 computes
    these while the card runs the rest of the phase)."""
    import torch

    from gsc_tpu_torch.sim import cases

    torch.set_num_threads(1)
    case = {c.name: c for c in cases.generalization_cases()}[name]
    return cases.run_case(case, "cpu", plain=True)


def generalization_training_slice(torch, dev, smi):
    """Phase 16: generalization training at the flagship widths.  (a)
    kernel #2 on ``cases.generalization_cases()`` against its plain
    version (bit for bit on CPU copies, no sequential scan) and its device
    time per interval on a mixed B=64 batch in turns with homogeneous
    Abilene at B=64; (b) kernel #1 forward and backward on a mixed batch
    of graphs at (100, 24, 22); (c) ``DeviceTraffic`` on the card bit-equal
    to the host generator on the init-configs simulator, and one
    ``sample_batch`` (and one factory draw) at B=64: wall ms and launches;
    (d) ``cli.run_train`` at B=64 for 2 episodes under ``GEN_REGISTRY_MIX``
    and (e) under ``GEN_FACTORY_MIX`` with the curriculum, each with phase
    8's checks; (f) one single-env and one B=64 episode with
    ``shuffle_nodes: true``.  Returns (the path's launch counts in (d)-(f),
    kernel #2's, kernel #1's and its backward's largest errors)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    laps = Laps()
    # (a) kernel #2 on the new inputs; the plain version's CPU states come
    # from one worker process, checked at the end of the phase
    from gsc_tpu_torch.sim import cases

    gen_cases = cases.generalization_cases()
    pool = ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    try:
        refs = {c.name: pool.submit(generalization_case_reference, c.name)
                for c in gen_cases}
        return _generalization_parts(torch, dev, smi, gen_cases, refs,
                                     laps, fmt)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _generalization_parts(torch, dev, smi, gen_cases, refs, laps, fmt):
    """Phase 16's parts (``generalization_training_slice``); ``refs``
    holds the futures of the plain version's CPU states per case."""
    import math
    import tempfile

    from gsc_tpu_torch import cli
    from gsc_tpu_torch.config import abc_service, init_configs_sim
    from gsc_tpu_torch.ops.gat_attention import (attention_backward_plain,
                                                 attention_plain,
                                                 gat_attention,
                                                 gat_attention_backward)
    from gsc_tpu_torch.ops.substep import substep_megakernel
    from gsc_tpu_torch.sim import cases
    from gsc_tpu_torch.sim.traffic import generate_traffic
    from gsc_tpu_torch.sim.traffic_device import DeviceTraffic
    from gsc_tpu_torch.topology import synthetic
    from gsc_tpu_torch.topology.compiler import compile_topology
    from gsc_tpu_torch.topology.factory import ScenarioFactory, parse_factory

    sub_err = 0.0
    on_card = {}
    for case in gen_cases:
        substep_megakernel.serial_rounds = 0
        before = substep_megakernel.launches
        got = cases.run_case(case, dev)
        torch.cuda.synchronize()
        check(substep_megakernel.launches - before == case.intervals,
              f"{case.name}: not one megakernel launch per interval")
        serial = substep_megakernel.serial_rounds
        check(serial == 0, f"{case.name}: {serial} admission rounds took "
              "the sequential scan")
        plain = cases.run_case(case, dev, plain=True)
        for i in range(case.intervals):
            sub_err = max(sub_err, cases.compare_states(
                got[i], plain[i], SUB_RTOL, SUB_ATOL,
                f"{case.name} interval {i}, kernel vs plain on card: "))
        again = cases.run_case(case, dev)
        check(cases.bit_equal(again[-1], got[-1]),
              f"{case.name}: two launches on the same inputs differ")
        on_card[case.name] = [g.to("cpu") for g in got]
        m = got[-1].metrics
        print(f"  {case.name:15s} B={case.batch:3d} x{case.intervals} "
              f"intervals: within SUB_RTOL/SUB_ATOL of plain on the card "
              f"({sub_err:.2e}), serial rounds 0, relaunch bit-identical; "
              f"generated {int(m.generated.sum())}, drop reasons "
              f"{m.drop_reasons.sum(0).tolist()}", flush=True)

    def interval(case):
        states = cases.run_case(case, dev)
        eng, b = case.engine, case.batch
        traffic = case.traffic.to(dev).expand(b)
        st, cap = eng.begin_interval(states[-1], traffic,
                                     case.schedule.to(dev),
                                     case.placement.to(dev))
        topo = eng.interval_topology(st, case.topo.to(dev).expand(b),
                                     traffic)
        return lambda: substep_megakernel.launch(eng, st, topo, traffic,
                                                 cap)

    mixed = interval(cases.mixed_topology_case(batch=64, intervals=2))
    homog = interval(cases.abilene_case(batch=64, intervals=2, seed=7))
    dms = lambda fn: profile_device_ms(fn, torch, reps=10,
                                       kernel="substep_megakernel_kernel")
    turns = [dms(mixed), dms(homog), dms(homog), dms(mixed)]
    print(f"phase 16 (a) kernel #2 device time per interval at B=64 in "
          f"turns (mixed, Abilene, Abilene, mixed): "
          f"{', '.join(fmt(t) for t in turns)} on {smi}", flush=True)
    laps.lap("a")

    # (b) kernel #1 on a mixed batch of graphs
    xl, xr, att, bias, adj, grad = (t.to(dev) for t in
                                    cases.mixed_attention_inputs(100, 22))
    fwd_err = bwd_err = 0.0
    for mean in (True, False):
        got = gat_attention(xl, xr, att, bias, adj, mean)
        want = attention_plain(xl, xr, att, bias, adj, mean)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
              f"mixed batch, mean={mean}: forward off by {err}")
        check(bool((got[~adj.any(-1)] == 0).all()),
              "mixed batch: a row without a neighbour is not 0")
        fwd_err = max(fwd_err, err)
        back = gat_attention_backward(grad, xl, xr, att, adj, mean)
        ref = attention_backward_plain(grad, xl, xr, att, adj, mean)
        for name, g, w in zip(("d_xl", "d_xr", "d_att", "d_bias"), back,
                              ref):
            err = float((g - w).abs().max())
            check(err <= BWD_SCALE * float(w.abs().max()) + BWD_ATOL,
                  f"mixed batch, mean={mean}: backward {name} off by {err}")
            bwd_err = max(bwd_err, err)
        again = gat_attention_backward(grad, xl, xr, att, adj, mean)
        check(all(torch.equal(a, b) for a, b in zip(again, back)),
              "mixed batch: two backward launches differ")
    nodes = adj.diagonal(dim1=-2, dim2=-1).sum(-1)
    print(f"phase 16 (b) kernel #1 on a mixed batch (100, 24, 22) of graphs "
          f"with {int(nodes.min())}-{int(nodes.max())} real nodes, both "
          f"aggregations: forward max abs diff {fwd_err:.2e}, backward "
          f"{bwd_err:.2e} (within the phase 3 tolerances), relaunch "
          "bit-identical", flush=True)
    laps.lap("b")

    # (c) DeviceTraffic on the card
    sim = init_configs_sim()
    topo = compile_topology(synthetic.abilene())
    host = generate_traffic(sim, abc_service(), topo, 200, seed=0)
    sampler = DeviceTraffic(sim, abc_service(), topo, 200, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    got = sampler.sample(gen)
    for f in ("arr_time", "arr_ingress", "arr_dr", "arr_duration",
              "arr_ttl", "arr_sfc", "arr_egress", "ingress_active",
              "node_cap"):
        check(torch.equal(getattr(got, f).cpu(), getattr(host, f)),
              f"DeviceTraffic on the card: {f} differs from the host's")

    def wall_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    draw = lambda: sampler.sample_batch(gen, 64)
    t_ms, n_launch = wall_ms(draw), launches_of(draw, torch)
    factory = ScenarioFactory(parse_factory(GEN_FACTORY_MIX), sim,
                              abc_service(), 200, device=dev)
    probs = torch.full((4,), 0.25)
    fdraw = lambda: factory.sample_batch(gen, probs, 64)
    f_ms, f_launch = wall_ms(fdraw), launches_of(fdraw, torch)
    print(f"phase 16 (c) DeviceTraffic on the card: Abilene, 200 intervals, "
          f"init-configs traffic bit-equal to the host generator "
          f"({int(torch.isfinite(host.arr_time).sum())} flows); one "
          f"sample_batch at B=64: {t_ms:.2f} ms wall, {n_launch} kernel "
          f"launches; one factory draw ({GEN_FACTORY_MIX}) at B=64: "
          f"{f_ms:.2f} ms wall, {f_launch} launches, on {smi}", flush=True)
    laps.lap("c")

    # (d), (e) the registry mix and the factory with the curriculum
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    mix_root = tempfile.mkdtemp(prefix="gsc_mix_")
    mix_agent = ["--agent-config", short_agent_yaml(mix_root, GEN_MIX_STEPS)]
    c, reg = train_slice(torch, dev, smi, args=TRAIN_ARGS + mix_agent + [
        "--topo-mix", GEN_REGISTRY_MIX], label=" registry mix",
        result_dir=False)
    add(c)
    trainer = reg["result"]["trainer"]
    buf = reg["result"]["buffers"]
    idx = buf.data["topo_idx"][:, :int(buf.size.min())]
    plan = trainer.driver.mix_plan(idx.shape[0])
    check(bool((idx == torch.as_tensor(plan.assignment, device=idx.device)
                [:, None].to(idx.dtype)).all()),
          "registry mix: a replay row's topo_idx is not its replica's "
          "entry")
    ep = trainer.obs.events.of_kind("episode")[-1]
    check(set(ep["per_topology_return"]) == set(trainer.driver.topo_id_names)
          and all(math.isfinite(v) for v in ep["per_topology_return"]
                  .values()), "registry mix: per-entry returns missing")
    print(f"phase 16 (d) registry mix {GEN_REGISTRY_MIX}: per-entry returns "
          f"{ {k: round(v, 4) for k, v in ep['per_topology_return'].items()} }"
          f"; replay topo_idx per replica = its entry", flush=True)
    laps.lap("d")

    c, fac = train_slice(torch, dev, smi, args=TRAIN_ARGS + mix_agent + [
        "--topo-mix", GEN_FACTORY_MIX], label=" factory", result_dir=False)
    shutil.rmtree(mix_root, ignore_errors=True)
    add(c)
    trainer = fac["result"]["trainer"]
    cur = trainer.obs.events.of_kind("curriculum")
    check(len(cur) == 2, f"{len(cur)} curriculum events for 2 episodes")
    floor = trainer.curriculum.cfg.floor
    w = cur[-1]["weights"]
    check(abs(sum(w.values()) - 1.0) < 1e-5 and min(w.values())
          >= floor / len(w) - 1e-6,
          f"curriculum weights {w} do not sum to 1 over floor/K")
    buf = fac["result"]["buffers"]
    idx = buf.data["topo_idx"][:, :int(buf.size.min())]
    fams = sorted(set(idx.flatten().tolist()))
    check(fams and min(fams) >= 0 and max(fams) < 4 and len(fams) > 1,
          f"factory: replay topo_idx holds families {fams}")
    sig = trainer.obs.events.of_kind("learn_signal")[-1]
    print(f"phase 16 (e) factory {GEN_FACTORY_MIX}: curriculum weights "
          f"{w} (floor {floor}), |TD| per family "
          f"{sig['per_topology_td']}, replay families {fams}", flush=True)
    laps.lap("e")

    # (f) shuffle_nodes on both trainers
    with tempfile.TemporaryDirectory() as d:
        yml = os.path.join(d, "agent.yaml")
        with open(yml, "w") as fh:
            fh.write(SHUFFLE_AGENT_YAML)
        c, _ = train_slice(torch, dev, smi, args=[
            "--replicas", "64", "--chunk", "50", "--episodes", "1",
            "--seed", "0", "--agent-config", yml], label=" shuffle",
            result_dir=False)
        add(c)
        for op in (gat_attention, gat_attention_backward,
                   substep_megakernel):
            op.launches = 0
        one = cli.run_train(["--replicas", "1", "--episodes", "1",
                             "--agent-config", yml, "--no-obs"])
    agent = one["trainer"].agent_cfg
    check(agent.shuffle_nodes, "the single env did not shuffle")
    steps = agent.episode_steps
    acting = sum(1 for g in range(steps) if g >= agent.nb_steps_warmup_critic)
    bwd = gat_attention_backward.launches
    check(substep_megakernel.launches == 2 * steps,
          f"single env: {substep_megakernel.launches} megakernel launches "
          f"for {steps} steps and {steps} evaluation steps")
    check(bwd % 6 == 0 and gat_attention.launches
          == 3 * (acting + steps) + 15 * (bwd // 6),
          f"single env: {gat_attention.launches} forward and {bwd} backward "
          "attention launches")
    check(all(math.isfinite(h["episodic_return"])
              for h in one["trainer"].history),
          "single env shuffled: a return is not finite")
    add({"gat_attention": gat_attention.launches,
         "gat_attention_backward": bwd,
         "substep_megakernel": substep_megakernel.launches})
    print(f"phase 16 (f) shuffle_nodes single env: 1 episode, "
          f"{substep_megakernel.launches} megakernel, "
          f"{gat_attention.launches} forward and {bwd} backward attention "
          f"launches; return {one['trainer'].history[-1]['episodic_return']}"
          , flush=True)
    laps.lap("f")
    # (a)'s CPU references, from the worker
    for case in gen_cases:
        want = refs[case.name].result()
        for i, (g, w) in enumerate(zip(on_card[case.name], want)):
            check(cases.bit_equal(g, w),
                  f"{case.name} interval {i}: the kernel is not bit-equal "
                  "to the plain version on CPU copies")
    print("phase 16 (a) kernel #2 bit-equal to its plain version on CPU "
          f"copies on {', '.join(c.name for c in gen_cases)} (every "
          "interval)", flush=True)
    laps.lap("a, CPU copies")
    print("phase 16 parts, s: " + ", ".join(
        f"({k}) {v:.3f}" for k, v in laps.seconds.items())
          + f"; phase 16 {sum(laps.seconds.values()):.3f} on {smi}",
          flush=True)
    return counts, sub_err, fwd_err, bwd_err


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
        base = ["--scheduler", sched, "--seed", "0", "--no-perf",
                "--agent-config", agent_yaml, "--simulator-config",
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


def attention_inputs_of(fn, torch):
    """Run ``fn()`` with every attention call of the GNN recorded: a list
    of (wrapper, inputs) per call, the inputs cloned."""
    import gsc_tpu_torch.models.gnn as gnn

    seen, real = [], gnn.attention_op

    def op(dtype):
        wrapper = real(dtype)

        def call(*args):
            seen.append((wrapper, [a.detach().clone() if torch.is_tensor(a)
                                   else a for a in args]))
            return wrapper(*args)
        return call

    gnn.attention_op = op
    try:
        fn()
    finally:
        gnn.attention_op = real
    return seen


def batch_of(pool, ks, torch, dev):
    """A [len(ks)]-stack of pool observations on ``dev`` (graph or flat
    ones)."""
    import numpy as np

    from gsc_tpu_torch.env.observations import GraphObs

    if not isinstance(pool[0], GraphObs):
        return torch.from_numpy(np.stack([np.asarray(pool[k])
                                          for k in ks])).to(dev)
    return GraphObs(**{f: torch.from_numpy(np.stack(
        [np.asarray(getattr(pool[k], f)) for k in ks])).to(dev)
        for f in vars(pool[0])})


def percentiles(values):
    import numpy as np

    if not values:
        return float("nan"), float("nan")
    v = np.asarray(values)
    return float(np.percentile(v, 50)), float(np.percentile(v, 99))


def served_at_bucket(report, actor_of, torch, dev):
    """Every answer of ``report`` against a single-shot greedy call at
    the bucket that answered it (the request's observation in every row)
    under the weights of its stamped version, ``actor_of(version)``:
    bit for bit.  Returns the number of distinct single-shot calls."""
    import numpy as np

    ddpg = report.ddpg
    want = {}
    for (k, ans), (version, bucket, _, _) in zip(report.answers,
                                                 report.stamps):
        key = (version, k, bucket)
        if key not in want:
            with torch.inference_mode():
                want[key] = ddpg.greedy_action(
                    batch_of(report.pool, [k] * bucket, torch, dev),
                    actor=actor_of(version))[0].cpu().numpy()
        check(np.array_equal(ans, want[key]),
              f"the answer to pool obs {k} at bucket {bucket} under version "
              f"{version} differs from a single-shot call by "
              f"{float(np.abs(ans - want[key]).max())}")
    return len(want)


def held_against_plain(report, torch, dev):
    """Kernel #1 on the served batches (the pool at every bucket) against
    its plain version: phase 3's tolerances in f32, one bf16 ulp of the
    output's largest entry in bf16.  Returns the largest difference."""
    from gsc_tpu_torch.ops.gat_attention import attention_plain

    ddpg, pool = report.ddpg, report.pool
    worst = 0.0
    for b in BUCKETS:
        ks = [i % len(pool) for i in range(b)]
        with torch.inference_mode():
            calls = attention_inputs_of(
                lambda: ddpg.greedy_action(batch_of(pool, ks, torch, dev)),
                torch)
            check(len(calls) == 3, f"{len(calls)} attention calls per "
                  "greedy call, want 3")
            for wrapper, args in calls:
                got = wrapper.launch(*args)
                want = attention_plain(*args)
                err = float((got.float() - want.float()).abs().max())
                worst = max(worst, err)
                if got.dtype == torch.bfloat16:
                    check(err <= bf16_ulp(want), f"bf16 kernel != plain on "
                          f"a served batch of {b}: {err}")
                else:
                    check(torch.allclose(got, want, rtol=KERNEL_RTOL,
                                         atol=KERNEL_ATOL),
                          f"kernel != plain on a served batch of {b}: {err}")
    return worst


def serving_slice(torch, dev, smi, ck_f32, ck_bf16):
    """Phase 17: serving, whole, at the flagship serving widths (Abilene
    padded to 24/37, the abc chain, GATv2 22x2x2, actor hidden 256,
    M = 128, buckets 1, 4, 8): (a) the SPR tier through ``cli serve``
    without a checkpoint; (b) a learned fleet of two continuous workers
    from phase 8's f32 and phase 10's bf16 checkpoints; (c)
    train-while-serve: ``cli train --replicas 64 --hot-swap-dir`` for
    TWS_EPISODES episodes while a two-worker fleet watching the directory
    serves closed-loop load; (d) ``cli serve --trace-sample 1
    --slo-p99-ms 10``: slo.json, span decompositions, the exported trace,
    and device-to-host copies per flush with tracing on and off; (e) a
    fleet overloaded into overflow, shedding to the SPR tier.  Returns the
    path's launches of every kernel (each count 0 before its drive, read
    just after it) and the phase's largest kernel differences."""
    import threading

    import numpy as np

    import gsc_tpu_torch.serve as serve
    from gsc_tpu_torch import cli
    from gsc_tpu_torch.config import abc_service
    from gsc_tpu_torch.config.schema import EnvLimits
    from gsc_tpu_torch.obs import (MetricsHub, RunObserver, ServeTracer,
                                   parse_slo_spec)
    from gsc_tpu_torch.obs.trace import export_trace, read_events
    from gsc_tpu_torch.ops.gat_attention import (gat_attention,
                                                 gat_attention_backward,
                                                 gat_attention_backward_bf16,
                                                 gat_attention_bf16)
    from gsc_tpu_torch.ops.substep import substep_megakernel
    from gsc_tpu_torch.serve import (GreedyServePolicy, PolicyServer,
                                     load_version, read_latest, run_serve,
                                     spr_schedule_action)
    from gsc_tpu_torch.topology import synthetic
    from gsc_tpu_torch.topology.compiler import compile_topology

    ops = {"gat_attention": gat_attention,
           "gat_attention_backward": gat_attention_backward,
           "gat_attention_bf16": gat_attention_bf16,
           "gat_attention_backward_bf16": gat_attention_backward_bf16,
           "substep_megakernel": substep_megakernel}
    total = {k: 0 for k in ops}
    errs = {"gat_attention": 0.0, "gat_attention_bf16": 0.0}
    laps = Laps()
    root = tempfile.mkdtemp(prefix="gsc_serving_")

    def counted(fn):
        """``fn()`` with every count 0 before it; its counts join the
        phase's."""
        for op in ops.values():
            op.launches = 0
        res = fn()
        counts = {k: op.launches for k, op in ops.items()}
        for k, n in counts.items():
            total[k] += n
        return res, counts

    def line(s):
        return (f"{s['completed']} requests, {s['rps']:.1f} req/s, p50 "
                f"{s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms")

    common = dict(device=dev, pool_steps=POOL_STEPS, buckets=BUCKETS,
                  seed=0)
    try:
        # (a) the SPR tier: cli serve without a checkpoint
        reports = []
        real = serve.run_serve
        serve.run_serve = lambda *a, **k: reports.append(real(*a, **k)) \
            or reports[-1]
        try:
            rc, counts = counted(lambda: cli.main(
                ["serve", "--requests", str(SPR_REQUESTS), "--concurrency",
                 str(SERVE_CONCURRENCY), "--pool-steps", str(POOL_STEPS)]))
        finally:
            serve.run_serve = real
        (spr,) = reports
        summ = spr.summary()
        check(rc == 0 and summ["tier"] == "spr" and not spr.errors,
              f"cli serve without a checkpoint: rc {rc}, {summ['tier']}, "
              f"{spr.errors[:3]}")
        want = spr_schedule_action(
            compile_topology(synthetic.abilene(), max_nodes=24,
                             max_edges=37), EnvLimits.for_service(
                abc_service()))
        check(len(spr.answers) == SPR_REQUESTS and all(
            np.array_equal(a, want) for _, a in spr.answers),
            "an SPR answer differs from spr_schedule_action")
        check(counts["substep_megakernel"] == POOL_STEPS and not any(
            n for k, n in counts.items() if k != "substep_megakernel"),
            f"the SPR tier's launches {counts}: want the pool's "
            f"{POOL_STEPS} megakernel launches and nothing else")
        print(f"phase 17 (a) SPR tier (cli serve, no checkpoint): "
              f"{line(summ)} on {smi}; every answer equals "
              "spr_schedule_action", flush=True)
        laps.lap("a spr")

        # (b) learned fleets of two continuous workers, f32 and bf16
        for precision, ck in (("f32", ck_f32), ("bf16", ck_bf16)):
            rep, counts = counted(lambda: run_serve(
                checkpoint=ck, workers=2, continuous=True,
                requests=FLEET_REQUESTS, concurrency=SERVE_CONCURRENCY,
                **common))
            summ = rep.summary()
            fwd = "gat_attention" + ("_bf16" if precision == "bf16" else "")
            calls = len(rep.flushes) + rep.warm_calls
            check(not rep.errors and len(rep.answers) == FLEET_REQUESTS
                  and rep.rejected == 0,
                  f"{precision} fleet: {rep.errors[:3]}, "
                  f"{len(rep.answers)} answered, {rep.rejected} rejected")
            check(rep.ddpg.agent.precision == precision,
                  f"served under {rep.ddpg.agent.precision}")
            check(counts[fwd] == 3 * calls and counts["substep_megakernel"]
                  == POOL_STEPS, f"{precision} fleet launches {counts} for "
                  f"{calls} dispatches and warm-ups (want 3 per call) and "
                  f"a pool of {POOL_STEPS} steps")
            singles = served_at_bucket(rep, lambda v: rep.ddpg.actor,
                                       torch, dev)
            err = held_against_plain(rep, torch, dev)
            errs[fwd] = max(errs[fwd], err)
            used = sorted({b for _, b in rep.flushes})
            print(f"phase 17 (b) {precision} fleet (2 continuous workers, "
                  f"concurrency {SERVE_CONCURRENCY}): {line(summ)}, "
                  f"{len(rep.flushes)} dispatches (buckets {used}) on {smi}; "
                  f"every answer bit-identical to greedy_action at its "
                  f"bucket ({singles} single-shot calls); kernel #1 vs plain "
                  f"on the served batches max abs diff {err:.2e}",
                  flush=True)
            print(f"serve_summary fleet {precision}: " + json.dumps(summ))
        laps.lap("b fleets")

        # (c) train-while-serve
        pub = os.path.join(root, "publish")
        agent_yaml = os.path.join(root, "agent.yaml")
        cli.init_configs(os.path.join(root, "cfg"))
        with open(os.path.join(root, "cfg", "agent.yaml")) as f:
            text = f.read()
        with open(agent_yaml, "w") as f:
            f.write(text.replace("episode_steps: 200",
                                 f"episode_steps: {TWS_STEPS}")
                    .replace("nb_steps_warmup_critic: 200",
                             f"nb_steps_warmup_critic: {TWS_WARMUP}")
                    + "gnn_impl: pallas\n")
        obs = RunObserver(None)
        stop = threading.Event()
        out = {}

        def fleet():
            try:
                out["report"] = run_serve(
                    checkpoint=ck_f32, workers=2, continuous=True,
                    requests=TWS_CONCURRENCY, concurrency=TWS_CONCURRENCY,
                    hot_swap_dir=pub,
                    swap_poll_s=TWS_POLL_S, observer=obs, until=stop,
                    **common)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                out["error"] = e

        for op in ops.values():
            op.launches = 0
        server = threading.Thread(target=fleet, name="phase17-fleet",
                              daemon=True)
        server.start()
        t_wait = time.perf_counter() + 120.0
        while obs.hub.get_counter("serve_requests_total") < TWS_WARM \
                and server.is_alive() and time.perf_counter() < t_wait:
            time.sleep(0.01)
        check(server.is_alive(), f"the fleet stopped: {out.get('error')}")
        t_train = time.perf_counter()
        trained = cli.run_train(TRAIN_ARGS[:2] + [
            "--chunk", str(TWS_STEPS), "--episodes", str(TWS_EPISODES),
            "--seed", "0", "--no-perf", "--agent-config", agent_yaml,
            "--hot-swap-dir",
            pub, "--publish-interval", "1"])
        t_trained = time.perf_counter()
        # every worker adopts the last version, then the load stops
        t_wait = time.perf_counter() + 30.0
        while min(obs.hub.get_gauge("serve_policy_version", worker=w) or 0
                  for w in ("w0", "w1")) < TWS_EPISODES \
                and time.perf_counter() < t_wait:
            time.sleep(0.01)
        # and answers some requests under it before the load stops
        n0 = obs.hub.get_counter("serve_requests_total")
        while obs.hub.get_counter("serve_requests_total") < n0 + TWS_WARM \
                and time.perf_counter() < t_wait:
            time.sleep(0.01)
        stop.set()
        server.join(300.0)
        check(not server.is_alive() and "error" not in out,
              f"the train-while-serve fleet failed: {out.get('error')}")
        counts = {k: op.launches for k, op in ops.items()}
        for k, n in counts.items():
            total[k] += n
        rep = out["report"]
        summ = rep.summary()
        check(not rep.errors and rep.rejected == 0,
              f"train-while-serve: {len(rep.errors)} errors "
              f"({rep.errors[:3]}), {rep.rejected} rejections")
        swaps = obs.events.of_kind("weight_swap")
        adopted = {(s["worker"], s["version"]) for s in swaps}
        want_adopted = {(w, v) for w in ("w0", "w1")
                        for v in range(1, TWS_EPISODES + 1)}
        check(adopted == want_adopted and len(swaps) == len(want_adopted),
              f"adopted (worker, version) {sorted(adopted)}, want every "
              f"published version once by each worker")
        check(read_latest(pub)["version"] == TWS_EPISODES,
              "the trainer did not publish once per episode")
        check(trained["summary"]["replicas"] == int(TRAIN_ARGS[1]),
              f"the trainer ran {trained['summary']['replicas']} replicas")
        versions = {}
        for v in range(1, TWS_EPISODES + 1):
            with open(os.path.join(pub, f"v{v:05d}.json")) as f:
                leaves = load_version(pub, json.load(f))
            versions[v] = GreedyServePolicy(rep.ddpg, rep.pool[0]).stage(
                leaves, v)
        versions[0] = rep.ddpg.actor
        flushes = obs.events.of_kind("serve_flush")
        check({f.get("policy_version") for f in flushes} <= set(versions),
              "a flush stamped an unpublished version")
        check({v for v, *_ in rep.stamps} == set(versions),
              f"answers came under versions "
              f"{sorted({v for v, *_ in rep.stamps})}, want all of "
              f"{sorted(versions)}")
        singles = served_at_bucket(rep, versions.__getitem__, torch, dev)
        before = [lat for _, _, t, lat in rep.stamps if t < t_train]
        during = [lat for _, _, t, lat in rep.stamps
                  if t_train <= t < t_trained]
        pb, pd = percentiles(before), percentiles(during)
        swap_ms = [s["swap_ms"] for s in swaps]
        check(counts["gat_attention_backward"] > 0
              and counts["gat_attention"] > 0
              and counts["substep_megakernel"] > 0,
              f"train-while-serve launched {counts}")
        print(f"phase 17 (c) train-while-serve: cli train B=64, "
              f"{TWS_EPISODES} episodes of {TWS_STEPS} steps, one publish "
              f"per episode, {t_trained - t_train:.3f} s, beside a fleet of "
              f"2 continuous workers at concurrency {TWS_CONCURRENCY}: "
              f"{line(summ)}, 0 errors, 0 rejections on {smi}; p50/p99 "
              f"before training {pb[0]:.3f}/{pb[1]:.3f} ms over "
              f"{len(before)} requests, while training {pd[0]:.3f}/"
              f"{pd[1]:.3f} ms over {len(during)}; each version adopted "
              f"once by each worker, swap_ms "
              f"{[round(x, 3) for x in swap_ms]}; every answer "
              f"bit-identical to a single-shot call under its stamped "
              f"version ({singles} calls)", flush=True)
        laps.lap("c train-while-serve")

        # (d) SLO and trace through cli serve
        rdir = os.path.join(root, "traced")
        rc, counts = counted(lambda: cli.main(
            ["serve", "--checkpoint", ck_f32, "--requests",
             str(TRACE_REQUESTS), "--concurrency", str(SERVE_CONCURRENCY),
             "--pool-steps", str(POOL_STEPS), "--trace-sample", "1",
             "--slo-p99-ms", "10", "--result-dir", rdir, "--no-perf"]))
        check(rc == 0, f"cli serve --trace-sample 1 returned {rc}")
        (run_dir,) = [os.path.join(rdir, "serve", d)
                      for d in os.listdir(os.path.join(rdir, "serve"))]
        with open(os.path.join(run_dir, "slo.json")) as f:
            slo_doc = json.load(f)
        spans = [e for e in read_events(run_dir)
                 if e["event"] == "serve_request_span"]
        check(len(spans) == TRACE_REQUESTS,
              f"{len(spans)} request spans for {TRACE_REQUESTS} requests")
        worst_sum = max(abs(s["queue_wait_ms"] + s["batch_wait_ms"]
                            + s["device_ms"] - s["latency_ms"])
                        for s in spans)
        check(worst_sum < 1e-2, f"a span's decomposition misses its "
              f"latency by {worst_sum} ms")
        trace, problems = export_trace(run_dir, os.path.join(root,
                                                             "trace.json"))
        check(problems == [], f"the exported trace: {problems[:3]}")
        d2h = {}
        ddpg = rep.ddpg
        for traced in (False, True):
            hub = MetricsHub()
            srv = PolicyServer(
                GreedyServePolicy(ddpg, rep.pool[0],
                                  stream=torch.cuda.Stream(dev)),
                buckets=BUCKETS, hub=hub,
                tracer=ServeTracer(hub=hub, sample=1) if traced else None,
                slo=parse_slo_spec("10") if traced else None).start()
            futs = []
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for i in range(D2H_REQUESTS):
                    futs.append(srv.submit(rep.pool[i % len(rep.pool)]))
                    if len(futs) >= SERVE_CONCURRENCY:
                        futs.pop(0).result(60)
                for f in futs:
                    f.result(60)
                srv.close()
            n = sum(1 for e in prof.events() if "DtoH" in e.name)
            d2h[traced] = (n, len(srv.flushes))
        per = {k: n / f for k, (n, f) in d2h.items()}
        check(d2h[False][0] > 0 and per[True] == per[False],
              f"device-to-host copies per flush: {per[False]} untraced, "
              f"{per[True]} traced ({d2h})")
        print(f"phase 17 (d) cli serve --trace-sample 1 --slo-p99-ms 10: "
              f"slo.json attainment {slo_doc['attainment']}, burn "
              f"{slo_doc['burn_rate']}, p99 {slo_doc['p99_latency_ms']} ms "
              f"on {smi}; {len(spans)} spans, decomposition within "
              f"{worst_sum:.1e} ms of the latency; exported trace of "
              f"{len(trace['traceEvents'])} events validates; device-to-"
              f"host copies per flush {per[False]} untraced, {per[True]} "
              f"traced ({d2h})", flush=True)
        laps.lap("d slo+trace")

        # (e) a brownout: a fleet overloaded into overflow
        rep, counts = counted(lambda: run_serve(
            checkpoint=ck_f32, workers=2, continuous=True, max_queue=1,
            requests=BROWNOUT_REQUESTS, concurrency=BROWNOUT_CONCURRENCY,
            observer=RunObserver(None), **common))
        shed = sum(1 for _, a in rep.answers
                   if np.array_equal(a, rep.spr_action))
        check(not rep.errors and len(rep.answers) == BROWNOUT_REQUESTS,
              f"overloaded fleet: {rep.errors[:3]}")
        check(rep.brownout["overflow"] > 0 and shed == sum(
            rep.brownout.values()), f"{shed} SPR answers, brownout "
            f"counter {rep.brownout}")
        print(f"phase 17 (e) overloaded fleet (2 workers, queue bound 1, "
              f"concurrency {BROWNOUT_CONCURRENCY}): {line(rep.summary())} "
              f"on {smi}; {shed} requests shed to the SPR tier, "
              f"serve_brownout_total {rep.brownout}", flush=True)
        laps.lap("e brownout")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("phase 17 parts, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in laps.seconds.items())
          + f"; phase 17 {sum(laps.seconds.values()):.3f} on {smi}",
          flush=True)
    print("phase 17 launches (each count 0 before its drive): "
          + json.dumps(total), flush=True)
    return total, errs


def perflow_slice(torch, dev, smi):
    """Phase 18: per-flow control.  (a) the kernel's per-flow mode bit for
    bit against its plain version on CPU copies over
    ``cases.perflow_cases()`` and the duration-style ``apply`` under a
    per-flow config, the local policy's oracle; (b) chained one-substep
    launches against one interval launch; (c) ``cli simulate
    --per-flow-algo local|spr`` on the card and on the CPU; (d) one
    single-env episode under ``prediction: true`` and a ``DummyEngine``
    env step; (e) the times.  Returns (launches on the main path by
    kernel, the per-flow mode's largest float difference, the per-flow
    mode's numbers for the kernels line)."""
    import math

    from gsc_tpu_torch import cli
    from gsc_tpu_torch.env.env import ServiceCoordEnv
    from gsc_tpu_torch.ops.gat_attention import (gat_attention,
                                                 gat_attention_backward,
                                                 gat_attention_backward_bf16,
                                                 gat_attention_bf16)
    from gsc_tpu_torch.ops.substep import substep_megakernel, substep_plain
    from gsc_tpu_torch.sim import DummyEngine, cases
    from gsc_tpu_torch.sim.perflow import local_decisions
    from gsc_tpu_torch.sim.predictor import predict_ingress_traffic

    ops = {"gat_attention": gat_attention,
           "gat_attention_backward": gat_attention_backward,
           "gat_attention_bf16": gat_attention_bf16,
           "gat_attention_backward_bf16": gat_attention_backward_bf16,
           "substep_megakernel": substep_megakernel}
    total = {k: 0 for k in ops}
    total["substep_megakernel_perflow"] = 0
    laps = Laps()
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"

    # (a) the battery: the per-flow mode against its plain version
    worst = 0.0
    battery = cases.perflow_cases()
    every_of = lambda case: (10 if case.name == "perflow_vnf_timeout"
                             else None)
    aside = [on_cpu_aside(cases.run_perflow_case, case, "cpu", plain=True,
                          every=every_of(case)) for case in battery]
    for case, cpu_run in zip(battery, aside):
        t0 = time.perf_counter()
        every = every_of(case)
        n0, d0 = substep_megakernel.perflow_launches, \
            substep_megakernel.launches
        got = cases.run_perflow_case(case, dev, every=every)
        torch.cuda.synchronize()
        n = substep_megakernel.perflow_launches - n0
        check(n == case.substeps and substep_megakernel.launches == d0,
              f"{case.name}: {n} per-flow launches for {case.substeps} "
              "substeps (want one each, and no duration launch)")
        want = cpu_run.result()
        for i, (g, w) in enumerate(zip(got, want)):
            worst = max(worst, cases.compare_states(
                g, w, SUB_RTOL, SUB_ATOL, f"{case.name} record {i}: "))
            check(cases.bit_equal(g.to("cpu"), w),
                  f"{case.name} record {i}: the per-flow mode is not "
                  "bit-equal to the plain version on CPU copies")
        note = ""
        if case.name == "perflow_local_line3":
            note = f"; oracle {cases.check_perflow_oracle(got[-1].to('cpu'))}"
        if case.name == "perflow_vnf_timeout":
            trace = [int(g.placed.sum()) for g in got]
            check(max(trace) > 0 and trace[-1] == 0
                  and not bool(got[-1].sf_available.any()),
                  f"vnf_timeout: placed cells every 10 substeps {trace}")
            note = f"; placed cells every 10 substeps {trace}"
        m = got[-1].metrics
        print(f"  {case.name:20s} B={case.batch:3d} {case.substeps:4d} "
              f"substeps ({case.policy}): bit-equal to the plain version "
              f"on CPU copies; generated {int(m.generated.sum())}, "
              f"processed {int(m.processed.sum())}, dropped "
              f"{int(m.dropped.sum())} reasons "
              f"{m.drop_reasons.sum(0).tolist()}{note} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    case = cases.perflow_apply_case()
    d0 = substep_megakernel.launches
    got = cases.run_case(case, dev)
    check(substep_megakernel.launches - d0 == case.intervals,
          "the duration-style apply under a per-flow config did not launch "
          "once per interval")
    want = cases.run_case(case, "cpu", plain=True)
    for i, (g, w) in enumerate(zip(got, want)):
        check(cases.bit_equal(g.to("cpu"), w), f"{case.name} interval {i}: "
              "not bit-equal to the plain version on CPU copies")
    print(f"  {case.name:20s} B={case.batch:3d} x{case.intervals} intervals "
          "(the expiry without external decisions): bit-equal; placed "
          f"cells after each {[int(g.placed.sum()) for g in got]}",
          flush=True)
    laps.lap("a battery")

    # (b) K one-substep launches against one K-substep launch
    for b in PERFLOW_BATCHES:
        one, chained = cases.chained_launches(
            cases.abilene_case(batch=b, intervals=2, seed=3), dev)
        check(cases.bit_equal(one, chained), f"B={b}: 100 one-substep "
              "launches differ from one 100-substep launch")
    print(f"  chained: 100 one-substep launches bit-equal to one "
          f"100-substep launch at B = {PERFLOW_BATCHES}", flush=True)
    laps.lap("b chained")

    # (c) cli simulate under per-flow control, on the card and the CPU
    root = tempfile.mkdtemp(prefix="gsc_perflow_")
    try:
        from gsc_tpu_torch.topology.synthetic import abilene, write_graphml

        cfg = os.path.join(root, "cfg")
        cli.init_configs(cfg)
        net = os.path.join(root, "abilene.graphml")
        write_graphml(abilene(), net)
        with open(os.path.join(cfg, "simulator.yaml")) as f:
            text = f.read()
        sim_pf = os.path.join(cfg, "sim_perflow.yaml")
        with open(sim_pf, "w") as f:
            f.write(text + "controller: per_flow\n")
        base = ["-d", str(PERFLOW_SIM_MS), "-n", net, "-sf",
                os.path.join(cfg, "service_abc.yaml")]
        runs, walls = {}, {}
        for label, config, algo in (
                ("duration", os.path.join(cfg, "simulator.yaml"), "local"),
                ("local", sim_pf, "local"), ("spr", sim_pf, "spr")):
            argv = base + ["-c", config, "--per-flow-algo", algo]
            torch.cuda.synchronize()
            substep_megakernel.launches = 0
            substep_megakernel.perflow_launches = 0
            t0 = time.perf_counter()
            on_card = cli.run_simulate(argv)
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
            n = substep_megakernel.perflow_launches
            d = substep_megakernel.launches
            steps = PERFLOW_SIM_MS // 100
            if label == "duration":
                check(n == 0 and d == steps, f"duration simulate: {d} "
                      f"launches, {n} per-flow")
                total["substep_megakernel"] += d
            else:
                check(n == 100 * steps and d == 0, f"{label} simulate: {n} "
                      f"per-flow launches for {100 * steps} substeps, {d} "
                      "duration")
                total["substep_megakernel_perflow"] += n
            substep_megakernel.launches = 0
            substep_megakernel.perflow_launches = 0
            on_cpu = cli.run_simulate(argv + ["--device", "cpu"])
            check(substep_megakernel.perflow_launches == 0
                  and substep_megakernel.launches == 0,
                  f"the CPU simulate ({label}) launched the kernel")
            for k in ("total_flows", "successful_flows", "dropped_flows",
                      "drop_reasons"):
                check(on_card[k] == on_cpu[k], f"simulate {label} {k}: "
                      f"card {on_card[k]}, cpu {on_cpu[k]}")
            check(math.isclose(on_card["avg_end2end_delay"],
                               on_cpu["avg_end2end_delay"],
                               rel_tol=SUB_RTOL, abs_tol=SUB_ATOL),
                  f"simulate {label} delay: card {on_card}, cpu {on_cpu}")
            runs[label] = on_card
            print(f"  simulate -d {PERFLOW_SIM_MS} {label}: card "
                  f"{json.dumps(on_card)} ({n or d} launches, "
                  f"{walls[label]:.3f} s wall on {smi}); the CPU's equal",
                  flush=True)
        sig = lambda r: (r["successful_flows"], r["dropped_flows"],
                         r["avg_end2end_delay"])
        check(len({sig(r) for r in runs.values()}) == 3,
              f"the three controllers gave {[sig(r) for r in runs.values()]}")
        for label in ("local", "spr"):
            r = runs[label]
            check(r["successful_flows"] > r["dropped_flows"],
                  f"{label} processed {r['successful_flows']}, dropped "
                  f"{r['dropped_flows']}")
        try:
            cli.run_simulate(base + ["-c", os.path.join(cfg, "simulator.yaml"),
                                     "--per-flow-algo", "spr"])
            check(False, "spr under the duration controller ran")
        except SystemExit:
            pass
        laps.lap("c simulate")

        # (d) prediction on the single-env path, and the canned backend
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
                                 f"episode_steps: {PREDICTION_STEPS}")
                    .replace("nb_steps_warmup_critic: 200",
                             f"nb_steps_warmup_critic: {PREDICTION_STEPS}")
                    + "gnn_impl: pallas\n")
        sim_pred = os.path.join(cfg, "sim_prediction.yaml")
        with open(os.path.join(cfg, "simulator.yaml")) as f:
            text = f.read()
        with open(sim_pred, "w") as f:
            f.write(text + "prediction: true\n")
        seen = {"obs": 0, "nonzero": 0}
        saved_obs = ServiceCoordEnv._obs

        def checked_obs(env, state, topo, traffic):
            obs = saved_obs(env, state, topo, traffic)
            col = env.agent.observation_space.index("ingress_traffic")
            p = predict_ingress_traffic(traffic, state.run_idx,
                                        env.sim_cfg.run_duration,
                                        env.limits.max_nodes)
            p = torch.clamp(p / (p.amax(-1, keepdim=True) + 1e-3), 0.0, 1.0)
            want = torch.where(topo.expand(state.batch).node_mask, p,
                               torch.zeros((), device=p.device))
            check(torch.equal(obs.nodes[..., col], want),
                  f"observation {seen['obs']}: the ingress column is not "
                  "the predicted traffic")
            seen["obs"] += 1
            seen["nonzero"] += int(bool((want > 0).any()))
            return obs

        for op in ops.values():
            op.launches = 0
        ServiceCoordEnv._obs = checked_obs
        try:
            res = cli.run_train(["--scheduler", sched, "--replicas", "1",
                                 "--seed", "0", "--episodes", "1",
                                 "--no-perf",
                                 "--agent-config", agent_yaml,
                                 "--simulator-config", sim_pred, "--service",
                                 os.path.join(cfg, "service_abc.yaml")])
        finally:
            ServiceCoordEnv._obs = saved_obs
        for k, op in ops.items():
            total[k] += op.launches
        check(seen["obs"] >= PREDICTION_STEPS and seen["nonzero"] > 0,
              f"prediction: {seen} observations checked")
        check(math.isfinite(res["trainer"].history[-1]["episodic_return"]),
              "the prediction episode's return is not finite")
        laps.lap("d prediction")
        env = res["trainer"].env
        dummy = DummyEngine(env.service, env.sim_cfg, env.limits)
        denv = ServiceCoordEnv(env.service, env.sim_cfg, env.agent,
                               env.limits, engine=dummy)
        t_ab, traffic = res["trainer"]._episode(0)
        es, obs = denv.reset(t_ab, traffic, batch=1)
        d0 = substep_megakernel.launches
        action = torch.full((1, env.limits.action_dim), 1.0, device=dev)
        es, obs, reward, _, info = denv.step(es, t_ab, traffic, action)
        check(substep_megakernel.launches == d0
              and math.isclose(float(info["succ_ratio"][0]), 0.8,
                               rel_tol=1e-6)
              and math.isclose(float(info["avg_e2e_delay"][0]), 20.0,
                               rel_tol=1e-6)
              and obs.nodes.device.type == "cuda",
              f"DummyEngine step on the card: {info}")
        print(f"  prediction: {seen['obs']} observations of a "
              f"{PREDICTION_STEPS}-step single-env episode and its "
              "evaluation, each ingress column the predicted traffic "
              f"({seen['nonzero']} non-zero); DummyEngine step on the card: "
              f"success {float(info['succ_ratio'][0]):.3f}, delay "
              f"{float(info['avg_e2e_delay'][0]):.1f} ms", flush=True)
        laps.lap("d dummy")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (e) times: a per-flow interval of the local policy against a
    # duration interval, and one per-flow launch against its bound
    timing = {}
    decide = local_decisions
    for b in PERFLOW_BATCHES:
        case = cases.perflow_random_case(batch=b, substeps=100)
        eng = case.engine
        topo, traffic = case.topo.to(dev), case.traffic.to(dev)
        st = eng.apply_per_flow(eng.init(b, dev), topo, traffic, decide)[0]
        interval = lambda: eng.apply_per_flow(st, topo, traffic, decide)
        wall = cuda_time_ms(interval, torch, reps=3, warmup=1)
        dev_ms, n_launch = profile_device_ms(interval, torch, reps=1,
                                             host_launches=True)
        mk_ms = profile_device_ms(interval, torch, reps=1,
                                  kernel="substep_megakernel_kernel")
        # one launch of the per-flow mode against its bound, and the
        # plain version's substep
        st1, topo1, cap = eng.begin_substep(st, topo.expand(b),
                                            traffic.expand(b))
        dec = decide(st1)
        one = lambda: substep_megakernel.launch(
            eng, st1, topo1, traffic.expand(b), cap, None, 1, dec)
        after = one()
        launch_ms = profile_device_ms(one, torch, reps=10,
                                      kernel="substep_megakernel_kernel")
        plain_ms = cuda_time_ms(lambda: substep_plain(
            eng, st1, topo1, traffic.expand(b), cap, None, 1, dec), torch,
            reps=2, warmup=1)
        bound_ms, bound_by, nbytes, _ = substep_bound(
            eng, st1, after, b, substeps=1, written=("placed", "sf_startup"),
            extra_bytes=dec.numel() * 4,
            skip=("schedule", "metrics.run_flow_counts"))
        # the duration controller's interval at the same B, same call
        dcase = cases.abilene_case(batch=b, intervals=2, seed=7)
        dstates = cases.run_case(dcase, dev)
        dtraffic = dcase.traffic.to(dev)
        dst, dcap = dcase.engine.begin_interval(
            dstates[-1], dtraffic, dcase.schedule.to(dev),
            dcase.placement.to(dev))
        dtopo = dcase.topo.to(dev).expand(b)
        dur = lambda: substep_megakernel.launch(dcase.engine, dst, dtopo,
                                                dtraffic, dcap)
        dur_wall = cuda_time_ms(dur, torch, reps=10, warmup=2)
        dur_dev = profile_device_ms(dur, torch, reps=5,
                                    kernel="substep_megakernel_kernel")
        idle = None if dev_ms is None else 1.0 - dev_ms / wall
        timing[b] = {"wall_ms": wall, "device_ms": dev_ms,
                     "megakernel_ms": mk_ms, "launches": n_launch,
                     "idle": idle, "launch_ms": launch_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "duration_wall_ms": dur_wall,
                     "duration_device_ms": dur_dev}
        print(f"  B={b:3d} per-flow interval (100 substeps, local policy): "
              f"{wall:.3f} ms wall, device {fmt(dev_ms)} (per-flow "
              f"launches {fmt(mk_ms)} each), {n_launch} kernel launches, "
              f"device idle share "
              f"{'not measured' if idle is None else f'{idle:.4f}'}; one "
              f"per-flow launch {fmt(launch_ms)} device, plain substep "
              f"{plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
              f"{nbytes} bytes); the duration interval {dur_wall:.4f} ms "
              f"wall, {fmt(dur_dev)} device, on {smi}", flush=True)
    print(f"  SPR episode (simulate -d {PERFLOW_SIM_MS}, B=1) "
          f"{walls['spr']:.3f} s wall, local {walls['local']:.3f} s, "
          f"duration {walls['duration']:.3f} s, on {smi}", flush=True)
    laps.lap("e times")
    print("phase 18 launches on the main path (each count 0 before its "
          "run): " + json.dumps(total), flush=True)
    print("phase 18 parts, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in laps.seconds.items())
          + f"; phase 18 {sum(laps.seconds.values()):.3f}", flush=True)
    t = timing[SUB_MAIN_BATCH]
    return total, worst, {"ms": t["launch_ms"], "plain_ms": t["plain_ms"],
                          "bound_ms": t["bound_ms"],
                          "bound_by": t["bound_by"]}


class PluginBuild:
    """``build_kernels``' handle on kernel #2's build with the generated
    header of ``cases.PLUGINS`` (or of the plugins named in ``ids``)."""

    def __init__(self, dev, ids=None):
        from gsc_tpu_torch.ops.substep import resource_plan
        from gsc_tpu_torch.sim import cases

        case = cases.with_plugins(cases.abilene_case(batch=1, intervals=1),
                                  tuple(ids or cases.PLUGINS))
        self.header = resource_plan(case.engine, dev)["rf_header"]

    def library(self):
        from gsc_tpu_torch.ops.substep import substep_megakernel

        return substep_megakernel.library(self.header)

    @property
    def build_log(self):
        from gsc_tpu_torch.ops.substep import substep_megakernel

        return substep_megakernel.plugin_build_log.get(self.header, "")


class ProbeBuild:
    """``build_kernels``' handle on the probe of ``csrc/rf_math.cuh``."""

    def library(self):
        from gsc_tpu_torch.ops.rf_math_probe import probe_library

        return probe_library()[0]

    @property
    def build_log(self):
        from gsc_tpu_torch.ops.rf_math_probe import probe_library

        return probe_library()[1]


def rf_grid(n, seed):
    """f32 loads for the math header's check: zeros, subnormals,
    negatives, 1e-30 to 1e30, infinities, NaN and the ranges where the
    functions bend."""
    import numpy as np

    rng = np.random.default_rng(seed)
    special = np.array([0.0, -0.0, 1.0, -1.0, 2.0, 0.5, 1e-40, -1e-40,
                        1e-45, -1e-45, 1e-30, -1e-30, 1e30, -1e30, np.inf,
                        -np.inf, np.nan, 88.7, 89.0, -103.0, -104.0, -0.25,
                        0.375, -0.999, 20.0, -20.0], np.float32)
    mag = 10.0 ** rng.uniform(-30, 30, n)
    return np.concatenate([
        special, (rng.standard_normal(n) * 10).astype(np.float32),
        (rng.random(n) * 4).astype(np.float32), mag.astype(np.float32),
        (-mag).astype(np.float32),
        rng.uniform(-110, 95, n).astype(np.float32)])


def plugin_cli_on_cpu(sim_argv, train_argv):
    """Phase 19 (f)'s CPU runs, in a process aside: ``cli simulate`` and
    ``cli train`` with ``--device cpu``; returns simulate's JSON, the
    training run's (episodes, replay sizes, cursors) and its returns."""
    from gsc_tpu_torch import cli

    sim = cli.run_simulate(sim_argv + ["--device", "cpu"])
    res = cli.run_train(train_argv + ["--device", "cpu"])
    history = res["trainer"].history
    return (sim, (len(history), res["buffers"].size.tolist(),
                  res["buffers"].pos.tolist()),
            [h["episodic_return"] for h in history])


def plugin_slice(torch, dev, smi, parent):
    """Phase 19: resource-function plugins compiled into kernel #2, under
    two sets: ``cases.PLUGINS`` and ``cases.MATH_PLUGINS`` (tanh, log1p,
    ``** 1.5``: the double forms of ``csrc/rf_math.cuh``).  (a) both
    plugin builds (nvcc seconds, ptxas registers and spills of every
    instantiation) and the header's functions on the card (the probe
    kernel) bit for bit against their plain version ``ops.rf_math`` over
    a grid of f32 loads; (b) the kernel under each set bit for bit
    against its plain version on CPU copies over the battery
    (``cases.all_cases``) and over the per-flow cases (the kPerFlow
    instantiation); (c) a plugin that does not trace raising on the card
    without running anywhere; (d) device time per interval at B=64 in
    alternating pairs, without plugins against ``PLUGINS`` and
    ``PLUGINS`` against ``MATH_PLUGINS``, the bounds and the plain
    engine; (e) the build without plugins against the parent's source in
    alternating pairs at B = 1, 64, 256 (where ``_parent/`` holds it) and
    both builds' registers; (f) ``cli simulate`` and ``cli train
    --replicas 4`` under ``--resource-functions-path`` with each set's
    files, on the card and on the CPU.  Returns (launches on the main
    path by kernel, each plugin build's numbers for the kernels line)."""
    import numpy as np

    from gsc_tpu_torch import cli
    from gsc_tpu_torch.config.registry import register_resource_function
    from gsc_tpu_torch.ops import rf_math
    from gsc_tpu_torch.ops.gat_attention import (gat_attention,
                                                 gat_attention_backward)
    from gsc_tpu_torch.ops.resource_codegen import \
        UnsupportedResourceFunction
    from gsc_tpu_torch.ops.rf_math_probe import card_values
    from gsc_tpu_torch.ops.substep import (resource_plan, substep_megakernel,
                                           substep_plain)
    from gsc_tpu_torch.sim import cases
    from gsc_tpu_torch.topology.synthetic import abilene, write_graphml

    laps = Laps()
    sub = substep_megakernel
    sets = {"plugins": tuple(cases.PLUGINS),
            "math": tuple(cases.MATH_PLUGINS)}
    # the CPU's plain runs of (b) and (f), started first in the processes
    # aside so that they run beside the card's work
    batteries, flows, aside, flows_aside = {}, {}, {}, {}
    for label, ids in sets.items():
        batteries[label] = [cases.with_plugins(case, ids) for case in
                            cases.all_cases(abilene_batch=PLUGIN_ABILENE_BATCH)]
        flows[label] = [cases.with_plugins(dataclasses.replace(
            case, substeps=min(case.substeps, PLUGIN_PERFLOW_SUBSTEPS)), ids)
            for case in cases.perflow_cases()]
        aside[label] = [on_cpu_aside(cases.run_case, case, "cpu", plain=True)
                        for case in batteries[label]]
        flows_aside[label] = [on_cpu_aside(cases.run_perflow_case, case,
                                           "cpu", plain=True)
                              for case in flows[label]]
    root = tempfile.mkdtemp(prefix="gsc_plugins_")
    cli_argv = {}
    cfg = os.path.join(root, "cfg")
    cli.init_configs(cfg)
    net = os.path.join(root, "abilene.graphml")
    write_graphml(abilene(), net)
    agent = os.path.join(root, "agent.yaml")
    with open(agent, "w") as f:
        f.write(PLUGIN_AGENT_YAML)
    for label, files in (("plugins", PLUGIN_FILES),
                         ("math", MATH_PLUGIN_FILES)):
        plug_dir = os.path.join(root, f"plugins_{label}")
        os.makedirs(plug_dir)
        for name, text in files.items():
            with open(os.path.join(plug_dir, name), "w") as f:
                f.write(text)
        svc = os.path.join(root, f"service_{label}.yaml")
        with open(svc, "w") as f:
            f.write(plugin_service_yaml(files))
        sim_argv = ["-d", str(PLUGIN_SIM_MS), "-n", net, "-sf", svc, "-c",
                    os.path.join(cfg, "simulator.yaml"),
                    "--resource-functions-path", plug_dir]
        train_argv = PLUGIN_TRAIN_ARGS + [
            "--agent-config", agent, "--service", svc,
            "--resource-functions-path", plug_dir, "--no-obs"]
        cli_argv[label] = (sorted(files), sim_argv, train_argv,
                           on_cpu_aside(plugin_cli_on_cpu, sim_argv,
                                        train_argv))

    # (a) the plugin builds (phase 2 built them beside the other kernels)
    probes, headers = {}, {}
    for label, ids in sets.items():
        probes[label] = cases.with_plugins(
            cases.abilene_case(batch=64, intervals=2, seed=7), ids)
        headers[label] = resource_plan(probes[label].engine,
                                       dev)["rf_header"]
        check(headers[label] is not None, f"the {label} case has no plugin "
              "header")
        t0 = time.perf_counter()
        sub.library(headers[label])
        print(f"  {label} build ({list(ids)}): "
              f"{sub.plugin_build_s.get(headers[label], 0.0):.2f} s of nvcc "
              f"({time.perf_counter() - t0:.2f} s now; "
              f"{len(headers[label])} bytes of generated header)",
              flush=True)
    regs = {}
    for what, log in (("no plugins", sub.build_log),
                      ("plugins", sub.plugin_build_log.get(
                          headers["plugins"], "")),
                      ("math plugins", sub.plugin_build_log.get(
                          headers["math"], "")),
                      ("parent", parent.build_log if parent else "")):
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        regs[what] = lines
        for ln in lines:
            print(f"  ptxas ({what}): {ln}", flush=True)
    x = rf_grid(20000, 5)
    rng = np.random.default_rng(6)
    y = np.where(rng.random(x.size) < 0.5, rng.choice(np.array(
        [0.0, -0.0, 1.5, -1.5, 2.0, 3.0, -3.0, np.inf, -np.inf, np.nan, 0.3,
         1e10], np.float32), x.size), rng.permutation(x)).astype(np.float32)
    got = card_values(torch.from_numpy(x).to(dev),
                              torch.from_numpy(y).to(dev)).cpu().numpy()
    want = rf_math.plain_values(x, y)
    same = (np.isnan(got) & np.isnan(want)) | (
        got.view(np.uint32) == want.view(np.uint32))
    bad = {name: int((~same[:, j]).sum())
           for j, name in enumerate(rf_math.PROBE_ORDER)}
    check(not any(bad.values()), f"rf_math.cuh on the card differs from "
          f"ops.rf_math: {bad}")
    print(f"  rf_math.cuh on the card (probe kernel): "
          f"{list(rf_math.PROBE_ORDER)} on {x.size} f32 loads (0, "
          f"subnormals, 1e-30..1e30, +-inf, NaN; pow against {y.size} "
          f"exponents) bit-equal to ops.rf_math", flush=True)
    laps.lap("a builds")

    # (b) the battery under each set, both instantiations
    worst = {label: 0.0 for label in sets}
    n0 = sub.plugin_launches
    for label, ids in sets.items():
        for case, cpu_run in zip(batteries[label], aside[label]):
            got = cases.run_case(case, dev)
            want = cpu_run.result()
            for i, (g, w) in enumerate(zip(got, want)):
                worst[label] = max(worst[label], cases.compare_states(
                    g, w, SUB_RTOL, SUB_ATOL, f"{case.name} interval {i}: "))
                check(cases.bit_equal(g.to("cpu"), w),
                      f"{case.name} interval {i}: the plugin build is not "
                      "bit-equal to the plain version on CPU copies")
        for case, cpu_run in zip(flows[label], flows_aside[label]):
            got = cases.run_perflow_case(case, dev)
            want = cpu_run.result()
            for i, (g, w) in enumerate(zip(got, want)):
                check(cases.bit_equal(g.to("cpu"), w),
                      f"{case.name} record {i}: the per-flow plugin build "
                      "is not bit-equal to the plain version on CPU copies")
        print(f"  battery under {list(ids)}: {len(batteries[label])} cases "
              f"and {len(flows[label])} per-flow cases bit-equal to the "
              "plain version on CPU copies", flush=True)
    check(sub.plugin_launches > n0, "no plugin launch in the battery")
    print(f"  battery: {sub.plugin_launches - n0} plugin launches",
          flush=True)
    laps.lap("b battery")

    # (c) a plugin that does not trace: refused on the card, and the
    # plugin never runs on a tensor in its place
    calls = []

    def branching(load):
        if isinstance(load, torch.Tensor):
            calls.append(load.device.type)
        return load if load.sum() > 0 else -load

    register_resource_function("case_branching")(branching)
    bad = cases.with_plugins(cases.abilene_case(batch=1, intervals=1),
                             ("case_branching",))
    try:
        cases.run_case(bad, dev)
        check(False, "a plugin that does not trace ran on the card")
    except UnsupportedResourceFunction as e:
        check("does not trace" in str(e), f"the refusal does not say it "
              f"does not trace: {e}")
        print(f"  refused on the card: {e}", flush=True)
    check(not calls, f"the refused plugin ran on {calls}")
    laps.lap("c refusal")

    # (d) one interval at B=64 without plugins and under each set, in
    # turns
    base = cases.abilene_case(batch=64, intervals=2, seed=7)
    b = base.batch

    def interval(case):
        states = cases.run_case(case, dev)
        eng = case.engine
        topo = case.topo.to(dev).expand(b)
        traffic = case.traffic.to(dev)
        st, cap = eng.begin_interval(states[-1], traffic,
                                     case.schedule.to(dev),
                                     case.placement.to(dev))
        return eng, st, topo, traffic, cap

    runs = {"none": interval(base), **{label: interval(probes[label])
                                       for label in sets}}
    launch = lambda k: sub.launch(*runs[k])
    numbers = {}
    turn_pairs = (("none", "plugins"), ("plugins", "math"))
    pairs = {}
    for first, second in turn_pairs:
        pairs[second] = alternating_pairs(lambda: launch(first),
                                          lambda: launch(second),
                                          "substep_megakernel_kernel", torch)
    for label in sets:
        eng, st, topo, traffic, cap = runs[label]
        after = launch(label)
        ms = cuda_time_ms(lambda: launch(label), torch, reps=20, warmup=3)
        plain_ms = cuda_time_ms(
            lambda: substep_plain(eng, st, topo, traffic, cap), torch,
            reps=1, warmup=0)
        bound_ms, bound_by, nbytes, _ = substep_bound(eng, st, after, b)
        p = pairs[label]
        numbers[label] = {
            "ms": p[1] if p else ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": worst[label],
            "build_s": sub.plugin_build_s.get(headers[label])}
        print(f"  B={b} per interval under {label}: {ms:.4f} ms (events, "
              f"wrapper included), plain engine {plain_ms:.2f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}: {nbytes} bytes) on {smi}",
              flush=True)
    for first, second in turn_pairs:
        p = pairs[second]
        turns = ("not measured" if p is None else
                 f"medians {first} {p[0]:.4f} ms, {second} {p[1]:.4f} ms "
                 f"({100 * (p[1] / p[0] - 1):+.2f}%), {second} faster in "
                 f"{p[2]} of {p[3]}")
        print(f"  B={b} device time per interval in {PARENT_PAIRS} "
              f"alternating pairs, {first} against {second}: {turns} on "
              f"{smi}", flush=True)
    laps.lap("d times")

    # (e) the build without plugins against the parent's source
    if parent is not None:
        for bb in SUB_TIMING_BATCHES:
            case = cases.abilene_case(batch=bb, intervals=2, seed=7)
            states = cases.run_case(case, dev)
            e2 = case.engine
            traffic2 = case.traffic.to(dev)
            st2, cap2 = e2.begin_interval(states[-1], traffic2,
                                          case.schedule.to(dev),
                                          case.placement.to(dev))
            topo2 = case.topo.to(dev).expand(bb)
            run_p = lambda: parent.launch(e2, st2, topo2, traffic2, cap2)
            run_c = lambda: sub.launch(e2, st2, topo2, traffic2, cap2)
            check(cases.bit_equal(run_p(), run_c()),
                  f"B={bb}: the parent's interval differs")
            pp = alternating_pairs(run_p, run_c,
                                   "substep_megakernel_kernel", torch)
            if pp is None:
                print(f"  B={bb}: alternating pairs not measured", flush=True)
                continue
            pm, cm, won, measured = pp
            print(f"  B={bb:3d} no-plugin build vs the parent, device time "
                  f"in {measured} alternating pairs: medians parent "
                  f"{pm:.4f} ms, this {cm:.4f} ms ({100 * (cm / pm - 1):+.2f}"
                  f"%), this faster in {won}; the same interval bit for bit "
                  f"on {smi}", flush=True)
    laps.lap("e parent")

    # (f) the CLI under --resource-functions-path, card and CPU, with each
    # set's files
    total = {"gat_attention": 0, "gat_attention_backward": 0,
             "substep_megakernel": 0, "substep_megakernel_plugin": 0,
             "substep_megakernel_plugin_math": 0}
    try:
        for label, (files, sim_argv, train_argv, cpu_run) in \
                cli_argv.items():
            key = ("substep_megakernel_plugin" if label == "plugins"
                   else "substep_megakernel_plugin_math")
            torch.cuda.synchronize()
            sub.launches = sub.plugin_launches = 0
            t0 = time.perf_counter()
            on_card = cli.run_simulate(sim_argv)
            torch.cuda.synchronize()
            sim_wall = time.perf_counter() - t0
            n_sim = sub.plugin_launches
            total[key] += n_sim
            check(n_sim == math.ceil(PLUGIN_SIM_MS / 100)
                  and sub.launches == 0,
                  f"simulate under {label}: {n_sim} plugin launches, "
                  f"{sub.launches} others (want one plugin launch per "
                  "interval)")
            for op in (gat_attention, gat_attention_backward):
                op.launches = 0
            sub.launches = sub.plugin_launches = 0
            t0 = time.perf_counter()
            res = cli.run_train(train_argv)
            train_wall = time.perf_counter() - t0
            ev = PLUGIN_EPISODE_STEPS
            steps = ev * int(PLUGIN_TRAIN_ARGS[PLUGIN_TRAIN_ARGS.index(
                "--episodes") + 1])
            n_train = sub.plugin_launches
            check(n_train == steps + ev and sub.launches == 0,
                  f"train under {label}: {n_train} plugin launches for "
                  f"{steps} env steps and {ev} evaluation steps, "
                  f"{sub.launches} others")
            total[key] += n_train
            total["gat_attention"] += gat_attention.launches
            total["gat_attention_backward"] += gat_attention_backward.launches
            on_cpu, cpu_ints, cpu_returns = cpu_run.result()
            for k in ("total_flows", "successful_flows", "dropped_flows",
                      "drop_reasons"):
                check(on_card[k] == on_cpu[k], f"simulate {label} {k}: card "
                      f"{on_card[k]} vs CPU {on_cpu[k]}")
            check(abs(on_card["avg_end2end_delay"]
                      - on_cpu["avg_end2end_delay"])
                  <= SUB_RTOL * abs(on_cpu["avg_end2end_delay"]) + SUB_ATOL,
                  f"simulate {label}: the mean delay differs between card "
                  "and CPU")
            print(f"  simulate -d {PLUGIN_SIM_MS} under {label} ({files}): "
                  f"card {json.dumps(on_card)} ({n_sim} plugin launches, "
                  f"{sim_wall:.3f} s wall); the CPU's integers equal",
                  flush=True)
            returns = [h["episodic_return"] for h in res["trainer"].history]
            check(all(math.isfinite(r) for r in returns + cpu_returns),
                  f"train under {label}: returns {returns} on the card, "
                  f"{cpu_returns} on the CPU")
            ints = (len(res["trainer"].history), res["buffers"].size.tolist(),
                    res["buffers"].pos.tolist())
            check(ints == cpu_ints,
                  f"train under {label}: episodes, replay sizes and cursors "
                  f"{ints} on the card, {cpu_ints} on the CPU")
            print(f"  train --replicas 4 under {label}: {n_train} plugin "
                  f"launches, {train_wall:.2f} s wall on the card; "
                  "episodes, replay sizes and cursors equal to the CPU "
                  "run's (the two devices draw other random numbers, so "
                  f"their returns differ: {returns[-1]:.3f} card, "
                  f"{cpu_returns[-1]:.3f} CPU)", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    laps.lap("f cli")
    print("phase 19 parts, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in laps.seconds.items()), flush=True)
    return total, numbers


def short_agent_yaml(root: str, steps: int) -> str:
    """The init-configs agent (``gnn_impl: pallas``) with episodes and
    warm-up of ``steps`` steps, written under ``root``."""
    from gsc_tpu_torch import cli

    cli.init_configs(os.path.join(root, "cfg"))
    path = os.path.join(root, f"agent{steps}.yaml")
    with open(os.path.join(root, "cfg", "agent.yaml")) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("episode_steps: 200", f"episode_steps: {steps}")
                .replace("nb_steps_warmup_critic: 200",
                         f"nb_steps_warmup_critic: {steps}")
                + "gnn_impl: pallas\n")
    return path


def async_agent_yaml(root: str) -> str:
    """Phase 20's and phase 25 (a)'s agent file under ``root``: the
    init-configs agent with episodes (and warm-up) of ASYNC_STEPS
    steps."""
    return short_agent_yaml(root, ASYNC_STEPS)


def frozen_argv(agent_yaml: str) -> list:
    """Phase 20 (b)'s run: one actor, publishing frozen (one burst at
    ``--learn-ratio 0.5``, which the replay does not depend on),
    exploration noise on."""
    return ["--agent-config", agent_yaml, *ASYNC_ARGS[:-4], "--episodes",
            str(ASYNC_FROZEN_EPISODES), "--seed", "0", "--async",
            "--async-actors", "1", "--publish-bursts", "1000000",
            "--learn-ratio", "0.5", "--no-obs"]


def async_slice(torch, dev, smi):
    """Phase 20: decoupled actor/learner training (``cli train --async``)
    at B=64.  (a) ``train_parallel`` and ``--async`` with 2 actor
    threads over the same episodes, each with phase 8's launch counts,
    the drain accounting and an adopted publish; (b) a single-actor run
    with publishing frozen, twice: the replay bit-identical; (c) a fault plan with an actor death and a poisoned
    block, both recovered.  Returns the launches on the main path by
    kernel, and what phase 25 compares with: (a)'s rows and (b)'s replay
    on the CPU."""
    from gsc_tpu_torch import cli
    from gsc_tpu_torch.ops.gat_attention import (gat_attention,
                                                 gat_attention_backward)
    from gsc_tpu_torch.ops.substep import substep_megakernel
    from gsc_tpu_torch.resilience.guard import all_finite

    ops = {"gat_attention": gat_attention,
           "gat_attention_backward": gat_attention_backward,
           "substep_megakernel": substep_megakernel}
    total = {k: 0 for k in ops}
    laps = Laps()
    root = tempfile.mkdtemp(prefix="gsc_async_")
    agent_yaml = async_agent_yaml(root)

    def counted(argv):
        for op in ops.values():
            op.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        own = ([] if "--agent-config" in argv
               else ["--no-obs", "--agent-config", agent_yaml])
        res = cli.run_train(argv + own)
        torch.cuda.synchronize()
        res["wall"] = time.perf_counter() - t0
        counts = {k: op.launches for k, op in ops.items()}
        for k, n in counts.items():
            total[k] += n
        return res, counts

    def check_counts(res, counts, what):
        agent = res["trainer"].agent_cfg
        steps = len(res["trainer"].history) * agent.episode_steps
        acting = sum(1 for g in range(steps)
                     if g >= agent.nb_steps_warmup_critic)
        info = res["trainer"].async_info
        bursts = info["bursts"] if info else len(res["trainer"].history)
        grad = bursts * (agent.learn_steps or agent.episode_steps)
        ev = agent.episode_steps
        want = {"substep_megakernel": steps + ev,
                "gat_attention": 3 * acting + 15 * grad + 3 * ev,
                "gat_attention_backward": 6 * grad}
        check(counts == want, f"{what}: launches {counts}, want {want}")

    def curve(res):
        r = [h["episodic_return"] for h in sorted(
            res["trainer"].history, key=lambda h: h["episode"])]
        return r[-1], sum(r) / len(r)

    # (a) the synchronous loop and 2 actor threads
    rows = {}
    sync, counts = counted(ASYNC_ARGS)
    check_counts(sync, counts, "train_parallel")
    eps = len(sync["trainer"].history)
    check(sync["trainer"].agent_cfg.episode_steps == ASYNC_STEPS,
          f"phase 20 ran {sync['trainer'].agent_cfg.episode_steps}-step "
          "episodes")
    steps = eps * ASYNC_STEPS * 64
    rows["sync"] = {"env_steps_s": steps / sync["summary"]["train_s"],
                    "bursts_s": eps / sync["summary"]["train_s"],
                    "curve": curve(sync)}
    # one actor thread is (b)'s and phase 25 (a)'s (a run with 1 actor
    # here gave way to phase 25 for the time limit)
    for n in (2,):
        res, counts = counted(ASYNC_ARGS + [
            "--async", "--async-actors", str(n), "--max-staleness",
            str(ASYNC_STALENESS)])
        check_counts(res, counts, f"--async with {n} actors")
        info = res["trainer"].async_info
        drain = res["summary"]["drain"]
        check(drain["produced_steps"] == drain["ingested_steps"] == steps
              and drain["transitions_lost"] == 0
              and drain["episodes_drained"] == eps
              and drain["bursts"] == eps,
              f"--async with {n} actors: drain {drain}")
        versions = [h["policy_version"] for h in res["trainer"].history]
        check(info["publishes"] >= 1 and max(versions) >= 1,
              f"--async with {n} actors: {info['publishes']} publishes, "
              f"acting versions {versions} (none adopted)")
        check(float(all_finite(res["state"])) == 1.0,
              f"--async with {n} actors: a non-finite learner state")
        rows[f"async{n}"] = {
            "env_steps_s": info["produced_steps"] / info["wall_s"],
            "bursts_s": info["bursts"] / info["wall_s"],
            "learner_idle_frac": info["learner_idle_frac"],
            "actor_idle_frac": info["actor_idle_frac"],
            "policy_lag_max": info["policy_lag_max"],
            "versions": versions, "curve": curve(res)}
    for label, row in rows.items():
        extra = "".join(f", {k} {row[k]}" for k in (
            "learner_idle_frac", "actor_idle_frac", "policy_lag_max",
            "versions") if k in row)
        print(f"  {label:6s} B=64, {eps} episodes: {row['env_steps_s']:.1f} "
              f"env-steps/s, {row['bursts_s']:.3f} bursts/s{extra}; "
              f"final-window return {row['curve'][0]:.3f}, AUC (mean "
              f"return) {row['curve'][1]:.3f} on {smi}", flush=True)
    laps.lap("a runs")

    # (b) one actor, publishing frozen: the replay bit for bit, twice
    # (phase 25 (a) holds two ranks' gathered replay against it)
    frozen_args = frozen_argv(agent_yaml)
    rings = []
    for _ in range(2):
        res, counts = counted(frozen_args)
        check_counts(res, counts, "frozen-publish run")
        check(res["trainer"].async_info["publishes"] == 0,
              "the frozen run published")
        rings.append(res["buffers"])

    same = lambda a, b: torch.equal(a.view(torch.uint8), b.view(torch.uint8))

    check(all(same(rings[0].data[k], rings[1].data[k])
              for k in rings[0].data)
          and torch.equal(rings[0].pos, rings[1].pos)
          and torch.equal(rings[0].size, rings[1].size),
          "two frozen-publish single-actor runs filled different replays")
    print(f"  frozen publish, 1 actor, {ASYNC_FROZEN_EPISODES} episodes: "
          f"two runs' replays bit-identical "
          f"({sum(d.numel() for d in rings[0].data.values())} elements)",
          flush=True)
    laps.lap("b frozen")

    # (c) an actor death and a poisoned block
    res, counts = counted(ASYNC_ARGS + [
        "--async", "--async-actors", "2", "--max-staleness",
        str(ASYNC_STALENESS), "--fault-plan", ASYNC_FAULT_PLAN])
    drain = res["summary"]["drain"]
    check(drain["actor_restarts"] >= 1 and drain["blocks_quarantined"] >= 1
          and drain["transitions_lost"] == 0
          and drain["episodes_drained"] == eps
          and float(all_finite(res["state"])) == 1.0,
          f"fault plan {ASYNC_FAULT_PLAN}: drain {drain}")
    print(f"  fault plan {ASYNC_FAULT_PLAN}: {drain['actor_restarts']} actor "
          f"restart, {drain['blocks_quarantined']} block quarantined, "
          f"{drain['produced_steps']} steps produced and ingested, final "
          "state finite", flush=True)
    laps.lap("c faults")
    print("phase 20 parts, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in laps.seconds.items()), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return total, {"rows": rows, "frozen_ring": rings[0].to("cpu")}


def acting_rows_witness(torch, out, same, smi):
    """Phase 21 (c)'s witness: a run's actor on the B acting rows of one
    rollout step without a mesh, against the same rows in the slices that
    2 and 4 ranks act on (B/2 and B/4 rows each).  Every replica's row
    goes through the same arithmetic, so bits that differ come from the
    row count, not from the mesh.  Prints which slicings keep the bits
    (the calls are comparisons: no count of the main path reads them)."""
    from gsc_tpu_torch.agents.buffer import restore_batch

    buf = out["buffers"]
    obs = restore_batch(buf.shapes, {k: d[:, 0] for k, d in
                                     buf.data.items()})["obs"]
    actor = out["state"].actor
    b = obs.nodes.shape[0]
    with torch.no_grad():
        whole = actor(obs)
        again = actor(obs)
        found = []
        for n in (2, 4):
            k = b // n
            parts = torch.cat([actor(obs.map(
                lambda t: t[i * k:(i + 1) * k])) for i in range(n)])
            diff = (parts.double() - whole.double()).abs().max().item()
            found.append(f"{n} slices of {k} rows "
                         f"{'equal' if same(parts, whole) else 'differ'} "
                         f"(largest difference {diff:.3e})")
    check(same(whole, again), "the actor is not deterministic on one input")
    print(f"  (c) witness: the actor on the {b} acting rows of one step, "
          f"twice: equal; against {'; '.join(found)}; on {smi}", flush=True)


def mesh_slice(torch, dev, smi):
    """Phase 21: ``train --mesh`` on the card (the docstring's (a)-(f)).
    Returns the launches on the main path by kernel, summed over ranks
    and runs."""
    import multiprocessing

    from gsc_tpu_torch import cli
    from gsc_tpu_torch.parallel.mesh import RankFailed, launch
    from gsc_tpu_torch.parallel.partition import state_leaves

    laps = Laps()
    root = tempfile.mkdtemp(prefix="gsc_mesh_smoke_")
    total = {}
    same = lambda a, b: torch.equal(a.reshape(-1).view(torch.uint8),
                                    b.reshape(-1).view(torch.uint8))

    def argv(warmup, episodes, *extra):
        path = os.path.join(root, f"agent{warmup}.yaml")
        with open(path, "w") as f:
            f.write(MESH_AGENT_YAML.format(warmup=warmup))
        return ["--agent-config", path, *MESH_ARGS, "--episodes",
                str(episodes), *extra]

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    def no_mesh(args):
        cli.zero_kernel_launches()
        out = cli.run_train(args)
        add(cli.kernel_launches())
        state = {k: v.detach().cpu() for k, v in
                 state_leaves(out["state"]).items()}
        return state, out["buffers"].to("cpu"), out

    def equal_states(a, b):
        return set(a) == set(b) and all(same(a[k], b[k]) for k in a)

    def equal_replays(a, b):
        return (set(a.data) == set(b.data)
                and all(same(a.data[k], b.data[k]) for k in a.data)
                and torch.equal(a.pos, b.pos) and torch.equal(a.size, b.size))

    def report(label, leg, startup=None):
        ranks = leg["ranks"]
        for r in ranks:
            for k in ("gat_attention", "gat_attention_backward",
                      "substep_megakernel"):
                check(r["launches"][k] > 0,
                      f"{label}: rank {r['rank']} launched no {k}")
            add(r["launches"])
        plan = ranks[0]["plan"]
        bursts = plan["burst_s"]
        # the ranks roll out side by side: every rank's env steps over the
        # slowest rank's rollout seconds
        rollout = (sum(r["plan"]["rollout_env_steps"] for r in ranks)
                   / max(r["plan"]["rollout_s"] for r in ranks))
        print(f"  {label}: {leg['summary']['sps']:.1f} env-steps/s (rollout "
              f"alone {rollout:.1f}), learn "
              f"burst {sum(bursts) / len(bursts):.3f} s, batch gather "
              f"{plan['gather_ms_per_step']:.4f} ms per gradient step, "
              f"start-up {[round(r['startup_s'], 2) for r in ranks]} s, "
              f"split leaves {[r['plan']['split_leaves'] for r in ranks]}, "
              f"resident bytes {[r['plan']['resident_bytes'] for r in ranks]}"
              f" of {plan['full_bytes']}, launches per rank "
              f"{[r['launches'] for r in ranks]} on {smi}", flush=True)

    def legs(n, runs, devices):
        t0 = time.perf_counter()
        per_rank = launch(cli.mesh_legs, n, 1, devices=devices,
                          deadline_s=MESH_DEADLINE_S, args=(runs,))
        wall = time.perf_counter() - t0
        outs = per_rank[0]
        for i, out in enumerate(outs):
            out["ranks"] = [rank[i]["rank"] for rank in per_rank]
        return outs, wall

    # (a) one rank on NCCL, and no mesh: the rank runs 1x1 several times
    # in its process, the first run in a process that has just started
    # (its CUDA context, cuBLAS handles and allocator warm up inside the
    # run), the later ones warm, as this process is for the runs without
    # a mesh
    warm = argv(200, 1, "--no-obs")
    ref_state, ref_replay, ref = no_mesh(warm)
    ones, wall = legs(1, [warm + ["--mesh", "1x1", "--partition-rules",
                                  "sharded"]] * MESH_ONE_RUNS, None)
    for i, one in enumerate(ones):
        check(one["ranks"][0]["backend"] == "nccl",
              "1x1 did not run on NCCL")
        check(equal_states(ref_state, one["state"])
              and equal_replays(ref_replay, one["buffers"]),
              "--mesh 1x1 differs from the run without a mesh")
        report(f"(a) 1x1 run {i + 1} of its process", one)
    print(f"  (a) 1x1 (NCCL) == no mesh, learner state and replay, "
          f"{MESH_ONE_RUNS} runs in one process ({wall:.1f} s); no mesh "
          f"{ref['summary']['sps']:.1f} env-steps/s, 1x1 "
          f"{[round(o['summary']['sps'], 1) for o in ones]} on {smi}",
          flush=True)
    laps.lap("a")

    # (b), (c) and (d)'s first run on 4 ranks sharing the card, then (b),
    # (c) and (d)'s resume on 2; past the warm-up, the warm-up episode and
    # one more (each ends in a learn burst)
    res = os.path.join(root, "res")
    ckpt_args = ["--result-dir", res, "--experiment-id", "mesh",
                 "--ckpt-interval", "1"]
    past = argv(50, 2, "--no-obs")
    four = [("(b) 2x2", argv(200, 1, *ckpt_args) + [
                "--mesh", "2x2", "--partition-rules", "sharded"]),
            ("(c) 4x1", past + ["--mesh", "4x1", "--partition-rules",
                                "sharded"]),
            ("(c) 2x2", past + ["--mesh", "2x2", "--partition-rules",
                                "sharded"])]
    # (g) first in the 2-rank processes: the cost ledger on a mesh
    perf_dir = os.path.join(root, "perf")
    two = [("(g) 2x1 --perf", argv(PERF_WARMUP, PERF_EPISODES,
                                   "--result-dir", perf_dir) + [
                "--mesh", "2x1", "--partition-rules", "sharded", "--perf"]),
           ("(b) 2x1", warm + ["--mesh", "2x1", "--partition-rules",
                               "sharded"]),
           ("(b) 1x2", warm + ["--mesh", "1x2", "--partition-rules",
                               "sharded"]),
           ("(b) 1x2 replicated", warm + ["--mesh", "1x2",
                                          "--partition-rules",
                                          "replicated"]),
           ("(d) 2x1 resumed", argv(200, 3, "--result-dir", res,
                                    "--experiment-id", "mesh",
                                    "--resume", "auto") + [
               "--mesh", "2x1", "--partition-rules", "sharded"])]
    runs = {}
    for n, group in ((4, four), (2, two)):
        outs, wall = legs(n, [a for _, a in group], ["cuda:0"] * n)
        print(f"  {n} ranks on one card (gloo): {len(group)} runs in "
              f"{wall:.1f} s", flush=True)
        for (label, _), out in zip(group, outs):
            runs[label] = out
            report(label, out)
    for label in ("(b) 2x2", "(b) 2x1", "(b) 1x2", "(b) 1x2 replicated"):
        check(equal_states(ref_state, runs[label]["state"]),
              f"{label}: the learner state differs from the run without a "
              "mesh within the warm-up")
        split = [r["plan"]["split_leaves"] for r in runs[label]["ranks"]]
        mp = int(label.split()[1].split("x")[1])
        if mp > 1 and "replicated" not in label:
            check(min(split) > 0, f"{label}: no leaf split")
        print(f"  {label} == no mesh (learner state); split leaves {split}",
              flush=True)
    laps.lap("b")
    past_state, _, past_ref = no_mesh(past)
    acting_rows_witness(torch, past_ref, same, smi)
    # (the 2-rank pair 2x1 == 1x2 gave way to the time limit)
    for a, b in (("(c) 4x1", "(c) 2x2"),):
        check(equal_states(runs[a]["state"], runs[b]["state"]),
              f"{a} and {b} end with different learner states")
        diff = max((runs[a]["state"][k].double()
                    - past_state[k].double()).abs().max().item()
                   for k in past_state)
        print(f"  {a} == {b} past the warm-up; largest difference to the "
              f"run without a mesh {diff:.3e}", flush=True)
    laps.lap("c")

    # (d) elastic resume: 2x2 -> 2x1 (above) and -> no mesh
    first, resumed = runs["(b) 2x2"], runs["(d) 2x1 resumed"]
    check([h["episode"] for h in resumed["history"]] == [1, 2],
          f"(d) 2x1 resumed ran episodes "
          f"{[h['episode'] for h in resumed['history']]}")
    _, _, plain = no_mesh(argv(200, 3, "--no-obs", "--resume",
                               first["summary"]["checkpoint"]))
    eps = [h["episode"] for h in plain["trainer"].history]
    check(eps == [1, 2], f"(d) no mesh resumed ran episodes {eps}")
    starts = {}
    for d, _, files in os.walk(res):
        if "events.jsonl" in files:
            with open(os.path.join(d, "events.jsonl")) as f:
                for line in f:
                    ev = json.loads(line)
                    if ev["event"] == "run_start":
                        starts[ev.get("mesh")] = ev
    check(set(starts) == {"2x2", "2x1"}
          and all(sum(e["partition_specs"].values()) > 0
                  for e in starts.values()),
          f"(d) run_start meshes {sorted(map(str, starts))}")
    print(f"  (d) 2x2 checkpoint -> --resume auto under 2x1 and with no "
          f"mesh: episodes [1, 2] in both; run_start meshes "
          f"{sorted(starts)}", flush=True)
    laps.lap("d")

    # (g) rank 0's ledger of the mesh run
    with open(os.path.join(perf_dir, "perf.json")) as f:
        doc = json.load(f)
    check(set(doc["entries"]) == {"chunk_step", "chunk_step_sharded",
                                  "learn_burst"},
          f"(g) entries {sorted(doc['entries'])}")
    check_perf_doc(torch, smi, "(g) --mesh 2x1", doc,
                   {"chunk_step", "chunk_step_sharded"})
    check(doc["entries"]["chunk_step_sharded"]["collectives"]["count"] > 0,
          "(g) the mesh's chunk_step_sharded recorded no collective")

    # (e) one card per rank on NCCL, where the machine has the cards
    cards = torch.cuda.device_count()
    if cards >= 2:
        group = [("(e) 2x1", two[1][1]),
                 ("(e) 1x2", warm + ["--mesh", "1x2", "--partition-rules",
                                     "sharded"])]
        outs, _ = legs(2, [a for _, a in group], None)
        if cards >= 4:
            more = [("(e) 4x1", warm + ["--mesh", "4x1",
                                        "--partition-rules", "sharded"]),
                    ("(e) 2x2", warm + ["--mesh", "2x2",
                                        "--partition-rules", "sharded"])]
            outs += legs(4, [a for _, a in more], None)[0]
            group += more
        for (label, _), out in zip(group, outs):
            check(out["ranks"][0]["backend"] == "nccl",
                  f"{label} did not run on NCCL")
            check(equal_states(ref_state, out["state"]),
                  f"{label} (NCCL) differs from (b)")
            report(label, out)
    else:
        print(f"  (e) not run: this machine has {cards} card (one card per "
              "rank on NCCL needs 2 or more); no leg moved elsewhere",
              flush=True)
    laps.lap("e")

    # (f) a rank that fails (the CPU-aside pool's workers are not ranks)
    others = set(multiprocessing.active_children())
    t0 = time.perf_counter()
    try:
        launch(cli.mesh_legs, 2, 1, devices=["cuda:0"] * 2,
               deadline_s=MESH_DEADLINE_S, fail_rank=1, args=([],))
        check(False, "(f) the launch with a failing rank returned")
    except RankFailed as e:
        check("injected failure in rank 1" in str(e),
              f"(f) the launch failed otherwise: {str(e)[-300:]}")
    took = time.perf_counter() - t0
    left = set(multiprocessing.active_children()) - others
    check(took < MESH_DEADLINE_S and not left,
          f"(f) {took:.1f} s, ranks left {left}")
    print(f"  (f) rank 1 raised: the launch failed in {took:.1f} s, no rank "
          "left running", flush=True)
    laps.lap("f")
    shutil.rmtree(root, ignore_errors=True)
    print("phase 21 parts, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in laps.seconds.items()), flush=True)
    return total


def bounds_as_before(torch, dev, smi):
    """Phase 22 (d): each kernel's bound as ``ops.cost`` counts it (the
    functions above) against the formulas this script held before the
    counts moved into the package (their text below, with the H100 SXM
    data sheet's rates as literals), at phase 3's shapes (f32 and bf16)
    and phase 7's batches: printed side by side, equal."""
    from gsc_tpu_torch.sim import cases
    from gsc_tpu_torch.sim.state import state_leaves
    from gsc_tpu_torch.ops.substep import substep_megakernel

    def least(nbytes, ops, bf16):
        t_bytes = nbytes / 3.35e12 * 1e3
        t_ops = ops / (989e12 if bf16 else 67e12) * 1e3
        return max(t_bytes, t_ops)

    def old_gat(args):
        xl, _, _, _, adj = args
        f = xl.shape[-1]
        nbytes = sum(t.numel() * t.element_size() for t in args) \
            + xl.numel() * xl.element_size()
        ops = (int(adj.sum()) * (6 * f + 3)
               + int(adj.any(dim=-1).sum()) * 2 * f)
        return least(nbytes, ops, xl.dtype == torch.bfloat16)

    def old_backward(args, grad):
        xl, xr, att, _, adj = args
        f = xl.shape[-1]
        nbytes = sum(t.numel() * t.element_size()
                     for t in (grad, xl, xr, att, adj)) \
            + 2 * xl.numel() * xl.element_size() + 2 * f * att.element_size()
        ops = (int(adj.sum()) * (14 * f + 7)
               + int(adj.any(dim=-1).sum()) * 3 * f)
        return least(nbytes, ops, xl.dtype == torch.bfloat16)

    def old_substep(engine, before, after, batch):
        read_only = ("sf_startup", "placed", "schedule")
        rings = ("rel_node", "rel_edge")
        nbytes = 0
        for name, t in state_leaves(before).items():
            if name == "run_idx" or name in rings:
                continue
            n = t.numel() * t.element_size()
            nbytes += n if name in read_only else 2 * n
        h, k = engine.H, engine.substeps
        g0 = torch.round(before.t / engine.dt).long() % h
        rows = torch.arange(h, device=g0.device)
        released = (rows[None] - g0[:, None]) % h < k
        for name in rings:
            a = getattr(before, name).reshape(batch, h, -1)
            z = getattr(after, name).reshape(batch, h, -1)
            touched = int((released | (a != z).any(-1)).sum())
            nbytes += 2 * touched * a.shape[-1] * a.element_size()
        nbytes += 3 * engine.N * engine.N * 4 + 2 * engine.E * 4 \
            + batch * engine.N * 4
        nbytes += int((after.cursor - before.cursor).sum()) * 7 * 4 \
            + k * batch * 4
        return least(nbytes, 2 * engine.M * k * batch, False)

    rows = []
    for shape in SHAPES:
        args = gat_inputs(*shape, 0, torch, dev)
        grad = torch.randn_like(args[0])
        for label, a, g in (("f32", args, grad),
                            ("bf16", (args[0].bfloat16(), args[1].bfloat16(),
                                      *args[2:]), grad.bfloat16())):
            rows.append((f"attention {label} {shape}", old_gat(a),
                         gat_bound(a)[0]))
            rows.append((f"attention backward {label} {shape}",
                         old_backward(a, g), gat_backward_bound(a, g)[0]))
    for b in SUB_TIMING_BATCHES:
        case = cases.abilene_case(batch=b, intervals=2, seed=7)
        eng = case.engine
        traffic = case.traffic.to(dev)
        st, cap = eng.begin_interval(cases.run_case(case, dev)[-1], traffic,
                                     case.schedule.to(dev),
                                     case.placement.to(dev))
        after = substep_megakernel.launch(eng, st, case.topo.to(dev).expand(b),
                                          traffic, cap)
        rows.append((f"substep B={b}", old_substep(eng, st, after, b),
                     substep_bound(eng, st, after, b)[0]))
    for label, old, new in rows:
        print(f"  bound {label}: before {old:.9f} ms, ops.cost {new:.9f} "
              "ms", flush=True)
        check(math.isclose(old, new, rel_tol=1e-12, abs_tol=0.0),
              f"the bound of {label} moved: {old} -> {new}")
    print(f"  (d) {len(rows)} bounds unchanged by the move into ops.cost "
          f"on {smi}", flush=True)


def profiler_losses(torch, dev, smi, rounds=PROFILE_ROUNDS):
    """Phase 22 (e): how often the card's profiler drops device records
    in this process: ``rounds`` profiles, each of the same 9 launches
    (kernel #1, a matmul and an add, three times) between two
    synchronizations, opened bare (``torch.profiler.profile`` right
    before the launches, without a primer: printed, no bound) and
    through ``analysis.launches.DeviceProfile`` (the
    ledger's, with its primer: no record of the work may be lost and
    every kernel launch call must have its device record).  Prints both
    counts, by kind, the primer's lost records, and the time each
    profile lost (``blind_s``) with, through ``DeviceProfile``, the
    primer's margin over it.  Returns the losses through
    ``DeviceProfile``."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from gsc_tpu_torch.analysis.launches import (PROFILE_PRIMER,
                                                 DeviceProfile,
                                                 profile_counts)
    from gsc_tpu_torch.ops.gat_attention import gat_attention

    xl, xr, att, bias, adj = gat_inputs(8, 24, 22, 0, torch, dev)
    m = torch.randn(64, 64, device=dev)
    want = {"gat_attention": 3, "gemm": 3, "other": 3}

    def work():
        for _ in range(3):
            gat_attention(xl, xr, att, bias, adj)
            m @ m
            m.add_(0.0)

    def short(counts):
        return any(counts.by_kind[k] < n for k, n in want.items())

    def ms(values, q):
        return f"{np.quantile(values, q) * 1e3:.3f}" if values else "none"

    work()
    out = {}
    for how in ("bare", "DeviceProfile"):
        lost, by_kind, unmatched, primer = [], {}, 0, []
        blind, margin = [], []
        for r in range(rounds):
            if how == "bare":
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as p:
                    work()
                    torch.cuda.synchronize()
                counts = profile_counts(p)
            else:
                with DeviceProfile(dev) as dp:
                    work()
                counts = dp.counts
            unmatched += counts.unmatched
            primer.append(counts.primer_lost)
            if counts.blind_s is not None:
                blind.append(counts.blind_s)
            if counts.guard_s is not None and counts.blind_s is not None:
                margin.append(counts.guard_s - counts.blind_s)
            if short(counts) or counts.unmatched:
                lost.append(r)
                for k, n in want.items():
                    by_kind[k] = by_kind.get(k, 0) + max(
                        n - counts.by_kind[k], 0)
        print(f"  (e) {how}: {len(lost)} of {rounds} profiles kept fewer "
              f"than the 9 device records (rounds {lost[:10]}), records "
              f"lost by kind {by_kind}, kernel launch calls without a "
              f"device record {unmatched}; primer records lost per "
              f"profile: min {min(primer)}, max {max(primer)}, the whole "
              f"primer in {sum(p == PROFILE_PRIMER for p in primer)}; "
              f"blind ms (first launch call to first kept device record) "
              f"p50 {ms(blind, 0.5)}, p90 {ms(blind, 0.9)}, p99 "
              f"{ms(blind, 0.99)}, max {ms(blind, 1.0)}; primer margin ms "
              f"(its cover less the blind time) min {ms(margin, 0.0)}, "
              f"p1 {ms(margin, 0.01)}, p50 {ms(margin, 0.5)}; on {smi}",
              flush=True)
        out[how] = (len(lost), unmatched)
    check(out["DeviceProfile"] == (0, 0),
          f"(e) DeviceProfile (primer {PROFILE_PRIMER}) lost device "
          f"records in {out['DeviceProfile'][0]} of {rounds} profiles")
    return out["DeviceProfile"][0]


def check_perf_doc(torch, smi, label, doc, timed, timed_buckets=None):
    """One ``perf.json`` of phases 21 (g) and 22: schema 1 on the card,
    its name and power limit, the H100 SXM peaks; every entry available
    and whole (``launches`` and ``device_s`` recorded: each kernel launch
    call matched to its device record and the hand kernels' records
    equal to their wrappers' posts), and every entry of ``timed`` (and
    every served bucket that was dispatched) 0 < mfu <= PERF_MFU_MAX;
    prints each entry's counts, host syncs, device and capture seconds
    and MFU.  Served buckets with an MFU join ``timed_buckets``."""
    check(doc["schema_version"] == 1 and doc["backend"] == "gpu",
          f"{label}: perf.json schema/backend {doc['schema_version']} "
          f"{doc['backend']}")
    card = doc["card"] or {}
    check(card.get("name") == torch.cuda.get_device_name(0)
          and card.get("power_limit"), f"{label}: card {card}")
    check(doc["peaks"] is not None,
          f"{label}: no peaks for {card.get('name')}")
    for name, e in sorted(doc["entries"].items()):
        check(e.get("available"), f"{label} {name}: {e.get('error')}")
        check(e["fusions"] is None and e["kernels"],
              f"{label} {name}: fusions {e['fusions']}, hand kernels "
              f"{e['kernels']}")
        check(e["launches"] is not None and e["device_s"] is not None,
              f"{label} {name}: launches {e['launches']}, device_s "
              f"{e['device_s']} ({e.get('no_profile')})")
        kinds = e["launches"]["by_kind"]
        for k, rec in e["kernels"].items():
            check(kinds.get(k, 0) == rec["launches"],
                  f"{label} {name}: the profiler saw {kinds.get(k, 0)} "
                  f"{k} launches, the wrappers posted {rec['launches']}")
        mfu = e.get("mfu")
        if name in timed or (name.startswith("serve_policy_b")
                             and e.get("dispatches")):
            check(mfu is not None and 0 < mfu <= PERF_MFU_MAX,
                  f"{label} {name}: mfu {mfu}")
        if name.startswith("serve_policy_b") and mfu \
                and timed_buckets is not None:
            timed_buckets.add(name)
        print(f"  {label} {name}: {e['flops']:.6g} FLOP, "
              f"{e['bytes_accessed']:.6g} bytes, "
              f"{e['launches']['count']} launches {kinds}, "
              "hand kernels "
              f"{ {k: r['launches'] for k, r in e['kernels'].items()} }, "
              f"host_syncs {e['host_syncs']}, device_s {e['device_s']}, "
              f"capture_s {e['capture_s']}, collectives "
              f"{e['collectives']['count']} ({e['collectives']['bytes']} "
              f"bytes); {e.get('dispatches')} timed dispatches, wall "
              f"{e.get('wall_s_mean')} s each, mfu {mfu}, primer margin "
              f"{e.get('profile_margin_s')} s on {smi}", flush=True)


def perf_slice(torch, dev, smi, monitor):
    """Phase 22: the device-cost ledger and the runtime sentinels.  (a)
    the flagship single env (``MESH_AGENT_YAML``, warm-up PERF_WARMUP,
    PERF_EPISODES episodes of 50 steps, f32) through ``cli.run_train``
    with ``--perf`` (its ``--no-perf`` twin gave way to the time limit;
    tests/test_torch_perf_obs.py holds the checkpoints byte-equal
    with and without the ledger on the CPU); (b) ``--replicas 64 --chunk
    50`` under ``assert_no_retrace`` (a run after (a) builds and loads
    nothing; a forced load inside the guard trips it) (the mesh's ledger
    is phase 21 (g)'s, in its rank processes); (c)
    the seeded-actor server in phase 4's bursts, one observer each.
    Every ``perf.json`` passes ``check_perf_doc`` (every fused training
    entry timed; every bucket in at least one burst; every entry
    whole).  ``monitor``, started before
    phase 2's builds, holds a ``compile`` event of every library.  (d)
    ``bounds_as_before``; (e) ``profiler_losses``.  Returns the path's
    kernel launches."""
    from gsc_tpu_torch import cli
    from gsc_tpu_torch.analysis import RetraceError, assert_no_retrace
    from gsc_tpu_torch.analysis.sentinels import library_source
    from gsc_tpu_torch.obs import RunObserver
    from gsc_tpu_torch.ops.build import build_library
    from gsc_tpu_torch.ops.gat_attention import SOURCE as GAT_SOURCE
    from gsc_tpu_torch.serve import run_serve

    laps = Laps()
    total = {}
    root = tempfile.mkdtemp(prefix="gsc_perf_")
    yml = os.path.join(root, "agent.yaml")
    with open(yml, "w") as f:
        f.write(MESH_AGENT_YAML.format(warmup=PERF_WARMUP))
    base = ["--agent-config", yml, "--seed", "0", "--episodes",
            str(PERF_EPISODES)]

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    def run(label, argv):
        cli.zero_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cli.run_train(argv + ["--result-dir",
                                    os.path.join(root, label)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        add(cli.kernel_launches())
        return out, wall

    def perf_doc(label):
        with open(os.path.join(root, label, "perf.json")) as f:
            return json.load(f)

    timed_buckets = set()
    entries = [0]

    def check_doc(label, doc, timed):
        check_perf_doc(torch, smi, label, doc, timed, timed_buckets)
        entries[0] += len(doc["entries"])

    # (a) the single env with the ledger
    on, wall_on = run("single", base)
    with open(os.path.join(root, "single", "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    costs = [ev["fn"] for ev in events if ev["event"] == "compile_cost"]
    check(costs == ["episode_step"], f"compile_cost events {costs}")
    start = [ev for ev in events if ev["event"] == "run_start"][0]
    check(start["perf"] is True and start["compile_events"] is True,
          f"run_start perf {start['perf']}, compile_events "
          f"{start['compile_events']}")
    check_doc("(a) single env", perf_doc("single"), {"episode_step"})
    # the observed dispatch (the run's first) builds the device tables
    # without a sync and reads nothing back: 0 per env step
    syncs = perf_doc("single")["entries"]["episode_step"]["host_syncs"]
    check(syncs == 0, f"(a) the single-env episode_step made {syncs} host "
          "syncs")
    print(f"  (a) single-env episode_step: host_syncs {syncs} in one "
          f"observed episode with its burst (0 per env step) on {smi}",
          flush=True)
    print(f"  (a) train_s {on['summary']['train_s']:.3f}, wall "
          f"{wall_on:.3f} s", flush=True)
    laps.lap("a")

    # (b) 64 replicas: this process builds and loads nothing more
    with assert_no_retrace():
        rep, wall_rep = run("replicas", base + ["--replicas", "64",
                                                "--chunk", "50"])
    tripped = False
    try:
        with assert_no_retrace("gat_attention"):
            build_library(GAT_SOURCE)
    except RetraceError:
        tripped = True
    check(tripped, "assert_no_retrace did not trip on a forced load")
    check_doc("(b) --replicas 64", perf_doc("replicas"), {"chunk_step"})
    print(f"  (b) the run under assert_no_retrace, a forced load tripped it",
          flush=True)
    laps.lap("b")

    # (c) serving, phase 4's bursts
    for r, c, deadline in BURSTS:
        label = f"serve_c{c}"
        cli.zero_kernel_launches()
        run_serve(device=dev, pool_steps=POOL_STEPS, requests=r,
                  concurrency=c, buckets=BUCKETS, deadline_ms=deadline,
                  seed=0, seeded_actor=True,
                  observer=RunObserver(os.path.join(root, label), perf=True))
        add(cli.kernel_launches())
        doc = perf_doc(label)
        check(sorted(doc["entries"]) == sorted(f"serve_policy_b{b}"
                                               for b in BUCKETS),
              f"{label}: entries {sorted(doc['entries'])}")
        check_doc(f"(c) serve c={c}", doc, set())
    check(timed_buckets == {f"serve_policy_b{b}" for b in BUCKETS},
          f"buckets timed {sorted(timed_buckets)}")
    laps.lap("c")

    # the monitor started before phase 2's builds: a compile event of
    # every library, plugin headers included
    seen = monitor.snapshot()
    sources = {library_source(fn) for fn in seen}
    for want in ("gat_attention", "gat_attention_backward",
                 "substep_megakernel", "resource_plugins"):
        check(want in sources, f"no compile event of {want}: {seen}")
    print(f"  compile events (builds, loads) per library: {seen}; "
          f"{entries[0]} ledger entries, every one whole (launches and "
          "device_s)", flush=True)

    # (d) the bounds, before and after the move into the package
    bounds_as_before(torch, dev, smi)
    laps.lap("d")
    # (e) the profiler's own losses in this process
    profiler_losses(torch, dev, smi)
    laps.lap("e")
    print("  phase 22 parts: " + ", ".join(
        f"({k}) {v:.1f} s" for k, v in laps.seconds.items()), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return total


class SyncRecorder:
    """While entered, records without raising every synchronizing CUDA
    operation of this thread (``analysis.launches.SyncWatch``) and every
    read of a tensor's value into Python (``aten._local_scalar_dense``),
    each keyed by what it was and the innermost package frames that made
    it; ``hits`` maps (what, where) to a count."""

    def __init__(self):
        self.hits = {}

    def _add(self, what):
        import traceback

        frames = [f for f in traceback.extract_stack()
                  if "gsc_tpu_torch" in f.filename]
        where = " <- ".join(
            f"{f.filename.split('gsc_tpu_torch/')[-1]}:{f.lineno}"
            for f in reversed(frames[-4:])) or "outside the package"
        key = (what.splitlines()[0][:90], where)
        self.hits[key] = self.hits.get(key, 0) + 1

    def __enter__(self):
        import threading

        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        from gsc_tpu_torch.analysis.launches import SyncWatch

        rec = self

        class Reads(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func is torch.ops.aten._local_scalar_dense.default:
                    rec._add("a value read into Python")
                return func(*args, **(kwargs or {}))

        self._watch = SyncWatch({threading.get_ident()}, self._add).start()
        self._mode = Reads()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._watch.stop()
        return False


def sync_region(torch, dev, smi, graph):
    """Phase 23 (d): the single-env dispatch region of
    tests/test_torch_no_host_sync.py at the flagship widths, in graph
    mode (``graph`` true, the attention kernels) or flat mode: traffic
    sampled beforehand, episode 0 outside, then episodes 1-3 of
    SYNC_STEPS steps with their bursts (``env.reset`` plus
    ``episode_step``), 1 under ``SyncRecorder`` (nothing may be
    recorded), 2 under ``no_host_sync``, 3 under
    ``torch.cuda.set_sync_debug_mode("error")``; the stats drained after
    the region.  Returns the recorded episode's wall seconds."""
    from gsc_tpu_torch.agents.trainer import Trainer, _first
    from gsc_tpu_torch.analysis import no_host_sync
    from gsc_tpu_torch.config import (abc_service, init_configs_agent,
                                      init_configs_sim)
    from gsc_tpu_torch.config.schema import EnvLimits
    from gsc_tpu_torch.env.driver import EpisodeDriver
    from gsc_tpu_torch.env.env import ServiceCoordEnv
    from gsc_tpu_torch.topology import synthetic
    from gsc_tpu_torch.topology.compiler import compile_topology

    mode = "graph" if graph else "flat"
    agent = init_configs_agent(gnn_impl="pallas", graph_mode=graph,
                               episode_steps=SYNC_STEPS,
                               nb_steps_warmup_critic=SYNC_STEPS)
    sim, service = init_configs_sim(), abc_service()
    env = ServiceCoordEnv(service, sim, agent,
                          EnvLimits.for_service(service))
    topo = compile_topology(synthetic.abilene(), max_nodes=24, max_edges=37)
    driver = EpisodeDriver.single(topo, sim, service, SYNC_STEPS, "abilene",
                                  base_seed=0)
    trainer = Trainer(env, driver, agent, seed=0, device=dev)
    ddpg, draws = trainer.ddpg, trainer.draws
    episodes = [trainer._episode(e) for e in range(4)]
    state = trainer.init_state()
    _, obs0 = env.reset(*episodes[0], batch=1)
    ring = ddpg.init_buffer(_first(obs0))

    def episode(ep):
        es, obs = env.reset(*episodes[ep], batch=1)
        return ddpg.episode_step(state, ring, es, obs, *episodes[ep],
                                 ep * SYNC_STEPS, draws, learn=True)

    outs = [episode(0)]
    torch.cuda.synchronize()
    rec = SyncRecorder()
    t0 = time.perf_counter()
    with rec:
        outs.append(episode(1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with no_host_sync(f"phase 23 (d) {mode} episode"):
        outs.append(episode(2))
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs.append(episode(3))
    finally:
        torch.cuda.set_sync_debug_mode(before)
    for site, n in sorted(rec.hits.items(), key=lambda kv: -kv[1]):
        print(f"    (d) {mode}: {n} x {site[0]} at {site[1]}", flush=True)
    check(not rec.hits, f"the {mode}-mode single-env region synchronised "
          f"{sum(rec.hits.values())} times in {SYNC_STEPS} env steps")
    # the drain, after the region
    for ep, out in enumerate(outs):
        stats, metrics = out[4], out[5]
        check(math.isfinite(float(stats["episodic_return"]))
              and math.isfinite(float(metrics["critic_loss"]))
              and float(stats["state_finite"]) == 1.0
              and float(metrics["state_finite"]) == 1.0,
              f"(d) {mode} episode {ep}: stats {stats}, metrics {metrics}")
    print(f"  (d) {mode} mode: episode_step with its burst ({SYNC_STEPS} env "
          f"steps, {SYNC_STEPS} gradient steps): 0 synchronizing CUDA "
          "operations and 0 values read into Python (host_syncs 0 per env "
          "step); no_host_sync and set_sync_debug_mode('error') held; the "
          f"recorded episode took {wall:.3f} s on {smi}", flush=True)
    return wall


def flat_perflow(torch, dev, smi, root, yaml_of, counted, ck_a):
    """Phase 23 (e)-(g) (see the module docstring): a flat agent under
    per-flow control at B=64 and on one env, and a flat trainer
    publishing into a two-worker fleet serving ``ck_a``."""
    import threading

    from gsc_tpu_torch import cli
    from gsc_tpu_torch.config.loader import load_agent
    from gsc_tpu_torch.obs import RunObserver
    from gsc_tpu_torch.ops.substep import substep_megakernel, substep_plain
    from gsc_tpu_torch.serve import (GreedyServePolicy, load_version,
                                     read_latest, run_serve)
    from gsc_tpu_torch.sim import cases

    steps = FLAT_PERFLOW_STEPS
    y_pf = yaml_of(steps)
    cfg = os.path.join(root, "cfg")
    cli.init_configs(cfg)
    sim_pf = os.path.join(root, "simulator_per_flow.yaml")
    with open(os.path.join(cfg, "simulator.yaml")) as f:
        text = f.read()
    with open(sim_pf, "w") as f:
        f.write(text + "controller: per_flow\n")

    # (e) 64 replicas under per-flow control
    kept = {}
    launch = substep_megakernel.launch

    def keep(engine, state, *a):
        out = launch(engine, state, *a)
        if state.batch == FLAT_REPLICAS:
            kept["args"], kept["out"] = (engine, state, *a), out
        return out

    substep_megakernel.launch = keep
    cli.zero_kernel_launches()
    t0 = time.perf_counter()
    try:
        res = cli.run_train(["--agent-config", y_pf, "--simulator-config",
                             sim_pf, "--replicas", str(FLAT_REPLICAS),
                             "--chunk", str(steps), "--episodes", "1",
                             "--seed", "0", "--no-perf", "--result-dir",
                             os.path.join(root, "e")])
    finally:
        del substep_megakernel.launch
    wall = time.perf_counter() - t0
    counts = counted()
    trainer = res["trainer"]
    check(trainer.env.sim_cfg.controller == "per_flow"
          and not trainer.agent_cfg.graph_mode,
          "(e) not a flat agent under per-flow control")
    row = trainer.history[-1]
    check(all(math.isfinite(row[k]) for k in ("episodic_return",
                                              "critic_loss")),
          f"(e) {row}")
    check(counts["substep_megakernel"] == 2 * steps,
          f"(e) {counts['substep_megakernel']} kernel #2 launches for "
          f"{steps} env steps and {steps} evaluation steps")
    engine, *args = kept["args"]
    check(engine.cfg.controller == "per_flow", "(e) the kept launch ran "
          "without the idle-instance expiry")
    on_cpu = [a.to("cpu") if hasattr(a, "to") else a for a in args]
    check(cases.bit_equal(kept["out"].to("cpu"),
                          substep_plain(engine, *on_cpu)),
          "(e) a B=64 per-flow launch of the flat run is not bit-equal to "
          "the plain version on CPU copies")
    print(f"  (e) flat train --replicas {FLAT_REPLICAS} under per-flow "
          f"control, 1 episode of {steps} steps: return "
          f"{row['episodic_return']:.4f}, critic loss {row['critic_loss']}, "
          f"evaluation {res['summary']['mean_return']:.4f}; "
          f"{row['sps']:.1f} env-steps/s, wall {wall:.1f} s on {smi}; "
          f"kernel #2 launches {counts['substep_megakernel']} (the gc "
          f"switch on), one B={FLAT_REPLICAS} launch bit-equal to the plain "
          "version on CPU copies", flush=True)

    # (f) one env under per-flow control, then infer
    cli.zero_kernel_launches()
    res_f = cli.run_train(["--agent-config", y_pf, "--simulator-config",
                           sim_pf, "--episodes", "1", "--seed", "0",
                           "--no-perf", "--result-dir",
                           os.path.join(root, "f")])
    res_i = cli.run_infer(["--agent-config", y_pf, "--simulator-config",
                           sim_pf, "--seed", "0", "--checkpoint",
                           res_f["summary"]["checkpoint"], "--episodes",
                           "1"])
    counts_f = counted()
    ev = {k: res_f["summary"][k] for k in ("mean_return",
                                           "final_succ_ratio")}
    check(all(res_i["eval"][k] == v for k, v in ev.items()),
          f"(f) infer {res_i['eval']} differs from the run's own "
          f"evaluation {ev}")
    check(counts_f["substep_megakernel"] == 3 * steps,
          f"(f) {counts_f['substep_megakernel']} kernel #2 launches for "
          f"{steps} training, evaluation and infer steps each")
    row_f = res_f["trainer"].history[-1]
    print(f"  (f) flat single env under per-flow control, 1 episode of "
          f"{steps} steps: return {row_f['episodic_return']:.4f}, "
          f"{row_f['sps']:.1f} env-steps/s on {smi}; infer "
          f"{json.dumps(res_i['eval'])} equal to the run's own "
          f"evaluation; kernel #2 launches {counts_f['substep_megakernel']}",
          flush=True)

    # (g) a flat trainer publishing into a two-worker fleet
    episodes, conc, poll, warm = FLAT_TWS
    pub = os.path.join(root, "publish")
    obs = RunObserver(None)
    stop = threading.Event()
    out = {}

    def fleet():
        try:
            out["report"] = run_serve(
                load_agent(yaml_of(FLAT_STEPS)), device=dev,
                checkpoint=ck_a, workers=2, continuous=True, requests=conc,
                concurrency=conc, buckets=BUCKETS, deadline_ms=5.0,
                pool_steps=POOL_STEPS, seed=0, hot_swap_dir=pub,
                swap_poll_s=poll, observer=obs, until=stop)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    cli.zero_kernel_launches()
    server = threading.Thread(target=fleet, name="phase23-fleet",
                              daemon=True)
    server.start()
    t_wait = time.perf_counter() + 120.0
    while obs.hub.get_counter("serve_requests_total") < warm \
            and server.is_alive() and time.perf_counter() < t_wait:
        time.sleep(0.01)
    check(server.is_alive(), f"(g) the fleet stopped: {out.get('error')}")
    t_train = time.perf_counter()
    trained = cli.run_train([
        "--agent-config", y_pf, "--replicas", str(FLAT_REPLICAS),
        "--chunk", str(steps), "--episodes", str(episodes), "--seed", "0",
        "--no-perf", "--hot-swap-dir", pub, "--publish-interval", "1"])
    t_trained = time.perf_counter()
    t_wait = time.perf_counter() + 30.0
    while min(obs.hub.get_gauge("serve_policy_version", worker=w) or 0
              for w in ("w0", "w1")) < episodes \
            and time.perf_counter() < t_wait:
        time.sleep(0.01)
    n0 = obs.hub.get_counter("serve_requests_total")
    while obs.hub.get_counter("serve_requests_total") < n0 + warm \
            and time.perf_counter() < t_wait:
        time.sleep(0.01)
    stop.set()
    server.join(300.0)
    check(not server.is_alive() and "error" not in out,
          f"(g) the flat fleet failed: {out.get('error')}")
    counts_g = counted()
    rep = out["report"]
    summ = rep.summary()
    check(not rep.errors and rep.rejected == 0,
          f"(g) {len(rep.errors)} errors ({rep.errors[:3]}), "
          f"{rep.rejected} rejections")
    swaps = obs.events.of_kind("weight_swap")
    adopted = {(s["worker"], s["version"]) for s in swaps}
    want = {(w, v) for w in ("w0", "w1") for v in range(1, episodes + 1)}
    check(adopted == want and len(swaps) == len(want),
          f"(g) adopted (worker, version) {sorted(adopted)}, want every "
          "published version once by each worker")
    latest = read_latest(pub)
    check(latest["version"] == episodes
          and latest["meta"] == {"episode": episodes},
          f"(g) the trainer published {latest}")
    check(not trained["trainer"].agent_cfg.graph_mode,
          "(g) the trainer is not flat")
    versions = {}
    for v in range(1, episodes + 1):
        with open(os.path.join(pub, f"v{v:05d}.json")) as f:
            leaves = load_version(pub, json.load(f))
        versions[v] = GreedyServePolicy(rep.ddpg, rep.pool[0]).stage(leaves,
                                                                     v)
    versions[0] = rep.ddpg.actor
    check({v for v, *_ in rep.stamps} == set(versions),
          f"(g) answers came under versions "
          f"{sorted({v for v, *_ in rep.stamps})}, want all of "
          f"{sorted(versions)}")
    singles = served_at_bucket(rep, versions.__getitem__, torch, dev)
    before = [lat for _, _, t, lat in rep.stamps if t < t_train]
    during = [lat for _, _, t, lat in rep.stamps if t_train <= t < t_trained]
    pb, pd = percentiles(before), percentiles(during)
    swap_ms = [s["swap_ms"] for s in swaps]
    check(counts_g["substep_megakernel"] > 0, f"(g) launched {counts_g}")
    print(f"  (g) flat train --replicas {FLAT_REPLICAS} --hot-swap-dir, "
          f"{episodes} episodes of {steps} steps, one publish per episode, "
          f"{t_trained - t_train:.3f} s, beside 2 continuous workers at "
          f"concurrency {conc}: {summ['completed']} requests, "
          f"{summ['rps']:.1f} req/s, 0 errors, 0 rejections on {smi}; "
          f"p50/p99 before training {pb[0]:.3f}/{pb[1]:.3f} ms over "
          f"{len(before)} requests, while training {pd[0]:.3f}/{pd[1]:.3f} "
          f"ms over {len(during)}; each version adopted once by each "
          f"worker, swap_ms {[round(x, 3) for x in swap_ms]}; every answer "
          "bit-identical to a single-shot call under its stamped version "
          f"({singles} calls)", flush=True)


def flat_slice(torch, dev, smi):
    """Phase 23: the flat agent (``graph_mode: false``) through train,
    infer and serve, and the host-sync check of both modes (see the
    module docstring).  Returns the phase's kernel launches and the
    largest float difference of its kernel #2 launch against the plain
    version on the card."""
    import numpy as np

    from gsc_tpu_torch import cli
    from gsc_tpu_torch.config.loader import load_agent
    from gsc_tpu_torch.ops.substep import substep_megakernel, substep_plain
    from gsc_tpu_torch.parallel.dp import ParallelDDPG
    from gsc_tpu_torch.serve import run_serve
    from gsc_tpu_torch.sim import cases
    from gsc_tpu_torch.utils.checkpoint import (read_checkpoint_meta,
                                                verify_checkpoint)

    laps = Laps()
    total = {}
    root = tempfile.mkdtemp(prefix="gsc_flat_")

    def yaml_of(steps):
        path = os.path.join(root, f"agent_{steps}.yaml")
        with open(path, "w") as f:
            f.write(FLAT_AGENT_YAML.format(graph="false", steps=steps))
        return path

    def counted():
        counts = cli.kernel_launches()
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        return counts

    # (a) 64 replicas, one episode with its burst, then the evaluation
    y_a = yaml_of(FLAT_STEPS)
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

    kept = {}
    launch = substep_megakernel.launch

    def keep(engine, state, *a):
        out = launch(engine, state, *a)
        if state.batch == FLAT_REPLICAS:
            kept["args"], kept["out"] = (engine, state, *a), out
        return out

    saved = (ParallelDDPG.rollout_episodes, ParallelDDPG.learn_burst)
    ParallelDDPG.rollout_episodes = synced(saved[0], "rollout")
    ParallelDDPG.learn_burst = synced(saved[1], "learn_burst")
    substep_megakernel.launch = keep
    cli.zero_kernel_launches()
    try:
        res = cli.run_train(["--agent-config", y_a, *FLAT_ARGS,
                             "--result-dir", os.path.join(root, "a")])
    finally:
        del substep_megakernel.launch
        ParallelDDPG.rollout_episodes, ParallelDDPG.learn_burst = saved
    counts = counted()
    trainer, state, buffers = res["trainer"], res["state"], res["buffers"]
    agent = trainer.agent_cfg
    check(not agent.graph_mode, "phase 23 (a) trained a graph-mode agent")
    row = trainer.history[-1]
    for k in ("episodic_return", "critic_loss", "actor_loss", "q_values"):
        check(k in row and math.isfinite(row[k]), f"(a) {k}: {row.get(k)}")
    want = 2 * FLAT_STEPS
    check(counts["substep_megakernel"] == want,
          f"(a) {counts['substep_megakernel']} kernel #2 launches for "
          f"{FLAT_STEPS} env steps and {FLAT_STEPS} evaluation steps")
    att = {k: n for k, n in counts.items() if k.startswith("gat_attention")}
    check(not any(att.values()), f"(a) the flat run launched {att}")
    b = FLAT_REPLICAS
    cap = agent.mem_limit // b
    check(tuple(buffers.data["obs"].shape) == (b, cap, 72)
          and buffers.data["obs"].dtype == torch.float32
          and bool((buffers.size == min(FLAT_STEPS, cap)).all()),
          f"(a) replay obs {tuple(buffers.data['obs'].shape)}, fill "
          f"{buffers.size.tolist()[:4]}")
    ck_a = res["summary"]["checkpoint"]
    meta = read_checkpoint_meta(ck_a)
    check(meta.get("graph_mode") is False and verify_checkpoint(ck_a),
          f"(a) checkpoint sidecar {meta}")
    fresh = ParallelDDPG(trainer.env, agent, b, device=dev).init(
        torch.Generator().manual_seed(trainer.seed))
    for net, init in (("actor", fresh.actor), ("critic", fresh.critic)):
        final = dict(getattr(state, net).named_parameters())
        for name, p0 in init.named_parameters():
            check(not torch.equal(p0, final[name]),
                  f"(a) {net}.{name} did not move in training")
    engine, *args = kept["args"]
    got = kept["out"]
    what = f"(a) a B={b} kernel #2 launch of the flat run"
    err = cases.compare_states(got, substep_plain(engine, *args), SUB_RTOL,
                               SUB_ATOL, f"{what}, kernel vs plain on card: ")
    on_cpu = [a.to("cpu") if hasattr(a, "to") else a for a in args]
    check(cases.bit_equal(got.to("cpu"), substep_plain(engine, *on_cpu)),
          f"{what}: not bit-equal to the plain version on CPU copies")
    sps = b * FLAT_STEPS / sum(spans["rollout"])
    print(f"  (a) train --replicas {b}, 1 episode of {FLAT_STEPS} steps, flat "
          f"observation [72], action [1728]: return "
          f"{row['episodic_return']:.4f}, critic loss {row['critic_loss']}, "
          f"actor loss {row['actor_loss']}; evaluation "
          f"{res['summary']['mean_return']:.4f}; every parameter moved; "
          f"kernel #2 launches {counts['substep_megakernel']} (1 per env "
          f"step and evaluation step), attention launches 0; one B={b} "
          f"launch against the plain version: max abs diff {err:.2e} on the "
          f"card (rtol {SUB_RTOL}, atol {SUB_ATOL}), bit-equal on CPU "
          f"copies", flush=True)
    print(f"  (a) timing on {smi}: rollout {b * FLAT_STEPS} env steps in "
          f"{sum(spans['rollout']):.3f} s = {sps:.1f} env-steps/s; learn "
          f"burst {[round(t, 3) for t in spans['learn_burst']]} s "
          f"({agent.episode_steps} gradient steps); wall "
          f"{res['summary']['wall_s']:.1f} s", flush=True)
    laps.lap("a")

    # (b) one single-env episode, then infer on its checkpoint
    y_b = yaml_of(FLAT_SINGLE_STEPS)
    cli.zero_kernel_launches()
    res_b = cli.run_train(["--agent-config", y_b, "--episodes", "1",
                           "--seed", "0", "--no-perf", "--result-dir",
                           os.path.join(root, "b")])
    res_i = cli.run_infer(["--agent-config", y_b, "--seed", "0",
                           "--checkpoint", res_b["summary"]["checkpoint"],
                           "--episodes", "1"])
    counts_b = counted()
    ev = {k: res_b["summary"][k] for k in ("mean_return",
                                           "final_succ_ratio")}
    check(all(res_i["eval"][k] == v for k, v in ev.items()),
          f"(b) infer {res_i['eval']} differs from the run's own "
          f"evaluation {ev}")
    row_b = res_b["trainer"].history[-1]
    check(math.isfinite(row_b.get("critic_loss", math.nan)),
          f"(b) the single-env episode did not learn: {row_b}")
    check(counts_b["substep_megakernel"] == 3 * FLAT_SINGLE_STEPS,
          f"(b) {counts_b['substep_megakernel']} kernel #2 launches for "
          f"{FLAT_SINGLE_STEPS} training, evaluation and infer steps each")
    print(f"  (b) single env, 1 episode of {FLAT_SINGLE_STEPS} steps with "
          f"its burst: return {row_b['episodic_return']:.4f}, critic loss "
          f"{row_b['critic_loss']}, {row_b['sps']:.1f} env-steps/s on "
          f"{smi}; infer on its checkpoint {json.dumps(res_i['eval'])} "
          f"equal to the run's own evaluation; kernel #2 launches "
          f"{counts_b['substep_megakernel']}", flush=True)
    laps.lap("b")

    # (c) serving (a)'s checkpoint
    n_req, conc, deadline = FLAT_SERVE
    cli.zero_kernel_launches()
    rep = run_serve(load_agent(y_a), device=dev, checkpoint=ck_a,
                    requests=n_req, concurrency=conc, buckets=BUCKETS,
                    deadline_ms=deadline, pool_steps=POOL_STEPS, seed=0)
    counts_c = counted()
    summ = rep.summary()
    check(not rep.errors and len(rep.answers) == n_req,
          f"(c) {len(rep.answers)} of {n_req} answered, errors "
          f"{rep.errors[:3]}")
    check(counts_c["substep_megakernel"] == POOL_STEPS,
          f"(c) {counts_c['substep_megakernel']} kernel #2 launches for a "
          f"request pool of {POOL_STEPS} env steps")
    ddpg = rep.ddpg
    check(all(np.asarray(o).shape == (72,) for o in rep.pool),
          "(c) the request pool is not flat observations")
    worst, ambiguous = 0.0, 0
    singles = {}
    for k in sorted({k for k, _ in rep.answers}):
        obs = torch.from_numpy(np.asarray(rep.pool[k]))[None].to(dev)
        with torch.inference_mode():
            singles[k] = (ddpg.greedy_action(obs)[0].cpu().numpy(),
                          ddpg.actor(obs)[0].cpu().numpy())
    for k, ans in rep.answers:
        check(ans.shape == (1728,) and bool(np.isfinite(ans).all())
              and np.allclose(ans.reshape(-1, 24).sum(-1), 1.0, rtol=1e-5),
              f"(c) answer for pool obs {k}: {ans.shape}, finite "
              f"{bool(np.isfinite(ans).all())}")
        e, a = compare_answers(ans, singles[k][0], singles[k][1],
                               f"(c) batched vs unbatched, obs {k}")
        worst, ambiguous = max(worst, e), ambiguous + a
    print(f"  (c) run_serve (cli serve's body) of (a)'s checkpoint: "
          f"{summ['completed']} requests at concurrency {conc}, deadline "
          f"{deadline:g} ms, {summ['dispatches']} dispatches; "
          f"{summ['rps']:.1f} req/s, p50 {summ['p50_ms']:.3f} ms, p99 "
          f"{summ['p99_ms']:.3f} ms on {smi}; answers vs unbatched "
          f"greedy_action max abs diff {worst:.2e} ({ambiguous} ambiguous "
          f"rows)", flush=True)
    print("serve_summary flat: " + json.dumps(summ))
    laps.lap("c")

    # (d) zero host syncs in the single-env dispatch region, both modes
    cli.zero_kernel_launches()
    for graph in (True, False):
        sync_region(torch, dev, smi, graph)
    counted()
    laps.lap("d")

    # (e)-(g) under per-flow control and beside the hot-swap fleet
    flat_perflow(torch, dev, smi, root, yaml_of, counted, ck_a)
    laps.lap("e-g")
    print(f"  phase 23 kernel launches: {total}; parts: " + ", ".join(
        f"({k}) {v:.1f} s" for k, v in laps.seconds.items()), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return total, err


def linkcap_run(device):
    """Phase 24 (a): the oracle's harness on ``device``: (the oracle's
    numbers, real nodes, every interval's cumulative counters)."""
    from gsc_tpu_torch.sim.oracle import oracle_numbers, uniform_engine_run

    metrics, n_real, rows = uniform_engine_run(
        str(LINKCAP_NETWORK), LINKCAP_STEPS, LINKCAP_SEED,
        str(LINKCAP_CONFIG), device=device, per_step=True)
    return oracle_numbers(metrics), n_real, rows


def oracle_references():
    """Phase 24's CPU references, started in the processes aside: the
    oracle's run on the plain engine, and the stochastic Abilene episode
    (its case built here, its plain run on CPU copies)."""
    from gsc_tpu_torch.sim import cases

    case = cases.stochastic_abilene_case(STOCHASTIC_INTERVALS)
    return (on_cpu_aside(linkcap_run, "cpu"), case,
            on_cpu_aside(cases.run_case, case, "cpu", plain=True))


def traffic_host_seconds(replicas: int, repeats: int) -> dict:
    """Phase 24 (c), in a process aside: seconds per episode of traffic
    for ``replicas`` Abilene replicas (``EpisodeDriver.replica_traffic``
    under ``cases.stochastic_abilene_case``'s random traffic) with the
    native sampler and with the numpy path (``GSC_TPU_NO_NATIVE=1``),
    ``repeats`` episodes each; host seconds."""
    from gsc_tpu_torch.config import abc_service
    from gsc_tpu_torch.env.driver import EpisodeDriver
    from gsc_tpu_torch.native import SWITCH
    from gsc_tpu_torch.sim import cases

    case = cases.stochastic_abilene_case(1)
    out = {}
    try:
        for path in ("native", "numpy"):
            if path == "numpy":
                os.environ[SWITCH] = "1"
            driver = EpisodeDriver.single(case.topo, case.engine.cfg,
                                          abc_service(),
                                          STOCHASTIC_INTERVALS, "abilene")
            driver.replica_traffic(0, 1)      # loads the library
            times = []
            for ep in range(repeats):
                t0 = time.perf_counter()
                tr = driver.replica_traffic(ep, replicas)
                times.append(time.perf_counter() - t0)
            flows = int(tr.arr_time.isfinite().sum())
            out[path] = {"seconds": times, "flows": flows}
    finally:
        os.environ.pop(SWITCH, None)
    return out


def check_linkcap(got: dict, want: dict):
    """tests/test_reference_parity.py:160-184's rules for an oracle with
    ``atol_flows``."""
    atol = want["atol_flows"]
    check(got["generated"] == want["generated"],
          f"linkcap generated {got['generated']} != {want['generated']}")
    for key in ("processed", "dropped"):
        check(abs(got[key] - want[key]) <= atol,
              f"linkcap {key} {got[key]} beyond {want[key]} +- {atol}")
    check(abs(got["avg_e2e"] - want["avg_e2e"])
          <= want["e2e_rel"] * want["avg_e2e"],
          f"linkcap avg e2e {got['avg_e2e']} beyond {want['avg_e2e']} "
          f"+- {want['e2e_rel']:.0%}")
    for reason, n in want["drop_reasons"].items():
        g = got["drop_reasons"][reason]
        check(abs(g - n) <= atol and (n != 0 or g == 0),
              f"linkcap {reason} drops {g} against {n}")


def host_checks():
    """Phase 24 (c) and (d), started before phase 23 so that they run
    beside it: the host traffic timing in a process aside (the processes
    aside are idle by then) and the linter in a process of its own."""
    host = on_cpu_aside(traffic_host_seconds, TRAFFIC_REPLICAS,
                        TRAFFIC_REPEATS)
    lint = subprocess.Popen(
        [sys.executable, "-m", "gsc_tpu_torch.analysis.lint"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # a phase that fails before phase 24 leaves no linter behind
    atexit.register(lambda: lint.poll() is None and lint.kill())
    return host, lint


def oracle_traffic_slice(torch, dev, smi, refs, checks):
    """Phase 24 (see the module docstring); ``refs``: what
    ``oracle_references`` started, ``checks``: what ``host_checks``
    started.  Returns (kernel #2's launches on the main path, the largest
    float difference to the plain engine)."""
    import platform

    import numpy as np

    from gsc_tpu_torch.ops.substep import substep_megakernel
    from gsc_tpu_torch.sim import cases

    linkcap_ref, case, case_ref = refs
    host, lint = checks
    t_phase = time.perf_counter()
    try:
        # (a) the linkcap oracle through kernel #2
        substep_megakernel.launches = 0
        t0 = time.perf_counter()
        got, n_real, rows = linkcap_run(dev)
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        launches_a = substep_megakernel.launches
        check(launches_a == LINKCAP_STEPS,
              f"the oracle run launched kernel #2 {launches_a} times (want "
              f"one per interval, {LINKCAP_STEPS})")
        check(n_real == 3, f"linkcap: {n_real} real nodes")
        check_linkcap(got, LINKCAP_ORACLE)
        want, _, want_rows = linkcap_ref.result()
        worst_a = 0.0
        for i, (g, w) in enumerate(zip(rows, want_rows)):
            for key in ("generated", "processed", "dropped",
                        "drop_reasons"):
                check(g[key] == w[key], f"linkcap interval {i} {key}: "
                      f"kernel {g[key]} vs plain {w[key]}")
            diff = abs(g["e2e_sum"] - w["e2e_sum"])
            worst_a = max(worst_a, diff)
            check(diff <= SUB_ATOL + SUB_RTOL * abs(w["e2e_sum"]),
                  f"linkcap interval {i} e2e sum {g['e2e_sum']} vs plain "
                  f"{w['e2e_sum']}")
        check(len(rows) == len(want_rows) == LINKCAP_STEPS,
              "linkcap: intervals missing")
        print(f"  (a) linkcap oracle through kernel #2 ({launches_a} "
              f"launches, {wall_a:.2f} s): {json.dumps(got)} against the "
              f"frozen {LINKCAP_ORACLE['processed']}/"
              f"{LINKCAP_ORACLE['dropped']} (avg e2e "
              f"{LINKCAP_ORACLE['avg_e2e']:.3f}, +-"
              f"{LINKCAP_ORACLE['atol_flows']} flows, "
              f"{LINKCAP_ORACLE['e2e_rel']:.0%}): held; every interval's "
              f"counters equal to the plain engine's on the CPU, e2e sum "
              f"within {worst_a:.2e}", flush=True)
        # (b) an episode of random traffic through kernel #2
        substep_megakernel.launches = 0
        t0 = time.perf_counter()
        states = cases.run_case(case, dev)
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0
        launches_b = substep_megakernel.launches
        check(launches_b == case.intervals,
              f"the stochastic episode launched kernel #2 {launches_b} "
              f"times (want {case.intervals})")
        on_cpu = case_ref.result()
        worst_b = 0.0
        for i in range(case.intervals):
            what = f"stochastic Abilene interval {i}"
            worst_b = max(worst_b, cases.compare_states(
                states[i], on_cpu[i], SUB_RTOL, SUB_ATOL,
                f"{what}, kernel vs plain on CPU: "))
            check(cases.bit_equal(states[i].to("cpu"), on_cpu[i]),
                  f"{what}: the kernel is not bit-equal to the plain "
                  "version on CPU copies")
        m = states[-1].metrics
        dr = case.traffic.arr_dr.numpy()
        dr = dr[np.isfinite(case.traffic.arr_time.numpy())]
        check(len(np.unique(dr)) > 100, "the episode's data rates are not "
              "random")
        print(f"  (b) one {case.intervals}-interval episode of Abilene "
              f"(exponential arrivals, Pareto sizes, N(1, 0.2) rates, native "
              f"traffic: {len(dr)} flows) through kernel #2 "
              f"({launches_b} launches, {wall_b:.2f} s): generated "
              f"{int(m.generated.sum())}, processed "
              f"{int(m.processed.sum())}, dropped {int(m.dropped.sum())} "
              f"{m.drop_reasons.sum(0).tolist()}; every interval bit-equal "
              f"to the plain version on CPU copies (max float diff "
              f"{worst_b:.2e})", flush=True)
        # (c) host seconds per episode of traffic
        secs = host.result()
        med = {k: float(np.median(v["seconds"])) for k, v in secs.items()}
        check(med["native"] < med["numpy"],
              f"the native sampler took {med['native']:.3f} s, numpy "
              f"{med['numpy']:.3f} s")
        print(f"  (c) host seconds per episode of traffic, "
              f"{TRAFFIC_REPLICAS} Abilene replicas x "
              f"{STOCHASTIC_INTERVALS} intervals, median of "
              f"{TRAFFIC_REPEATS} (host {platform.node()}, "
              f"{platform.machine()}, {os.cpu_count()} CPUs; card {smi}): "
              f"native "
              f"{med['native']:.4f} s ({secs['native']['flows']} flows in "
              f"the last), numpy {med['numpy']:.4f} s "
              f"({secs['numpy']['flows']} flows); every repeat native "
              f"{[round(t, 4) for t in secs['native']['seconds']]}, numpy "
              f"{[round(t, 4) for t in secs['numpy']['seconds']]}",
              flush=True)
        # (d) the linter under this machine's Python
        out, _ = lint.communicate(timeout=600)
        check(lint.returncode == 0, f"the linter exited {lint.returncode}:"
              f"\n{out[-3000:]}")
        summary = out.strip().splitlines()[-1] if out.strip() else ""
        print(f"  (d) python -m gsc_tpu_torch.analysis.lint (Python "
              f"{platform.python_version()}): exit 0, {summary}",
              flush=True)
    finally:
        if lint.poll() is None:
            lint.kill()
            lint.wait()
    print(f"  phase 24: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ({"substep_megakernel": launches_a + launches_b},
            max(worst_a, worst_b))


def async_mesh_slice(torch, dev, smi, ref):
    """Phase 25: ``train --async --mesh 2x1`` on two ranks sharing the
    card (gloo), one launch running (a)-(d) (the module docstring) as
    legs of ``cli.mesh_legs``.  ``ref``: phase 20's rows and (b)'s
    replay.  Returns the launches on the main path by kernel, summed over
    ranks."""
    from gsc_tpu_torch import cli
    from gsc_tpu_torch.parallel.mesh import launch

    laps = Laps()
    root = tempfile.mkdtemp(prefix="gsc_async_mesh_")
    total = {}
    same = lambda a, b: torch.equal(a.reshape(-1).view(torch.uint8),
                                    b.reshape(-1).view(torch.uint8))

    def agent(name, text):
        path = os.path.join(root, name)
        with open(path, "w") as f:
            f.write(text)
        return path

    fleet_yaml = agent("fleet.yaml", MESH_AGENT_YAML.format(warmup=50))
    flat_yaml = agent("flat.yaml", MESH_AGENT_YAML.format(
        warmup=ASYNC_MESH_FLAT_WARMUP).replace("graph_mode: true",
                                               "graph_mode: false"))
    flat_dir = os.path.join(root, "flat")
    hold, budget = ASYNC_MESH_STALL
    two = ["--mesh", "2x1", "--partition-rules", "replicated"]
    legs = [
        ("(a) 2x1, 1 actor per rank, frozen",
         frozen_argv(async_agent_yaml(root)) + two),
        ("(b) 2x1, 2 actors per rank", [
            "--agent-config", fleet_yaml, *MESH_ARGS, "--episodes",
            str(ASYNC_MESH_EPISODES), "--async", "--async-actors", "2",
            "--no-obs", *two]),
        ("(c, d) flat 2x1, sharded", [
            "--agent-config", flat_yaml, *MESH_ARGS, "--episodes", "1",
            "--async", "--async-actors", "1", "--mesh", "2x1",
            "--partition-rules", "sharded", "--result-dir", flat_dir,
            "--fault-plan", f"watcher_stall@a0:0:{hold}",
            "--watchdog-budget", str(budget), "--watchdog-escalate", "0"])]
    t0 = time.perf_counter()
    per_rank = launch(cli.mesh_legs, 2, 1, devices=["cuda:0"] * 2,
                      deadline_s=MESH_DEADLINE_S,
                      args=([a for _, a in legs],))
    wall = time.perf_counter() - t0
    outs = per_rank[0]
    for i, out in enumerate(outs):
        out["ranks"] = [rank[i]["rank"] for rank in per_rank]
    for (label, _), out in zip(legs, outs):
        ranks = out["ranks"]
        for r in ranks:
            info = r["async"]
            check(r["backend"] == "gloo", f"{label}: backend {r['backend']}")
            check(info["ring_shards"] == 2 and info["mesh"] == "2x1",
                  f"{label}: ring shards {info['ring_shards']}, mesh "
                  f"{info['mesh']}")
            check(info["actor_collectives"] == 0
                  and info["ingest_collectives"] == 0,
                  f"{label}: rank {r['rank']} issued "
                  f"{info['actor_collectives']} collectives from actor "
                  f"threads, {info['ingest_collectives']} in ingests")
            check(info["transitions_lost"] == 0
                  and info["produced_steps"] == info["ingested_steps"],
                  f"{label}: rank {r['rank']} drain {info}")
            check(r["launches"]["substep_megakernel"] > 0,
                  f"{label}: rank {r['rank']} launched no "
                  "substep_megakernel")
            for k, n in r["launches"].items():
                total[k] = total.get(k, 0) + n
        check(len({r["state_sha256"] for r in ranks}) == 1,
              f"{label}: the ranks end with different learner states")
        check(len({r["async"]["bursts"] for r in ranks}) == 1,
              f"{label}: burst counts {[r['async']['bursts'] for r in ranks]}")
        print(f"  {label}: {out['summary']['wall_s']:.1f} s of rank 0's "
              f"run; launches per rank {[r['launches'] for r in ranks]}",
              flush=True)
    print(f"  one launch of 2 ranks for the {len(legs)} legs: {wall:.1f} s "
          f"(start-up {[round(r['startup_s'], 2) for r in outs[0]['ranks']]}"
          " s)", flush=True)
    laps.lap("launch")

    # (a) the gathered replay against phase 20 (b)'s one-process run
    got, want = outs[0]["buffers"], ref["frozen_ring"]
    check(set(got.data) == set(want.data)
          and all(same(got.data[k], want.data[k]) for k in want.data)
          and torch.equal(got.pos, want.pos)
          and torch.equal(got.size, want.size),
          "(a) the 2x1 gathered replay differs from the one-process "
          "--async replay")
    print(f"  (a) 2x1 gathered replay == phase 20 (b)'s one-process "
          f"replay, bit for bit ({sum(d.numel() for d in want.data.values())}"
          f" elements); ranks' learner states equal", flush=True)

    # (b) the fleet: every episode drained on both ranks, numbers beside
    # phase 20's one-process runs of this call
    fleet = outs[1]
    infos = [r["async"] for r in fleet["ranks"]]
    for info in infos:
        check(info["episodes_drained"] == ASYNC_MESH_EPISODES
              and info["publishes"] >= 1,
              f"(b) drained {info['episodes_drained']} of "
              f"{ASYNC_MESH_EPISODES}, {info['publishes']} publishes")
    for r in fleet["ranks"]:
        for k in ("gat_attention", "gat_attention_backward"):
            check(r["launches"][k] > 0, f"(b) rank {r['rank']} launched "
                  f"no {k}")
    eps = sorted(h["episode"] for h in fleet["history"])
    check(eps == list(range(ASYNC_MESH_EPISODES)), f"(b) episodes {eps}")
    env_steps = sum(i["produced_steps"] / i["wall_s"] for i in infos)
    bursts_s = infos[0]["bursts"] / max(i["wall_s"] for i in infos)
    gather = [r["plan"]["gather_ms_per_step"] for r in fleet["ranks"]]
    print(f"  (b) 2x1, 2 actors per rank, B=64, {ASYNC_MESH_EPISODES} "
          f"episodes: {env_steps:.1f} env-steps/s summed over ranks, "
          f"{bursts_s:.3f} bursts/s, policy lag max "
          f"{[i['policy_lag_max'] for i in infos]} mean "
          f"{[i['policy_lag_mean'] for i in infos]}, learner idle "
          f"{[i['learner_idle_frac'] for i in infos]}, actor idle "
          f"{[i['actor_idle_frac'] for i in infos]}, batch gather "
          f"{[round(g, 4) for g in gather]} ms per gradient step, "
          f"{infos[0]['bursts']} bursts, {infos[0]['publishes']} publishes "
          f"on {smi}", flush=True)
    for label, row in ref["rows"].items():
        print(f"  beside phase 20 (one process, B=64, {ASYNC_STEPS}-step "
              f"episodes) {label}: {row['env_steps_s']:.1f} env-steps/s, "
              f"{row['bursts_s']:.3f} bursts/s", flush=True)
    laps.lap("b")

    # (c) the flat agent, (d) its actor 0 held in an adoption
    flat = outs[2]
    for r in flat["ranks"]:
        check(r["async"]["episodes_drained"] == 1,
              f"(c) rank {r['rank']} drained {r['async']['episodes_drained']}")
        check(r["launches"]["gat_attention"] == 0,
              f"(c) the flat agent launched attention on rank {r['rank']}")
    stalls = {1: flat["ranks"][1]["stalls"], 0: []}
    with open(os.path.join(flat_dir, "events.jsonl")) as f:
        for line in f:
            ev = json.loads(line)
            if ev["event"] == "stall":
                stalls[0].append(ev)
    for rank, evs in stalls.items():
        named = [e for e in evs if e.get("thread") == "actor0"
                 and e.get("last_phase") == "adopt"]
        check(named, f"(d) rank {rank}: no stall naming actor0 in adopt "
              f"({[(e.get('thread'), e.get('last_phase')) for e in evs]})")
        print(f"  (d) rank {rank}: stall of actor0 in adopt after "
              f"{named[0]['age_s']} s (budget {budget} s, held {hold} s); "
              f"{len(evs)} stall events in all", flush=True)
    print(f"  (c) flat 2x1 (sharded): 1 episode (warm-up "
          f"{ASYNC_MESH_FLAT_WARMUP} of 50 steps) drained on both ranks, "
          "learner states equal", flush=True)
    laps.lap("c, d")
    shutil.rmtree(root, ignore_errors=True)
    print("phase 25 parts, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in laps.seconds.items()), flush=True)
    return total


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
    from gsc_tpu_torch.ops.build import PKG
    from gsc_tpu_torch.ops.substep import SOURCE as SUB_SOURCE
    from gsc_tpu_torch.ops.substep import (SubstepMegakernel,
                                           substep_megakernel)
    from gsc_tpu_torch.serve import run_serve
    from gsc_tpu_torch.sim import cases

    RF_MATH_SOURCE = PKG / "csrc" / "rf_math.cuh"
    dev = resolve_device()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"device: {name} (x{count}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    phases.lap("1")
    # ---- 2. build ------------------------------------------------------
    # phase 22 reads every build's and load's compile event
    from gsc_tpu_torch.analysis import CompileMonitor
    monitor = CompileMonitor(watch=None).start()
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
    # phase 19's plugin builds of kernel #2 and the math header's probe,
    # beside the others
    ops["substep_megakernel (plugins)"] = PluginBuild(dev)
    ops["substep_megakernel (math plugins)"] = PluginBuild(
        dev, cases.MATH_PLUGINS)
    ops["rf_math_probe"] = ProbeBuild()
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
                                 deadline_ms=deadline, seed=0,
                                 seeded_actor=True))
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
              f"{summ['rps']:.1f} req/s, p50 {summ['p50_ms']:.3f} ms, "
              f"p99 {summ['p99_ms']:.3f} ms, startup {summ['startup']['startup_s']:.2f} s on "
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
    # phase 24's CPU references run aside from here on
    oracle_refs = oracle_references()
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
    # phase 8's and phase 10's checkpoints, served again in phase 17
    ck_root = tempfile.mkdtemp(prefix="gsc_ck_")
    ck_f32 = os.path.join(ck_root, "f32")
    ck = os.path.join(ck_root, "checkpoint")
    train_launches, f32_train = train_slice(torch, dev, smi,
                                            checkpoint=ck_f32)
    for kernel, n in train_launches.items():
        check(n > 0, f"{kernel} was not launched on the training path")

    phases.lap("8")
    # ---- 9. bf16 attention kernels vs plain on the card ------------------
    h_timings, h_err, hb_timings, hb_err = attention_phase_bf16(
        torch, dev, smi, parent_att[2] if parent_att else None)

    phases.lap("9")
    # ---- 10. the bf16 training slice, saving a checkpoint ----------------
    bf16_launches, bf16_train = train_slice(torch, dev, smi, "bf16",
                                            checkpoint=ck)
    for kernel, n in bf16_launches.items():
        check(n > 0, f"{kernel} was not launched on the bf16 training path")
    print(f"train bf16 beside f32 on {smi}: rollout "
          f"{bf16_train['sps']:.1f} env-steps/s (f32 "
          f"{f32_train['sps']:.1f}); learn bursts "
          f"{[round(t, 3) for t in bf16_train['bursts']]} s (f32 "
          f"{[round(t, 3) for t in f32_train['bursts']]} s)", flush=True)

    # ---- 11. bf16 serving from that checkpoint ---------------------------
    serve_bf16 = serve_from_checkpoint(torch, dev, smi, ck)
    print(f"serve bf16: {serve_bf16} bf16 attention launches, 0 f32",
          flush=True)

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
    # ---- 16. generalization training ----------------------------------
    print("phase 16, generalization training:", flush=True)
    (mix_launches, mix_sub_err, mix_err,
     mix_bwd_err) = generalization_training_slice(torch, dev, smi)
    phases.lap("16")
    for kernel in ("gat_attention", "gat_attention_backward",
                   "substep_megakernel"):
        check(mix_launches.get(kernel, 0) > 0,
              f"{kernel} was not launched on the generalization path")
    # ---- 17. serving, whole --------------------------------------------
    print("phase 17, serving, whole:", flush=True)
    try:
        serving_launches, serving_errs = serving_slice(torch, dev, smi,
                                                       ck_f32, ck)
    finally:
        shutil.rmtree(ck_root, ignore_errors=True)
    phases.lap("17")
    for kernel in ("gat_attention", "gat_attention_backward",
                   "gat_attention_bf16", "substep_megakernel"):
        check(serving_launches.get(kernel, 0) > 0,
              f"{kernel} was not launched on the serving path")
    # ---- 18. per-flow control -----------------------------------------
    print("phase 18, per-flow control:", flush=True)
    pf_launches, pf_err, pf_times = perflow_slice(torch, dev, smi)
    phases.lap("18")
    for kernel in ("substep_megakernel", "substep_megakernel_perflow"):
        check(pf_launches.get(kernel, 0) > 0,
              f"{kernel} was not launched on the per-flow path")
    # ---- 19. resource-function plugins --------------------------------
    print("phase 19, resource-function plugins:", flush=True)
    rf_launches, rf_numbers = plugin_slice(torch, dev, smi, parent)
    phases.lap("19")
    for kernel in ("gat_attention", "gat_attention_backward",
                   "substep_megakernel_plugin",
                   "substep_megakernel_plugin_math"):
        check(rf_launches.get(kernel, 0) > 0,
              f"{kernel} was not launched on the plugin path")
    # ---- 20. decoupled actor/learner training -------------------------
    print("phase 20, train --async:", flush=True)
    async_launches, async_ref = async_slice(torch, dev, smi)
    phases.lap("20")
    for kernel, n in async_launches.items():
        check(n > 0, f"{kernel} was not launched on the --async path")
    # ---- 21. the mesh ---------------------------------------------------
    print("phase 21, train --mesh:", flush=True)
    mesh_launches = mesh_slice(torch, dev, smi)
    phases.lap("21")
    for kernel in ("gat_attention", "gat_attention_backward",
                   "substep_megakernel"):
        check(mesh_launches.get(kernel, 0) > 0,
              f"{kernel} was not launched on the mesh path")
    # ---- 22. the cost ledger and the sentinels --------------------------
    print("phase 22, the device-cost ledger (--perf) and the sentinels:",
          flush=True)
    perf_launches = perf_slice(torch, dev, smi, monitor)
    monitor.stop()
    phases.lap("22")
    for kernel in ("gat_attention", "gat_attention_backward",
                   "substep_megakernel"):
        check(perf_launches.get(kernel, 0) > 0,
              f"{kernel} was not launched on the --perf path")
    # phase 24's host timing and linter run beside phase 23
    checks = host_checks()
    # ---- 23. flat observations and the MLP actor and critic -------------
    print("phase 23, flat observations (graph_mode: false):", flush=True)
    flat_launches, flat_err = flat_slice(torch, dev, smi)
    phases.lap("23")
    check(flat_launches.get("substep_megakernel", 0) > 0,
          "substep_megakernel was not launched on the flat path")
    # ---- 24. the linkcap oracle, native traffic and the linter ----------
    print("phase 24, the linkcap oracle, the native traffic sampler and "
          "the linter:", flush=True)
    oracle_launches, oracle_err = oracle_traffic_slice(torch, dev, smi,
                                                       oracle_refs, checks)
    phases.lap("24")
    # ---- 25. train --async --mesh ---------------------------------------
    print("phase 25, train --async --mesh:", flush=True)
    am_launches = async_mesh_slice(torch, dev, smi, async_ref)
    del async_ref
    phases.lap("25")
    path_launches = {k: mesh_launches.get(k, 0) + perf_launches.get(k, 0)
                     + am_launches.get(k, 0)
                     + flat_launches.get(k, 0)
                     + oracle_launches.get(k, 0)
                     + train_launches.get(k, 0)
                     + bf16_launches.get(k, 0)
                     + gen_launches.get(k, 0) + large_launches.get(k, 0)
                     + run_launches.get(k, 0) + mix_launches.get(k, 0)
                     + serving_launches.get(k, 0) + pf_launches.get(k, 0)
                     + rf_launches.get(k, 0) + async_launches.get(k, 0)
                     for k in ("gat_attention", "gat_attention_backward",
                               "gat_attention_bf16",
                               "gat_attention_backward_bf16",
                               "substep_megakernel",
                               "substep_megakernel_perflow",
                               "substep_megakernel_plugin",
                               "substep_megakernel_plugin_math")}
    max_err = max(max_err, large_errs["gat_attention"])
    bwd_err = max(bwd_err, large_errs["gat_attention_backward"])
    h_err = max(h_err, large_errs["gat_attention_bf16"])
    hb_err = max(hb_err, large_errs["gat_attention_backward_bf16"])
    sub_err = max(sub_err, large_sub_err, mix_sub_err, flat_err, oracle_err)
    max_err = max(max_err, mix_err, serving_errs["gat_attention"])
    bwd_err = max(bwd_err, mix_bwd_err)
    h_err = max(h_err, serving_errs["gat_attention_bf16"])

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
    }, {
        "name": "substep_megakernel_perflow",
        "route": "cuda",
        "source": rel(SUB_SOURCE),
        "replaces": "gsc_tpu/sim/engine.py:389",
        "launches": path_launches["substep_megakernel_perflow"],
        "max_abs_err": pf_err,
        "ms": pf_times["ms"],
        "plain_ms": pf_times["plain_ms"],
        "bound_ms": pf_times["bound_ms"],
        "bound_by": pf_times["bound_by"],
        "library_ms": None,
    }, {
        "name": "substep_megakernel_plugin",
        "route": "cuda",
        "source": rel(SUB_SOURCE),
        "replaces": "gsc_tpu/ops/pallas_substep.py:110",
        "launches": path_launches["substep_megakernel_plugin"],
        "max_abs_err": rf_numbers["plugins"]["max_abs_err"],
        "ms": rf_numbers["plugins"]["ms"],
        "plain_ms": rf_numbers["plugins"]["plain_ms"],
        "bound_ms": rf_numbers["plugins"]["bound_ms"],
        "bound_by": rf_numbers["plugins"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "substep_megakernel_plugin_math",
        "route": "cuda",
        "source": rel(RF_MATH_SOURCE),
        "replaces": "gsc_tpu/ops/pallas_substep.py:110",
        "launches": path_launches["substep_megakernel_plugin_math"],
        "max_abs_err": rf_numbers["math"]["max_abs_err"],
        "ms": rf_numbers["math"]["ms"],
        "plain_ms": rf_numbers["math"]["plain_ms"],
        "bound_ms": rf_numbers["math"]["bound_ms"],
        "bound_by": rf_numbers["math"]["bound_by"],
        "library_ms": None,
    }]}
    stop_cpu_aside()
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
        stop_cpu_aside()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
