"""Command line of the port: ``python -m gsc_tpu_torch.cli`` with the
commands ``init-configs``, ``train``, ``infer``, ``serve`` and
``simulate``.

``init-configs --out DIR`` writes the JAX package's example config set:
the agent, simulator, service and scheduler yaml files (the same bytes)
and the GraphML networks (abilene-in4, triangle, line3,
bteurope-in2-rand-cap1-2, claranet-in4-cap1, compuserve-in4-cap1) with
the port's writer.

``train`` trains on the networks of a scheduler yaml (``--scheduler``:
GraphML training networks switched every ``period`` episodes, and an
unseen inference network), or on one ``--network``, which is then both:
a built-in one (abilene, bteurope, claranet, compuserve, tinet, chinanet,
interroute) or a GraphML file (``topology.synthetic.write_graphml``
writes one of any builder's network, e.g. ``random_network(200, ...)``),
padded to ``--max-nodes``/``--max-edges``.  Networks whose action dim
reaches 16384 (interroute at 128 nodes: 49,152) train the factored
actor and critic heads.  ``--replicas 1`` (the default, as in the JAX CLI) takes the
single-env loop (:meth:`gsc_tpu_torch.agents.trainer.Trainer.train`);
``--replicas B`` takes replica-parallel training
(:meth:`~gsc_tpu_torch.agents.trainer.Trainer.train_parallel`) in
rollout chunks of ``--chunk`` steps, with every episode's traffic
sampled on the device, as the JAX CLI does; ``--topo-mix`` fills its
replicas with a registry mixture (``topology.scenarios``) or the
on-device scenario factory (``factory:...``, ``topology.factory``),
whose family weights the TD curriculum moves
(``--curriculum-temperature``, ``--curriculum-floor``), with the JAX
CLI's validation.  It prints one JSON line per episode and writes
``rewards.csv`` to ``--result-dir``; at the end it saves the
learner state, the replay, the random source and the completed-episode
count to ``--checkpoint`` (default ``<result-dir>/checkpoint``), with the
precision policy and a checksum in the checkpoint's sidecar, evaluates
one greedy episode on the inference network (the test-mode CSV suite goes
to ``<result-dir>/test``) and prints a last JSON line with the checkpoint
and the evaluation.  ``--resume PATH|auto`` continues a checkpoint
(``auto``: the newest under ``--result-dir`` whose checksum validates)
bit for bit, under the checkpoint's precision; ``--ckpt-interval N``
saves rotating checkpoints to ``<result-dir>/ckpts`` every N episodes;
``--hot-swap-dir D`` publishes the actor into ``D`` every
``--publish-interval`` episodes for a ``serve --hot-swap-dir D`` fleet.
``--async`` (with ``--replicas B``) takes decoupled actor/learner
training (:meth:`~gsc_tpu_torch.agents.trainer.Trainer.train_async`):
``--async-actors`` threads, each on its own CUDA stream, feed the
learner's replay ring; ``--max-staleness``, ``--publish-bursts`` and
``--learn-ratio`` tune it, with the JAX CLI's refusals, and the last JSON
line carries the drain proof (``drain``: produced == ingested steps).
``--mesh DPxMP`` (with ``--replicas B``, B divisible by dp*mp) trains on
a mesh of ranks, one process each (``parallel.mesh``): spawned on the
card one card per rank (NCCL), on the CPU under ``--device cpu`` (gloo),
or joined from a ``torchrun`` environment; ``--partition-rules
replicated|sharded`` picks the learner state's residency
(``parallel.partition``); ``tp`` is refused.  ``--async --mesh DPxMP``
composes the two over the dp axis (a tp-only carving, dp = 1 with more
than one rank, is refused with the recarve instructions): each rank runs
``--async-actors`` actor threads on its own replica rows and ring shard,
and only its learner thread talks to the process group.  Flat agents
(``graph_mode: false``) train on both.  Rank 0 prints, writes and
evaluates; the last JSON line carries ``mesh`` and ``partition_rules``.
``--resource-functions-path`` (``train``, ``infer``, ``serve``,
``simulate``) loads resource-function plugins before the service yaml is
parsed; on the card they run compiled into the substep kernel.
Its defaults are the JAX CLI's: the pipelined single-env loop
(``--no-pipeline``: the serial one), the run observer (``--no-obs``;
``events.jsonl``, ``metrics.json``, ``series.json``, ``curves.json`` with
the learning-signal ledger, ``--no-learn-obs``, ``perf.json`` with the
device-cost ledger, ``--no-perf``, and ``compile`` events per kernel
library built or loaded), the rollback guard
(``--no-rollback``), retry of transient dispatch failures, fault
injection from ``--fault-plan`` or ``GSC_FAULT_PLAN``, a checkpoint and a
clean exit on SIGTERM/SIGINT, ``result.yaml`` and ``run.log`` in the run
directory.  The run directory is ``--result-dir`` itself, or with
``--runs N`` (seeds ``--seed + k``; the best run by ``select_best_agent``
is reported) or ``--experiment-id`` one
``<result-dir>/<id or default>/<timestamp>`` per run.  Without
``--result-dir`` nothing is written and the observer keeps its events in
memory.

``simulate`` runs ``--duration`` ms on one GraphML network and prints the
JAX CLI's JSON (flow counts, drop reasons, mean end-to-end delay): under
the duration controller with a uniform schedule and every SF everywhere;
under a ``controller: per_flow`` config with ``--per-flow-algo local``
(every deciding flow processes at its node, a policy on the device, one
kernel launch per substep) or ``spr`` (the shortest-path heuristic through
the host ``PerFlowController`` loop).  ``spr`` under the duration
controller is refused before any setup.

``infer --checkpoint PATH`` restores a checkpoint's learner state and
prints the evaluation of ``--episodes`` greedy episodes on the inference
network, under the checkpoint's recorded precision (else the agent
yaml's) unless ``--precision`` says otherwise.

``serve`` runs :func:`gsc_tpu_torch.serve.run_serve` on ``--network``
(as ``train`` takes it) and prints the JAX CLI's JSON line (tier,
requests/s, p50/p99 overall and per bucket, SLO verdict, swaps,
brownouts); with ``--checkpoint`` it serves a checkpoint's actor under
the precision its sidecar records (a contradicting ``--precision`` is
refused; without a readable sidecar the agent yaml's), else the SPR
tier.  ``--continuous``, ``--workers`` (a fleet with an SPR brownout
tier), ``--hot-swap-dir`` (swap in the versions ``train --hot-swap-dir``
publishes), ``--trace-sample``, ``--slo-p99-ms`` (the SLO engine,
``slo.json`` under ``--result-dir``) and ``--perf/--no-perf`` (the
learned tier's ``serve_policy_b<B>`` per bucket in ``perf.json``) are
the JAX CLI's flags.

The agent, simulator, service and scheduler configs load from yaml files
(``yaml`` must be importable then); without them the init-configs values
are built in code, with the attention kernel (``gnn_impl="pallas"``).
Every command but ``init-configs`` runs on the card unless ``--device
cpu`` is given; on the card every simulator interval runs the substep
megakernel.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from .meshspec import PARTITION_RULEBOOKS

_NETWORKS = ("abilene", "bteurope", "claranet", "compuserve", "tinet",
             "chinanet", "interroute")
_PRECISIONS = ("f32", "bf16")
# (temperature, floor) of --curriculum-*, the JAX CLI's defaults
CURRICULUM_DEFAULTS = (1.0, 0.25)
# --async-actors, --max-staleness, --publish-bursts, --learn-ratio
ASYNC_DEFAULTS = (2, 0, 1, 1.0)
# the drain proof of an --async run's last JSON line
DRAIN_KEYS = ("produced_steps", "ingested_steps", "transitions_lost",
              "episodes_drained", "bursts", "publishes", "policy_lag_max",
              "learner_idle_frac", "actor_idle_frac", "actor_restarts",
              "actors_degraded", "blocks_quarantined", "rollbacks",
              "ring_shards", "actor_collectives", "ingest_collectives")


def _agent(args, precision):
    """The agent config: the yaml's (or the init-configs agent with
    ``gnn_impl="pallas"``), its precision overridden by ``precision``."""
    from .config import init_configs_agent
    from .config.loader import load_agent

    over = {"precision": precision} if precision else {}
    if args.agent_config:
        return load_agent(args.agent_config, **over)
    return init_configs_agent(gnn_impl="pallas", **over)


def _sim_and_service(args):
    from .config import abc_service, init_configs_sim
    from .config.loader import load_service, load_sim
    from .config.schema import replace
    from .config.registry import load_resource_function_plugins

    # train's --substep-impl / --unroll override the yaml's engine keys
    over = {k: v for k, v in (
        ("substep_impl", getattr(args, "substep_impl", None)),
        ("scan_unroll", getattr(args, "unroll", None))) if v is not None}
    sim_cfg = (load_sim(args.simulator_config, **over)
               if args.simulator_config
               else replace(init_configs_sim(), **over))
    plugins = args.resource_functions_path
    if args.service:
        service = load_service(args.service, resource_functions_path=plugins)
    else:
        if plugins:
            load_resource_function_plugins(plugins)
        service = abc_service()
    return sim_cfg, service


def _build(args, precision, seed=None):
    """(env, driver, agent) of ``train`` and ``infer``: the scheduler
    yaml's networks, or the built-in ``--network`` as a schedule of one;
    traffic seeded from ``seed`` (default ``--seed``)."""
    from .config.loader import load_scheduler
    from .config.schema import EnvLimits, SchedulerConfig
    from .env.driver import EpisodeDriver
    from .env.env import ServiceCoordEnv
    from .topology.compiler import compile_topology

    agent = _agent(args, precision)
    sim_cfg, service = _sim_and_service(args)
    limits = EnvLimits.for_service(service, max_nodes=args.max_nodes,
                                   max_edges=args.max_edges)
    env = ServiceCoordEnv(service, sim_cfg, agent, limits)
    seed = args.seed if seed is None else seed
    mix = getattr(args, "topo_mix", None)
    try:
        if args.scheduler:
            if args.network:
                raise SystemExit("--network and --scheduler exclude each "
                                 "other")
            driver = EpisodeDriver(load_scheduler(args.scheduler), sim_cfg,
                                   service, agent.episode_steps,
                                   max_nodes=args.max_nodes,
                                   max_edges=args.max_edges, base_seed=seed,
                                   topo_mix=mix)
        elif _is_graphml(args.network):
            # a GraphML network file: a schedule of one, as a scheduler
            # yaml naming it would be (the simulator's force caps apply)
            net = args.network
            driver = EpisodeDriver(SchedulerConfig((net,), net), sim_cfg,
                                   service, agent.episode_steps,
                                   max_nodes=args.max_nodes,
                                   max_edges=args.max_edges, base_seed=seed,
                                   topo_mix=mix)
        else:
            name = args.network or "abilene"
            topo = compile_topology(_network_spec(name),
                                    max_nodes=args.max_nodes,
                                    max_edges=args.max_edges)
            driver = EpisodeDriver.single(topo, sim_cfg, service,
                                          agent.episode_steps, name,
                                          base_seed=seed, topo_mix=mix)
    except ValueError as e:
        # forced caps on a built-in network, a mix member that does not
        # fit the bucket or a fault index past its real elements
        raise SystemExit(str(e))
    return env, driver, agent


def _is_graphml(network: Optional[str]) -> bool:
    return bool(network) and network not in _NETWORKS


def _network_spec(network: Optional[str]):
    """The NetworkSpec of ``--network``: a built-in name (default
    abilene), or a GraphML file (``write_graphml``'s, or any the reader
    takes)."""
    from .topology import synthetic
    from .topology.compiler import read_graphml

    if _is_graphml(network):
        return read_graphml(network)
    return getattr(synthetic, network or "abilene")()


def _check_serve_args(args):
    """The JAX CLI's refusals of ``serve``; returns (buckets, SLO
    objectives or None)."""
    try:
        buckets = tuple(sorted({int(b) for b in args.buckets.split(",")}))
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError
    except ValueError:
        raise SystemExit(f"--buckets must be comma-separated positive ints, "
                         f"got {args.buckets!r}")
    if args.requests < 1 or args.concurrency < 1:
        raise SystemExit("--requests and --concurrency must be positive")
    if args.workers < 1:
        raise SystemExit("--workers must be >= 1")
    if args.fire_swaps < 0:
        raise SystemExit("--fire-swaps must be >= 0")
    if args.fire_swaps and not args.hot_swap_dir:
        raise SystemExit("--fire-swaps publishes into the hot-swap "
                         "directory — pass --hot-swap-dir")
    if args.swap_poll_s <= 0:
        raise SystemExit("--swap-poll-s must be > 0")
    if args.metrics_port < 0:
        raise SystemExit("--metrics-port must be >= 0 (0 = disabled)")
    if args.metrics_port and not args.obs:
        raise SystemExit("--metrics-port needs the run observer (drop "
                         "--no-obs)")
    if args.trace_sample < 0:
        raise SystemExit("--trace-sample must be >= 0 (0 = request spans "
                         "off)")
    if (args.trace_sample or args.slo_p99_ms) and not args.obs:
        raise SystemExit("--trace-sample/--slo-p99-ms need the run observer "
                         "(drop --no-obs)")
    slo = None
    if args.slo_p99_ms:
        from .obs.slo import parse_slo_spec
        try:
            slo = parse_slo_spec(args.slo_p99_ms)
        except ValueError as e:
            raise SystemExit(f"--slo-p99-ms {args.slo_p99_ms!r}: {e}")
    return buckets, slo


def _serve(args) -> int:
    from .serve import run_serve

    buckets, slo = _check_serve_args(args)
    precision = args.precision
    if args.checkpoint:
        from .utils.checkpoint import checkpoint_precision
        try:
            precision = checkpoint_precision(args.checkpoint, precision,
                                             implicit=None)
        except ValueError as e:
            raise SystemExit(str(e))
    agent = _agent(args, precision)
    sim_cfg, service = _sim_and_service(args)
    spec = _network_spec(args.network)
    observer = None
    if args.obs:
        from .obs import RunObserver
        from .utils.experiment import setup_result_dir

        rdir = (setup_result_dir(args.result_dir, "serve")
                if args.result_dir else None)
        observer = RunObserver(args.obs_dir or rdir, tags={"seed": args.seed},
                               metrics_port=(args.metrics_port or None),
                               series_window=args.obs_series_window,
                               perf=args.perf)
    try:
        report = run_serve(agent, sim_cfg, service, spec, seed=args.seed,
                           pool_steps=args.pool_steps,
                           requests=args.requests,
                           concurrency=args.concurrency, buckets=buckets,
                           deadline_ms=args.deadline_ms,
                           max_nodes=args.max_nodes,
                           max_edges=args.max_edges,
                           request_timeout=args.request_timeout,
                           device=args.device, checkpoint=args.checkpoint,
                           continuous=args.continuous, workers=args.workers,
                           brownout_burn=args.brownout_burn or None,
                           hot_swap_dir=args.hot_swap_dir,
                           swap_poll_s=args.swap_poll_s,
                           fire_swaps=args.fire_swaps,
                           stats_interval=args.stats_interval,
                           observer=observer, trace_sample=args.trace_sample,
                           slo=slo)
    except ValueError as e:
        raise SystemExit(str(e))
    print(json.dumps(report.summary()))
    return 1 if report.errors else 0


def _resume_path(args) -> Optional[str]:
    if args.resume != "auto":
        return args.resume
    from .resilience.ckpt import find_resumable

    found = find_resumable(args.result_dir) if args.result_dir else None
    if not found:
        raise SystemExit(
            "--resume auto: no checkpoint with a validating checksum under "
            f"--result-dir {args.result_dir!r}")
    print(f"[resume auto] {found}", file=sys.stderr)
    return found


def _check_train_args(args):
    """The JAX CLI's refusals, before any run state exists."""
    from .resilience.faults import FaultPlan, refuse_async_sites

    if args.resume and args.runs != 1:
        raise SystemExit("--resume only supports --runs 1")
    if args.runs < 1:
        raise SystemExit("--runs must be >= 1")
    if args.runs > 1 and not args.result_dir:
        raise SystemExit("--runs > 1 picks the best run from the runs' "
                         "rewards.csv: give --result-dir")
    if args.publish_interval < 1:
        raise SystemExit("--publish-interval must be >= 1")
    if args.metrics_port < 0:
        raise SystemExit("--metrics-port must be >= 0 (0 = disabled)")
    if args.metrics_port and not args.obs:
        raise SystemExit("--metrics-port needs the run observer (drop "
                         "--no-obs)")
    if args.unroll is not None and args.unroll < 1:
        raise SystemExit("--unroll must be a positive integer")
    if args.async_mode:
        if args.replicas <= 1:
            raise SystemExit(
                "--async decouples the replica rollout from the learner — "
                "it requires the replica-parallel path (--replicas > 1)")
        if args.async_actors < 1:
            raise SystemExit("--async-actors must be >= 1")
        if args.max_staleness < 0:
            raise SystemExit("--max-staleness must be >= 0 (0 = two "
                             "episodes' worth of steps per actor)")
        if args.publish_bursts < 1:
            raise SystemExit("--publish-bursts must be >= 1")
        if args.learn_ratio <= 0:
            raise SystemExit("--learn-ratio must be > 0")
    elif (args.async_actors, args.max_staleness, args.publish_bursts,
          args.learn_ratio) != ASYNC_DEFAULTS:
        raise SystemExit(
            "--async-actors/--max-staleness/--publish-bursts/--learn-ratio "
            "tune the decoupled actor/learner path — pass --async or drop "
            "the flags")
    else:
        try:
            refuse_async_sites(FaultPlan.from_env(args.fault_plan))
        except ValueError as e:
            raise SystemExit(f"--fault-plan: {e}")
    _check_mesh_args(args)
    args.curriculum = _curriculum(args)


def _refuse_mode_change(resume, agent) -> None:
    """A resume across observation modes (``graph_mode``), refused by
    name before anything starts."""
    if resume:
        from .utils.checkpoint import check_graph_mode
        try:
            check_graph_mode(resume, agent.graph_mode)
        except ValueError as e:
            raise SystemExit(f"--resume: {e}")


def _check_mesh_args(args):
    """``--mesh`` and ``--partition-rules`` as the JAX CLI checks them."""
    from .meshspec import canonical_mesh, parse_mesh_shape

    if not args.mesh:
        if args.partition_rules != "replicated":
            raise SystemExit(
                f"--partition-rules {args.partition_rules} has no effect "
                "without --mesh — pass --mesh DPxMP (e.g. 4x2) or drop the "
                "flag")
        return
    if args.replicas <= 1:
        raise SystemExit(
            "--mesh shards env replicas over the device grid — it requires "
            "the replica-parallel path (--replicas > 1)")
    try:
        dp, mp = parse_mesh_shape(args.mesh)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}")
    if args.replicas % (dp * mp) != 0:
        raise SystemExit(
            f"--replicas ({args.replicas}) must be divisible by the mesh "
            f"device count ({dp * mp} = {dp}x{mp}) for an even replica "
            "sharding")
    if args.async_mode:
        # over the dp axis only: a tp-only carving has no axis to carve
        # the replay ring along
        from .parallel.partition import ShardingPlan
        try:
            ShardingPlan.from_spec(args.mesh).assert_async_capable()
        except ValueError as e:
            raise SystemExit(str(e))
    if args.partition_rules == "tp":
        raise SystemExit(
            "--partition-rules tp (tensor-parallel layers, collectives "
            "inside autograd) is the next slice of the port: use "
            "replicated or sharded")
    args.mesh = canonical_mesh(args.mesh)


def _curriculum(args):
    """``--topo-mix`` and ``--curriculum-*`` as the JAX CLI checks them:
    the grammar of either mix form before anything is built, and the
    curriculum config of a factory mix (None for any other)."""
    from .topology.factory import is_factory_mix
    from .topology.scenarios import validate_mix

    mix = args.topo_mix
    if mix:
        if args.replicas <= 1:
            raise SystemExit(
                "--topo-mix fills the replica axis with the mixture — it "
                "requires the replica-parallel path (--replicas > 1)")
        try:
            validate_mix(mix)
        except ValueError as e:
            raise SystemExit(f"--topo-mix: {e}")
    knobs = (args.curriculum_temperature, args.curriculum_floor)
    if is_factory_mix(mix):
        from .env.curriculum import CurriculumConfig
        try:
            return CurriculumConfig(temperature=knobs[0], floor=knobs[1])
        except ValueError as e:
            raise SystemExit(str(e))
    if knobs != CURRICULUM_DEFAULTS:
        raise SystemExit(
            "--curriculum-* steers the on-device scenario factory — "
            "pass --topo-mix factory:... or drop the flags")
    return None


def _run_dir(args) -> Optional[str]:
    """The run's directory: ``--result-dir`` itself for one run without
    an experiment id, else ``<result-dir>/<id or default>/<timestamp>``
    per run, as the JAX package makes them; None without
    ``--result-dir``."""
    from .utils.experiment import setup_result_dir

    if not args.result_dir:
        return None
    if args.runs == 1 and not args.experiment_id:
        os.makedirs(args.result_dir, exist_ok=True)
        return args.result_dir
    return setup_result_dir(args.result_dir, args.experiment_id)


def _observer(args, run: int, rdir: Optional[str], seed: int):
    from .obs import RunObserver

    if not args.obs:
        return None
    odir = args.obs_dir or rdir
    if args.obs_dir and args.runs > 1:
        odir = os.path.join(args.obs_dir, f"run{run}")
    return RunObserver(odir, snapshot_interval=args.obs_interval,
                       watchdog_budget_s=args.watchdog_budget,
                       watchdog_escalate=args.watchdog_escalate,
                       rotate_mb=args.obs_rotate_mb, learn=args.learn_obs,
                       metrics_port=(args.metrics_port or None),
                       series_window=args.obs_series_window,
                       perf=args.perf, tags={"seed": seed})


def _train_run(args, run: int, dev, precision, resume, mesh=None) -> dict:
    """One run of ``train``: observer, trainer, preemption guard, final
    checkpoint and evaluation.  ``mesh``: this process is that rank of
    the run's mesh; rank 0 alone owns the run directory, the observer,
    the printed rows, checkpoints, publishes and the evaluation."""
    from .agents.trainer import Trainer
    from .resilience.ckpt import CheckpointManager
    from .resilience.faults import FaultPlan
    from .resilience.preempt import PreemptionGuard
    from .utils.checkpoint import load_full_or_partial, save_checkpoint
    from .utils.experiment import ExperimentResult, copy_inputs
    from .utils.logging import setup_logging

    fplan = FaultPlan.from_env(args.fault_plan)   # fires once: one per run
    seed = args.seed + run
    rank0 = mesh is None or mesh.rank == 0
    rdir = _run_dir(args) if rank0 else None
    result = None
    if rdir:
        copy_inputs(rdir, [args.agent_config, args.simulator_config,
                           args.service, args.scheduler])
        result = ExperimentResult(rdir)
        result.env_config = {"agent_config": args.agent_config,
                             "simulator_config": args.simulator_config,
                             "service": args.service,
                             "scheduler": args.scheduler,
                             "network": args.network, "seed": seed}
        setup_logging(logfile=os.path.join(rdir, "run.log"))
    env, driver, agent = _build(args, precision, seed=seed)
    plan = mesh_meta = None
    if mesh is not None:
        from .parallel.partition import ShardingPlan
        plan = ShardingPlan(mesh, args.partition_rules)
        mesh_meta = _mesh_meta(plan, env, agent)
    obs = _observer(args, run, rdir, seed) if rank0 else None
    if obs is not None:
        obs.start(meta={"episodes": args.episodes, "replicas": args.replicas,
                        "pipeline": args.pipeline, "seed": seed,
                        "topo_mix": args.topo_mix,
                        **({"curriculum": {
                            "temperature": args.curriculum_temperature,
                            "floor": args.curriculum_floor}}
                           if args.curriculum is not None else {}),
                        "precision": agent.precision,
                        "graph_mode": agent.graph_mode,
                        "substep_impl": env.sim_cfg.substep_impl,
                        "unroll": env.sim_cfg.scan_unroll,
                        "result_dir": rdir, "device": str(dev),
                        "ckpt_interval": args.ckpt_interval,
                        "hot_swap_dir": args.hot_swap_dir,
                        **(mesh_meta or {}),
                        **({"fault_plan": fplan.summary()} if fplan
                           else {})})
    learn_spec = None
    if not rank0 and args.obs and args.learn_obs:
        # rank 0's learn ledger, so that its signal (and the curriculum it
        # moves) is computed alike on every rank
        from .obs.learning import LearnLedgerSpec
        learn_spec = LearnLedgerSpec.for_topos(driver.num_topo_ids)
    try:
        trainer = Trainer(env, driver, agent, seed=seed, result_dir=rdir,
                          device=dev, obs=obs,
                          check_invariants=args.check_invariants,
                          fault_plan=fplan, rollback=args.rollback,
                          learn_ledger=learn_spec,
                          tensorboard=args.tensorboard)
        manager = (CheckpointManager(os.path.join(rdir, "ckpts"),
                                     retain=args.ckpt_retain,
                                     meta={"precision": agent.precision,
                                           "graph_mode": agent.graph_mode},
                                     fault_plan=fplan, obs=obs)
                   if rdir else None)
        init_state = init_buffer = None
        start_episode, load_s = 0, None
        if resume:
            t0 = time.perf_counter()
            init_state, template = trainer.template(args.replicas)
            restored, buffer_ok = load_full_or_partial(
                resume, init_state, buffer=template, draws=trainer.draws)
            load_s = time.perf_counter() - t0
            if buffer_ok:
                init_buffer = template
                if plan is not None:
                    # every rank loads the whole checkpoint, keeps its rows
                    init_buffer = template.rows(*plan.rows(args.replicas))
            elif rank0:
                print("[resume] replay not restorable (replay config such "
                      "as mem_limit or --replicas changed since the "
                      "checkpoint): restored the learner state only, replay "
                      "starts empty", file=sys.stderr)
            start_episode = int(restored["extra"].get("episode", 0))
            if start_episode >= args.episodes:
                raise SystemExit(
                    f"--episodes ({args.episodes}) must exceed the "
                    f"checkpoint's completed episode count ({start_episode})")
        publisher = None
        if args.hot_swap_dir and rank0:
            from .serve.fleet import WeightPublisher
            publisher = WeightPublisher(
                args.hot_swap_dir, hub=(obs.hub if obs is not None else None),
                fault_plan=fplan)
        publish = dict(publisher=publisher,
                       publish_interval=(args.publish_interval
                                         if args.hot_swap_dir else 0))
        on_row = ((lambda row: print(json.dumps(row), flush=True))
                  if rank0 else None)
        if result is not None:
            result.runtime_start("train")
        t0 = time.perf_counter()
        with PreemptionGuard() as guard:
            if args.async_mode:
                state, buffer = trainer.train_async(
                    args.episodes, args.replicas, chunk=args.chunk,
                    actor_threads=args.async_actors, verbose=True,
                    profile=args.profile, init_state=init_state,
                    init_buffers=init_buffer, start_episode=start_episode,
                    ckpt_manager=manager, ckpt_interval=args.ckpt_interval,
                    preempt=guard, publisher=publisher,
                    publish_bursts=args.publish_bursts,
                    curriculum=args.curriculum,
                    max_staleness=args.max_staleness,
                    learn_ratio=args.learn_ratio, on_row=on_row, plan=plan,
                    # a rank without the observer watches its own fleet
                    watchdog_budget_s=(args.watchdog_budget
                                       if args.obs and not rank0 else 0.0))
            elif args.replicas > 1:
                state, buffer = trainer.train_parallel(
                    args.episodes, args.replicas, chunk=args.chunk,
                    on_row=on_row, init_state=init_state,
                    init_buffers=init_buffer, start_episode=start_episode,
                    ckpt_manager=manager, ckpt_interval=args.ckpt_interval,
                    preempt=guard, profile=args.profile, verbose=rank0,
                    curriculum=args.curriculum, plan=plan, **publish)
            else:
                state, buffer = trainer.train(
                    args.episodes, init_state=init_state,
                    init_buffer=init_buffer, start_episode=start_episode,
                    ckpt_manager=manager, ckpt_interval=args.ckpt_interval,
                    on_row=on_row, pipeline=args.pipeline, preempt=guard,
                    profile=args.profile, verbose=True, **publish)
        train_s = time.perf_counter() - t0
        if result is not None:
            result.runtime_stop("train")
        # the drain proof of an --async run: nothing produced was lost
        drain = ({k: trainer.async_info[k] for k in DRAIN_KEYS}
                 if args.async_mode and trainer.async_info else None)
        if trainer.preempted:
            # a checksummed snapshot of the drained state, a clean exit
            # and a line saying how to continue; no evaluation
            done = trainer.completed_episodes
            ckpt = (manager.save(state, buffer, episode=done,
                                 draws=trainer.draws) if manager else None)
            if obs is not None:
                obs.close(status="preempted")
            if result is not None:
                result.metrics = {"status": "preempted"}
                result.write()
            payload = {"status": "preempted", "signal": guard.signame,
                       "result_dir": rdir, "checkpoint": ckpt,
                       "episodes_completed": done,
                       "hint": "continue with --resume auto"}
            if drain is not None:
                payload["drain"] = drain
            if mesh_meta:
                payload.update(mesh=plan.describe(),
                               partition_rules=plan.rules_name)
            return {"summary": payload, "trainer": trainer, "state": state,
                    "buffers": buffer, "eval": None, "result_dir": rdir,
                    "preempted": True}
        ckpt = None
        if rank0:
            ckpt = args.checkpoint or (os.path.join(rdir, "checkpoint")
                                       if rdir else None)
        save_s = None
        if ckpt:
            t1 = time.perf_counter()
            ckpt = save_checkpoint(ckpt, state, buffer=buffer,
                                   meta={"precision": agent.precision,
                                         "graph_mode": agent.graph_mode,
                                         "episode": args.episodes},
                                   checksum=True, draws=trainer.draws,
                                   extra={"episode": args.episodes})
            save_s = time.perf_counter() - t1
        wall_s = time.perf_counter() - t0
        if result is not None:
            result.runtime_start("test")
        # the evaluation runs on rank 0, on the whole state: independent
        # of the carving
        test = (trainer.evaluate(state, episodes=1, test_mode=True,
                                 telemetry=True) if rank0 else {})
        if result is not None:
            result.runtime_stop("test")
    except BaseException:
        # the run's last events (run_end status=error, a last snapshot)
        # land even when training fails; a failing close must not mask
        # the original error
        if obs is not None:
            try:
                obs.close(status="error")
            except Exception:
                pass
        raise
    if obs is not None:
        obs.close(status="ok")
    if result is not None:
        result.metrics = test
        result.write()
    last = trainer.history[-1] if trainer.history else {}
    summary = {"device": str(dev), "precision": agent.precision,
               "replicas": args.replicas, "episodes": args.episodes,
               "start_episode": start_episode,
               "episode_steps": agent.episode_steps,
               "train_s": train_s, "wall_s": wall_s,
               "ckpt_save_s": save_s, "ckpt_load_s": load_s,
               "final_return": last.get("episodic_return"),
               "sps": last.get("sps"),
               "result_dir": os.path.abspath(rdir) if rdir else None,
               "checkpoint": ckpt, **test}
    if drain is not None:
        summary["drain"] = drain
    if mesh_meta:
        summary.update(mesh=plan.describe(), partition_rules=plan.rules_name)
    return {"summary": summary, "trainer": trainer, "state": state,
            "buffers": buffer, "eval": test, "result_dir": rdir,
            "preempted": False}


def _mesh_meta(plan, env, agent) -> dict:
    """``run_start``'s record of a mesh run: the canonical mesh, the rule
    book and ``{spec: leaf count}`` over the learner state the run will
    hold (its networks, targets and both Adam states)."""
    from .agents.ddpg import DDPG
    from .parallel.partition import learner_state_shapes

    nets = DDPG(env, agent, device="cpu")
    return {"mesh": plan.describe(), "partition_rules": plan.rules_name,
            "partition_specs": plan.summary(learner_state_shapes(
                nets.actor, nets.critic))}


def _kernel_ops() -> dict:
    from .ops.gat_attention import (gat_attention, gat_attention_backward,
                                    gat_attention_backward_bf16,
                                    gat_attention_bf16)
    from .ops.substep import substep_megakernel

    return {"gat_attention": gat_attention,
            "gat_attention_backward": gat_attention_backward,
            "gat_attention_bf16": gat_attention_bf16,
            "gat_attention_backward_bf16": gat_attention_backward_bf16,
            "substep_megakernel": substep_megakernel}


def kernel_launches() -> dict:
    """Each kernel wrapper's launch count in this process."""
    return {k: op.launches for k, op in _kernel_ops().items()}


def zero_kernel_launches() -> None:
    """Set each kernel wrapper's launch count in this process to 0."""
    for op in _kernel_ops().values():
        op.launches = 0


def _mesh_rank(mesh, args, precision, resume) -> List[dict]:
    """The runs of ``train --mesh`` on one rank (a launched process, or a
    process that joined a torchrun group); returns what each run leaves
    behind in a form that crosses processes: rank 0's summary, its whole
    learner state (leaf name -> CPU tensor), its replay on the CPU and
    its evaluation, and every rank's accounting (``rank``: start-up
    seconds, kernel launches, the plan's counters, an ``--async`` run's
    ``async_info`` and its fleet's stall events on a rank without the
    observer, and the digest of the rank's learner state)."""
    from .device import resolve_device
    from .parallel.partition import state_digest, state_leaves

    dev = resolve_device(mesh.device)
    outs = []
    for run in range(args.runs):
        zero_kernel_launches()
        out = _train_run(args, run, dev, precision, resume, mesh=mesh)
        launches = kernel_launches()
        trainer = out["trainer"]
        rank0 = mesh.rank == 0
        outs.append({
            "summary": out["summary"] if rank0 else None,
            "eval": out["eval"] if rank0 else None,
            "result_dir": out["result_dir"],
            "preempted": out["preempted"],
            "history": trainer.history,
            "state": ({k: v.detach().cpu().clone()
                       for k, v in state_leaves(out["state"]).items()}
                      if rank0 else None),
            "buffers": (out["buffers"].to("cpu") if rank0 else None),
            "rank": {"rank": mesh.rank, "device": str(mesh.device),
                     "backend": mesh.backend, "startup_s": mesh.startup_s,
                     "launches": launches,
                     "plan": trainer.mesh_info,
                     "async": trainer.async_info,
                     "stalls": trainer.rank_stalls,
                     "state_sha256": state_digest(out["state"]),
                     "completed_episodes": trainer.completed_episodes}})
        if out["preempted"]:
            break
    return outs


def _train(args, devices=None, deadline_s=None) -> dict:
    """``train``: ``--runs`` independent seeded runs (seed + run), each
    in its own run directory; the best by ``select_best_agent`` is
    reported in the last JSON line and returned.  With ``--mesh`` the
    runs go to the mesh's ranks (``_mesh_runs``)."""
    from .device import resolve_device
    from .utils.checkpoint import checkpoint_precision
    from .utils.experiment import select_best_agent

    _check_train_args(args)
    dev = resolve_device(args.device)
    if args.mesh and not _in_torchrun():
        # before anything is built: a card run on fewer cards than ranks
        from .meshspec import parse_mesh_shape
        from .parallel.mesh import rank_devices
        dp, mp = parse_mesh_shape(args.mesh)
        try:
            rank_devices(dp * mp, dev, devices)
        except ValueError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}")
    resume = _resume_path(args)
    precision = args.precision
    if resume:
        try:
            precision = checkpoint_precision(resume, precision)
        except ValueError as e:
            raise SystemExit(str(e))
    _refuse_mode_change(resume, _agent(args, precision))
    if args.mesh:
        outputs = _mesh_runs(args, dev, precision, resume, devices,
                             deadline_s)
        if outputs is None:        # a torchrun rank other than 0
            return {}
    else:
        outputs = []
        for run in range(args.runs):
            outputs.append(_train_run(args, run, dev, precision, resume))
            if outputs[-1]["preempted"]:
                break
    if outputs[-1]["preempted"]:   # its line, and no more runs
        print(json.dumps(outputs[-1]["summary"]), flush=True)
        return outputs[-1]
    dirs = [o["result_dir"] for o in outputs]
    best = outputs[0]
    if args.runs > 1:
        best = outputs[dirs.index(select_best_agent(dirs))]
    print(json.dumps({**best["summary"], "runs": args.runs,
                      "all_result_dirs": dirs}), flush=True)
    return {**best, "runs": outputs}


def mesh_legs(mesh, argvs: List[List[str]]) -> List[dict]:
    """On one rank of a launch: ``train`` with each argv in turn, each on
    its ``--mesh`` (a carving of the launch's ranks: the same rank
    count), one run each; returns each run's ``_mesh_rank`` output.
    ``parallel.mesh.launch(mesh_legs, dp, mp, args=(argvs,))`` runs
    several mesh runs on one set of processes."""
    from .meshspec import parse_mesh_shape

    outs = []
    for argv in argvs:
        # every rank starts a run once rank 0 has written the last one's
        # files (its checkpoint may be the next run's --resume auto)
        mesh.agree_all(True)
        args = _parser().parse_args(["train", *argv])
        _check_train_args(args)
        resume = _resume_path(args)
        precision = args.precision
        if resume:
            from .utils.checkpoint import checkpoint_precision
            precision = checkpoint_precision(resume, precision)
        dp, mp = parse_mesh_shape(args.mesh)
        m = mesh if (dp, mp) == (mesh.dp, mesh.mp) else mesh.recarve(dp, mp)
        outs.append(_mesh_rank(m, args, precision, resume)[0])
    return outs


def _in_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _mesh_runs(args, dev, precision, resume, devices, deadline_s):
    """The runs of ``train --mesh``: joined as this process's rank of a
    torchrun group, or on ``dp * mp`` launched ranks (one card each on
    the card, ``devices`` naming them outright).  Returns rank 0's run
    outputs, each with every rank's accounting under ``ranks``; None on
    a torchrun rank other than 0."""
    from .meshspec import parse_mesh_shape
    from .parallel.mesh import init_distributed, launch

    dp, mp = parse_mesh_shape(args.mesh)
    if _in_torchrun():
        mesh = init_distributed(dp, mp, device=dev)
        outs = _mesh_rank(mesh, args, precision, resume)
        return outs if mesh.rank == 0 else None
    per_rank = launch(_mesh_rank, dp, mp, device=dev, devices=devices,
                      deadline_s=deadline_s, args=(args, precision, resume))
    outs = per_rank[0]
    for k, out in enumerate(outs):
        out["ranks"] = [rank[k]["rank"] for rank in per_rank]
    return outs


def run_train(argv: List[str], devices=None,
              deadline_s: Optional[float] = None) -> dict:
    """``train`` with these arguments; returns the summary, the trainer,
    the learner state, the replay and the evaluation.  Under ``--mesh``
    the learner state is a leaf name -> CPU tensor dict
    (``parallel.partition.state_leaves``), the replay is on the CPU, the
    ranks' accounting is under ``ranks``, and there is no trainer but
    its ``history``; ``devices`` puts the ranks on these devices (ranks
    sharing a card: gloo), ``deadline_s`` bounds the launch."""
    return _train(_parser().parse_args(["train", *argv]), devices=devices,
                  deadline_s=deadline_s)


def _infer(args) -> dict:
    from .agents.trainer import Trainer
    from .device import resolve_device
    from .utils.checkpoint import checkpoint_precision, load_full_or_partial

    dev = resolve_device(args.device)
    # an explicit --precision overrides the recorded one, as in the JAX CLI
    precision = (args.precision
                 or checkpoint_precision(args.checkpoint, implicit=None))
    env, driver, agent = _build(args, precision)
    from .utils.checkpoint import check_graph_mode
    try:
        check_graph_mode(args.checkpoint, agent.graph_mode)
    except ValueError as e:
        raise SystemExit(str(e))
    trainer = Trainer(env, driver, agent, seed=args.seed, device=dev)
    state = trainer.init_state()
    load_full_or_partial(args.checkpoint, state)
    out = trainer.evaluate(state, episodes=args.episodes, test_mode=True)
    print(json.dumps(out), flush=True)
    return {"eval": out, "trainer": trainer, "state": state}


def _uniform_schedule(limits, node_mask):
    """[N, C, S, N] uniform schedule over the real nodes."""
    import numpy as np

    sched = np.zeros(limits.scheduling_shape, np.float32)
    sched[:, :, :, node_mask] = 1.0 / max(int(node_mask.sum()), 1)
    return sched


def _simulate(args) -> dict:
    """``simulate``: ``--duration`` ms on one GraphML network, under the
    duration controller with a uniform schedule and every SF placed on
    every node, or under per-flow control with ``--per-flow-algo``;
    prints the flow counters, drop reasons and mean end-to-end delay as
    one JSON line.  On the card every interval of the duration controller
    is one launch of the substep megakernel, every per-flow substep one
    launch of its per-flow mode."""
    import math

    import numpy as np
    import torch

    from .agents.ddpg import Draws
    from .config.loader import load_service, load_sim
    from .config.schema import EnvLimits
    from .device import resolve_device
    from .sim.engine import SimEngine
    from .sim.state import DROP_REASONS
    from .sim.traffic import generate_traffic
    from .topology.compiler import check_dt_quantization, load_topology

    service = load_service(args.service,
                           resource_functions_path=args.resource_functions_path)
    try:
        sim_cfg = load_sim(args.config)
    except ValueError as e:
        raise SystemExit(f"{args.config}: {e}")
    per_flow = sim_cfg.controller == "per_flow"
    if args.per_flow_algo != "local" and not per_flow:
        raise SystemExit(
            f"--per-flow-algo {args.per_flow_algo} requires 'controller: "
            "per_flow' in the simulator config (this config runs the "
            "duration controller, which would ignore the algorithm)")
    dev = resolve_device(args.device)
    limits = EnvLimits.for_service(service, max_nodes=args.max_nodes,
                                   max_edges=args.max_edges)
    topo = load_topology(args.network, max_nodes=args.max_nodes,
                         max_edges=args.max_edges,
                         force_link_cap=sim_cfg.force_link_cap,
                         force_node_cap=sim_cfg.force_node_cap,
                         seed=args.seed)
    check_dt_quantization(topo, sim_cfg.dt, name=args.network)
    steps = int(math.ceil(args.duration / sim_cfg.run_duration))
    if steps < 1:
        raise SystemExit("duration must cover at least one run_duration "
                         f"({sim_cfg.run_duration} ms)")
    traffic = generate_traffic(sim_cfg, service, topo, steps, args.seed)
    engine = SimEngine(service, sim_cfg, limits)
    nm = topo.node_mask.cpu().numpy()
    topo, traffic = topo.to(dev), traffic.to(dev)
    state = engine.init(1, dev)
    draws = Draws(args.seed, dev)
    if per_flow and args.per_flow_algo == "spr":
        from .sim.perflow import PerFlowController
        from .sim.spr import run_spr_episode

        ctrl = PerFlowController(engine, topo, traffic,
                                 generator=draws.generator)
        state = run_spr_episode(ctrl, state, steps * engine.substeps)
    elif per_flow:
        from .sim.perflow import local_decisions

        for _ in range(steps):
            state, _ = engine.apply_per_flow(state, topo, traffic,
                                             local_decisions,
                                             draws.sim_noise(engine, 1))
    else:
        sched = torch.from_numpy(_uniform_schedule(limits, nm))[None].to(dev)
        placement = torch.from_numpy(np.broadcast_to(
            nm[:, None], (args.max_nodes, limits.sf_pool)).copy())[None].to(dev)
        for _ in range(steps):
            state, _ = engine.apply(state, topo, traffic, sched, placement,
                                    draws.sim_noise(engine, 1))
    m = state.metrics.map(lambda t: t[0].cpu())
    out = {"total_flows": int(m.generated),
           "successful_flows": int(m.processed),
           "dropped_flows": int(m.dropped),
           "drop_reasons": {k: int(v) for k, v in
                            zip(DROP_REASONS, m.drop_reasons.tolist())},
           "avg_end2end_delay": float(m.avg_e2e())}
    print(json.dumps(out), flush=True)
    return out


def run_simulate(argv: List[str]) -> dict:
    """``simulate`` with these arguments; returns its JSON record."""
    return _simulate(_parser().parse_args(["simulate", *argv]))


def run_infer(argv: List[str]) -> dict:
    """``infer`` with these arguments; returns the evaluation, the
    trainer and the restored learner state."""
    return _infer(_parser().parse_args(["infer", *argv]))


def init_configs(out: str) -> None:
    """Write the example config set under ``out``."""
    import yaml

    from .topology.synthetic import (abilene, bteurope, claranet, compuserve,
                                     line, triangle, write_graphml)

    os.makedirs(f"{out}/networks", exist_ok=True)
    write_graphml(abilene(), f"{out}/networks/abilene-in4.graphml")
    write_graphml(triangle(), f"{out}/networks/triangle.graphml")
    write_graphml(line(3), f"{out}/networks/line3.graphml")
    write_graphml(bteurope(node_cap_range=(1, 3)),
                  f"{out}/networks/bteurope-in2-rand-cap1-2.graphml")
    write_graphml(claranet(), f"{out}/networks/claranet-in4-cap1.graphml")
    write_graphml(compuserve(),
                  f"{out}/networks/compuserve-in4-cap1.graphml")

    def dump(name, data):
        with open(f"{out}/{name}", "w") as f:
            yaml.safe_dump(data, f)

    dump("service_abc.yaml", {
        "sfc_list": {"sfc_1": ["a", "b", "c"]},
        "sf_list": {n: {"processing_delay_mean": 5.0,
                        "processing_delay_stdev": 0.0} for n in "abc"},
    })
    dump("service_abcde.yaml", {
        "sfc_list": {"sfc_1": ["a", "b", "c", "d", "e"]},
        "sf_list": {
            "a": {"processing_delay_mean": 5.0,
                  "processing_delay_stdev": 0.0},
            "b": {"processing_delay_mean": 2.0,
                  "processing_delay_stdev": 0.0},
            "c": {"processing_delay_mean": 10.0,
                  "processing_delay_stdev": 0.0, "startup_delay": 5.0},
            "d": {"processing_delay_mean": 1.0,
                  "processing_delay_stdev": 0.0},
            "e": {"processing_delay_mean": 4.0,
                  "processing_delay_stdev": 0.0,
                  "resource_function_id": "overhead"},
        },
    })
    sim = {"inter_arrival_mean": 10.0, "deterministic_arrival": True,
           "flow_dr_mean": 1.0, "flow_dr_stdev": 0.0,
           "flow_size_shape": 0.001, "deterministic_size": True,
           "run_duration": 100, "ttl_choices": [100]}
    dump("simulator.yaml", sim)
    # the MMPP and trace scenarios load in the JAX package (the port's
    # loader refuses both options)
    dump("simulator_mmpp.yaml", {
        **sim, "inter_arrival_mean": 12.0, "deterministic_arrival": False,
        "use_states": True, "init_state": "state_1",
        "states": {"state_1": {"inter_arr_mean": 12.0, "switch_p": 0.05},
                   "state_2": {"inter_arr_mean": 8.0, "switch_p": 0.05}},
    })
    with open(f"{out}/trace_rampup.csv", "w") as f:
        f.write("time,node,inter_arrival_mean,cap\n")
        f.write("0,pop0,10.0,\n")
        f.write("500,pop0,5.0,\n")
        f.write("1000,pop0,2.5,4\n")
        f.write("1500,pop1,5.0,\n")
    dump("simulator_trace.yaml", {**sim,
                                  "trace_path": f"{out}/trace_rampup.csv"})
    dump("agent.yaml", {
        "observation_space": ["ingress_traffic", "node_load", "node_cap"],
        "graph_mode": True, "episode_steps": 200,
        "objective": "prio-flow", "target_success": "auto",
        "GNN_features": 22, "GNN_num_layers": 2, "GNN_num_iter": 2,
        "GNN_aggr": "mean",
        "actor_hidden_layer_nodes": [256],
        "critic_hidden_layer_nodes": [64],
        "mem_limit": 10000, "batch_size": 100,
        "nb_steps_warmup_critic": 200,
        "rand_mu": 0.0, "rand_sigma": 0.3,
        "gamma": 0.99, "target_model_update": 1.0e-4,
        "learning_rate": 1.0e-3,
    })
    dump("scheduler.yaml", {
        "training_network_files": [f"{out}/networks/abilene-in4.graphml"],
        "inference_network": f"{out}/networks/abilene-in4.graphml",
        "period": 10,
    })


def _device_arg(p):
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                   "versions)")


def _network_arg(value: str) -> str:
    if value in _NETWORKS or (value.endswith(".graphml")
                              and os.path.isfile(value)):
        return value
    raise argparse.ArgumentTypeError(
        f"{value!r} is neither a built-in network ({', '.join(_NETWORKS)}) "
        "nor a GraphML file")


def _plugins_arg(p):
    p.add_argument("--resource-functions-path", default=None,
                   help="a .py file or a directory of them with "
                   "resource-function plugins, loaded before the service "
                   "yaml is parsed (reference-style files define "
                   "resource_function(load), registered under the file "
                   "stem); on the card they run compiled into the substep "
                   "kernel")


def _config_args(p, what):
    p.add_argument("--agent-config", help="agent yaml, whose gnn_impl "
                   "picks the attention path (default: the init-configs "
                   "agent with gnn_impl 'pallas', the fused kernel)")
    p.add_argument("--simulator-config", help="simulator yaml (default: "
                   "the init-configs simulator)")
    p.add_argument("--service", help="service catalog yaml (default: abc)")
    p.add_argument("--network", default=None, type=_network_arg,
                   help=f"network to {what}: a built-in one "
                   f"({', '.join(_NETWORKS)}; default: abilene) or a "
                   "GraphML file; --max-nodes/--max-edges pad it")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-nodes", type=int, default=24)
    p.add_argument("--max-edges", type=int, default=37)
    _plugins_arg(p)
    _device_arg(p)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gsc_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("init-configs", help="write an example config set "
                       "(agent, simulator, service, scheduler, networks)")
    c.add_argument("--out", default="configs")

    s = sub.add_parser("serve", help="serve coordination requests from a "
                       "trained actor (or the SPR heuristic without one) "
                       "and report requests/s and p50/p99")
    _config_args(s, "serve on")
    s.add_argument("--checkpoint", default=None,
                   help="a `train` checkpoint directory: serve its actor "
                   "under the precision its sidecar records (default: the "
                   "SPR shortest-path tier, no learned weights)")
    s.add_argument("--precision", choices=_PRECISIONS, default=None,
                   help="precision policy (default: the checkpoint's "
                   "recorded one, else the agent yaml's); with a recorded "
                   "one it must match")
    s.add_argument("--requests", type=int, default=64)
    s.add_argument("--concurrency", type=int, default=4)
    s.add_argument("--buckets", default="1,4,8")
    s.add_argument("--deadline-ms", type=float, default=5.0)
    s.add_argument("--pool-steps", type=int, default=8)
    s.add_argument("--request-timeout", type=float, default=120.0)
    s.add_argument("--continuous", action="store_true",
                   help="continuous batching: the next batch forms while "
                   "the current device call runs and dispatches the moment "
                   "the device frees (default: the deadline batcher)")
    s.add_argument("--workers", type=int, default=1,
                   help="fleet size: N servers behind least-queue-depth "
                   "routing, every series tagged worker=w<i>; a learned "
                   "fleet sheds overflow to an SPR brownout tier")
    s.add_argument("--brownout-burn", type=float, default=2.0,
                   help="error-budget burn rate above which a backlogged "
                   "learned fleet sheds new load to the SPR tier (needs "
                   "--slo-p99-ms; 0: only a full queue sheds)")
    s.add_argument("--hot-swap-dir", default=None,
                   help="watch this publish directory (what `train "
                   "--hot-swap-dir` writes) and swap each new weight "
                   "version in between two dispatches")
    s.add_argument("--swap-poll-s", type=float, default=0.2,
                   help="seconds between hot-swap directory polls")
    s.add_argument("--fire-swaps", type=int, default=0,
                   help="publish this many versions of the served weights "
                   "into --hot-swap-dir while the load runs (the whole "
                   "swap path under load, answers unchanged)")
    s.add_argument("--stats-interval", type=int, default=50,
                   help="completed requests between serve_stats events")
    s.add_argument("--result-dir", default=None,
                   help="write the observer's files to "
                   "<result-dir>/serve/<timestamp> (none: kept in memory)")
    s.add_argument("--obs", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run observer: serve_start/serve_stats/serve_flush "
                   "events, latency histograms, the SLO engine")
    s.add_argument("--obs-dir", default=None,
                   help="directory of the observer's files (default: the "
                   "run directory under --result-dir)")
    s.add_argument("--obs-series-window", type=int, default=1024,
                   help="points kept per metric in the series rings (the "
                   "fleet samples queue depth, occupancy, burn and pad "
                   "waste into them; 0: none)")
    s.add_argument("--perf", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="device-cost ledger over the serving buckets: each "
                   "serve_policy_b<B> records FLOPs, bytes, launches and "
                   "host syncs of its observed warm-up call at start, and "
                   "its measured latency merges in at close; perf.json "
                   "lands next to metrics.json")
    s.add_argument("--metrics-port", type=int, default=0,
                   help="serve /metrics and /series on 127.0.0.1:PORT "
                   "while serving (0: off; needs --obs)")
    s.add_argument("--trace-sample", type=int, default=0,
                   help="record every Nth request as a serve_request_span "
                   "event (0: none; flush spans are always recorded under "
                   "--obs)")
    s.add_argument("--slo-p99-ms", default=None,
                   help="latency objectives for the SLO engine: '<ms>' "
                   "overall and '<bucket>:<ms>' per bucket, comma-separated "
                   "(e.g. '25' or '25,8:60')")

    t = sub.add_parser("train", help="DDPG training over a topology "
                       "schedule: one env (--replicas 1) or B replicas")
    _config_args(t, "train and infer on")
    t.add_argument("--scheduler", help="scheduler yaml: GraphML training "
                   "networks, switching period, inference network")
    t.add_argument("--replicas", type=int, default=1,
                   help="1: the single-env loop; B > 1: B replicas in "
                   "lockstep, rollout chunks of --chunk steps")
    t.add_argument("--chunk", type=int, default=50)
    t.add_argument("--mesh", default=None,
                   help="train on a 'DPxMP' mesh of ranks (--replicas > 1): "
                   "one process per rank on torch.distributed, rank r rolls "
                   "out replica rows r*B/(dp*mp) to (r+1)*B/(dp*mp)-1 and "
                   "every rank runs the same learn burst on the same "
                   "gathered batch.  On the card one card per rank (NCCL; "
                   "fewer cards than ranks is refused); --device cpu runs "
                   "the ranks on the CPU (gloo); under torchrun each "
                   "process joins as its rank.  Checkpoints hold the whole "
                   "state and replay, so --resume may use another mesh or "
                   "none (elastic resume).  With --async over the dp axis "
                   "only (a DPx1 or DPxMP carving with DP > 1)")
    t.add_argument("--partition-rules", default="replicated",
                   choices=PARTITION_RULEBOOKS,
                   help="rule book of the learner state under --mesh: "
                   "'replicated' keeps every leaf whole on every rank, "
                   "'sharded' keeps only a rank's mp slice of every Linear "
                   "weight (and its Polyak target and Adam moments) between "
                   "episodes, bit-identical to 'replicated'; 'tp' (tensor-"
                   "parallel compute) is not ported yet")
    t.add_argument("--topo-mix", default=None,
                   help="fill the replica axis (--replicas > 1) with a "
                   "mixture instead of one network per episode: a "
                   "comma-separated round-robin of 'schedule' (the "
                   "scheduler's training networks) and registry names "
                   "(abilene, triangle, bteurope, ..., random<N>, star<N>, "
                   "ring<N>, line<N>), each optionally '+<shape>' "
                   "(bursty|diurnal|flash_crowd), '~<link|node>@<interval>"
                   "[.<index>]' faults ('&'-joined) and ':<seed>' "
                   "(randomized generators only), e.g. "
                   "'schedule,abilene+bursty,random12~link@3.0:7'; or the "
                   "on-device scenario factory "
                   "'factory:<fam>[-<fam>...][+shapes][~faults]' (star, "
                   "ring, line, random or 'all'), steered by the TD "
                   "curriculum")
    t.add_argument("--curriculum-temperature", type=float,
                   default=CURRICULUM_DEFAULTS[0],
                   help="softmax temperature of the TD curriculum over "
                   "the per-family |TD| EWMAs (factory --topo-mix only): "
                   "lower chases the highest-TD families harder")
    t.add_argument("--curriculum-floor", type=float,
                   default=CURRICULUM_DEFAULTS[1],
                   help="probability mass the curriculum always spreads "
                   "uniformly over the factory families (0..1): no "
                   "family falls below floor/K")
    t.add_argument("--episodes", type=int, default=2)
    t.add_argument("--result-dir", default=None,
                   help="directory for rewards.csv, the final checkpoint, "
                   "periodic checkpoints and the test-mode CSVs (none: "
                   "not written)")
    t.add_argument("--precision", choices=_PRECISIONS, default=None,
                   help="precision policy, overriding the agent yaml's "
                   "(f32: the f32 stack; bf16: bf16 GNN, MLP heads and "
                   "replay, f32 masters and outputs); with --resume it must "
                   "match the checkpoint's")
    t.add_argument("--checkpoint", default=None,
                   help="directory of the final checkpoint (default: "
                   "<result-dir>/checkpoint; its precision goes to "
                   "<dir>.meta.json)")
    t.add_argument("--resume", default=None,
                   help="checkpoint to continue bit for bit ('auto': the "
                   "newest under --result-dir whose checksum validates); "
                   "--episodes stays the total")
    t.add_argument("--ckpt-interval", type=int, default=0,
                   help="save a checkpoint of the verified learner state "
                   "to <result-dir>/ckpts every N episodes (0: never); a "
                   "SIGTERM/SIGINT always saves one on the way out")
    t.add_argument("--ckpt-retain", type=int, default=3,
                   help="periodic checkpoints kept (never the last-good "
                   "pointer's)")
    t.add_argument("--runs", type=int, default=1,
                   help="independent runs seeded --seed + run; the best "
                   "by mean return over its last 10 episodes is reported "
                   "(needs --result-dir when > 1)")
    t.add_argument("--experiment-id", default=None,
                   help="runs go to <result-dir>/<id>/<timestamp> (also "
                   "the layout of --runs > 1, under 'default')")
    t.add_argument("--pipeline", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="single env: prefetch the next episodes' traffic "
                   "on a host thread and read each episode's metrics one "
                   "episode behind its dispatch (the same results as "
                   "--no-pipeline, the serial loop)")
    t.add_argument("--obs", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run observer: events.jsonl, metrics.json, "
                   "series.json and the watchdog (files under --obs-dir, "
                   "else the run directory; in memory without either)")
    t.add_argument("--obs-dir", default=None,
                   help="directory of the observer's files (default: the "
                   "run directory; run<k> subdirectories with --runs > 1)")
    t.add_argument("--obs-interval", type=int, default=10,
                   help="episodes between metrics.json rewrites")
    t.add_argument("--obs-rotate-mb", type=float, default=0.0,
                   help="rotate events.jsonl past this many MiB (0: never)")
    t.add_argument("--obs-series-window", type=int, default=1024,
                   help="points kept per metric in the series rings "
                   "(series.json, /series; 0: none)")
    t.add_argument("--perf", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="device-cost ledger: observe the first dispatch of "
                   "each watched entry point (FLOPs, bytes, launches, host "
                   "syncs), merge the run's phase wall into per-dispatch "
                   "MFU/roofline, and write perf.json next to metrics.json "
                   "(tools/bench_diff.py diffs them across runs).  The "
                   "observed dispatch runs slower; results are the same")
    t.add_argument("--learn-obs", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="learning-signal ledger: per-topology |TD|, Q "
                   "moments, layer norms and replay fill from every learn "
                   "burst (learn_signal events, curves.json)")
    t.add_argument("--metrics-port", type=int, default=0,
                   help="serve /metrics and /series on 127.0.0.1:PORT "
                   "while the run executes (0: off)")
    t.add_argument("--watchdog-budget", type=float, default=300.0,
                   help="seconds without a completed episode before a "
                   "'stall' event (0: no watchdog)")
    t.add_argument("--watchdog-escalate", type=int, default=3,
                   help="budget periods of further silence after a stall "
                   "before the watchdog restarts the prefetcher (0: report "
                   "only)")
    t.add_argument("--check-invariants",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="check every drained episode's simulator state; "
                   "violations become 'invariant_violation' events")
    t.add_argument("--fault-plan", default=None,
                   help="fault injection, 'site@episode[:arg]' joined by "
                   "';' (prefetch_die, slow_episode, dispatch_transient, "
                   "nan_grads, ckpt_corrupt); unset: the GSC_FAULT_PLAN "
                   "variable")
    t.add_argument("--rollback", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="keep a verified snapshot of the learner state and "
                   "replay and restore it when the all-finite flag trips "
                   "(two replay copies on the device); on one env the "
                   "periodic checkpoints save that snapshot, so "
                   "--no-rollback ignores --ckpt-interval there")
    t.add_argument("--hot-swap-dir", default=None,
                   help="train-while-serve: publish the actor as versioned "
                   "weight artifacts into this directory every "
                   "--publish-interval episodes (the rollback guard's "
                   "verified snapshot on one env, the finite-checked "
                   "replica state with --replicas > 1)")
    t.add_argument("--publish-interval", type=int, default=1,
                   help="episodes between hot-swap publishes")
    t.add_argument("--async", dest="async_mode", action="store_true",
                   help="decoupled actor/learner training (--replicas > 1): "
                   "--async-actors threads, each on its own CUDA stream, "
                   "roll the replicas out continuously and ship transition "
                   "blocks into the learner's replay ring, while the "
                   "learner runs learn bursts and publishes the actor every "
                   "--publish-bursts bursts to an in-process bus the actors "
                   "adopt from between chunks; staleness bounded by "
                   "--max-staleness, paced by --learn-ratio; the last JSON "
                   "line carries the drain proof")
    t.add_argument("--async-actors", type=int, default=ASYNC_DEFAULTS[0],
                   help="actor threads of --async (episodes go round-robin "
                   "by global index); under --mesh, actor threads per "
                   "rank, each rolling out its rank's replica rows")
    t.add_argument("--max-staleness", type=int, default=ASYNC_DEFAULTS[1],
                   help="--async backpressure: produced but not ingested "
                   "env steps the actors may run ahead (0 = two episodes' "
                   "worth per actor)")
    t.add_argument("--publish-bursts", type=int, default=ASYNC_DEFAULTS[2],
                   help="learn bursts between actor-weight publishes under "
                   "--async")
    t.add_argument("--learn-ratio", type=float, default=ASYNC_DEFAULTS[3],
                   help="--async learner pacing: burst budget per ingested "
                   "env step relative to the synchronous loop (1.0 = one "
                   "burst per replicas * episode_steps steps)")
    t.add_argument("--profile", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="write a torch.profiler Chrome trace of training "
                   "to <run>/profile/trace.json")
    t.add_argument("--tensorboard", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="write charts/episodic_return, charts/SPS and "
                   "losses/* per episode to <run>/tb through "
                   "torch.utils.tensorboard (nothing where it does not "
                   "import)")
    t.add_argument("--substep-impl", choices=("xla", "pallas"), default=None,
                   help="the simulator yaml's 'substep_impl' override, "
                   "validated and recorded as in the JAX CLI; every "
                   "interval runs the substep kernel on the card either way")
    t.add_argument("--unroll", type=int, default=None,
                   help="the simulator yaml's 'scan_unroll' override (>= 1), "
                   "validated and recorded as in the JAX CLI; the port has "
                   "no substep scan to unroll")

    m = sub.add_parser("simulate", help="a standalone simulator run: a "
                       "uniform schedule over every node and every SF "
                       "placed everywhere under the duration controller, "
                       "or per-flow control")
    m.add_argument("--duration", "-d", type=float, default=1000.0,
                   help="simulated ms")
    m.add_argument("--network", "-n", required=True, help="GraphML file")
    m.add_argument("--service", "-sf", required=True,
                   help="service catalog yaml")
    m.add_argument("--config", "-c", required=True,
                   help="simulator config yaml")
    m.add_argument("--seed", type=int, default=0)
    m.add_argument("--max-nodes", type=int, default=24)
    m.add_argument("--max-edges", type=int, default=37)
    m.add_argument("--per-flow-algo", choices=("local", "spr"),
                   default="local",
                   help="the per-flow algorithm under 'controller: "
                   "per_flow': 'local' processes every flow at its node (a "
                   "policy on the device), 'spr' runs the shortest-path "
                   "heuristic through the host PerFlowController loop")
    _plugins_arg(m)
    _device_arg(m)

    i = sub.add_parser("infer", help="greedy episodes of a checkpoint's "
                       "actor on the inference network")
    _config_args(i, "infer on")
    i.add_argument("--scheduler", help="scheduler yaml (its inference "
                   "network is evaluated)")
    i.add_argument("--checkpoint", required=True)
    i.add_argument("--episodes", type=int, default=1)
    i.add_argument("--precision", choices=_PRECISIONS, default=None,
                   help="precision policy (default: the checkpoint's "
                   "recorded one, else the agent yaml's)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.command == "train":
        _train(args)
        return 0
    if args.command == "infer":
        _infer(args)
        return 0
    if args.command == "simulate":
        _simulate(args)
        return 0
    if args.command == "init-configs":
        init_configs(args.out)
        print(f"wrote example configs under {args.out}/")
        return 0
    return _serve(args)


if __name__ == "__main__":
    sys.exit(main())
