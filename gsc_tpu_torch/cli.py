"""Command line of the port: ``python -m gsc_tpu_torch.cli`` with the
commands ``init-configs``, ``train``, ``infer`` and ``serve``.

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
rollout chunks of ``--chunk`` steps.  It prints one JSON line per episode
and writes ``rewards.csv`` to ``--result-dir``; at the end it saves the
learner state, the replay, the random source and the completed-episode
count to ``--checkpoint`` (default ``<result-dir>/checkpoint``), with the
precision policy and a checksum in the checkpoint's sidecar, evaluates
one greedy episode on the inference network (the test-mode CSV suite goes
to ``<result-dir>/test``) and prints a last JSON line with the checkpoint
and the evaluation.  ``--resume PATH|auto`` continues a checkpoint
(``auto``: the newest under ``--result-dir`` whose checksum validates)
bit for bit, under the checkpoint's precision; ``--ckpt-interval N``
saves rotating checkpoints to ``<result-dir>/ckpts`` every N episodes.

``infer --checkpoint PATH`` restores a checkpoint's learner state and
prints the evaluation of ``--episodes`` greedy episodes on the inference
network, under the checkpoint's recorded precision (else the agent
yaml's) unless ``--precision`` says otherwise.

``serve`` runs :func:`gsc_tpu_torch.serve.run_serve` on ``--network``
(as ``train`` takes it) and prints its summary (requests/s, p50/p99 latency per bucket) as one JSON line; with
``--checkpoint`` it serves a checkpoint's actor under the precision its
sidecar records (a contradicting ``--precision`` is refused; without a
readable sidecar the agent yaml's), else an actor drawn from ``--seed``.

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

_NETWORKS = ("abilene", "bteurope", "claranet", "compuserve", "tinet",
             "chinanet", "interroute")
_PRECISIONS = ("f32", "bf16")


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

    sim_cfg = (load_sim(args.simulator_config) if args.simulator_config
               else init_configs_sim())
    service = load_service(args.service) if args.service else abc_service()
    return sim_cfg, service


def _build(args, precision):
    """(env, driver, agent) of ``train`` and ``infer``: the scheduler
    yaml's networks, or the built-in ``--network`` as a schedule of one."""
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
    if args.scheduler:
        if args.network:
            raise SystemExit("--network and --scheduler exclude each other")
        driver = EpisodeDriver(load_scheduler(args.scheduler), sim_cfg,
                               service, agent.episode_steps,
                               max_nodes=args.max_nodes,
                               max_edges=args.max_edges, base_seed=args.seed)
    elif _is_graphml(args.network):
        # a GraphML network file: a schedule of one, as a scheduler yaml
        # naming it would be (the simulator's force caps apply)
        net = args.network
        driver = EpisodeDriver(SchedulerConfig((net,), net), sim_cfg,
                               service, agent.episode_steps,
                               max_nodes=args.max_nodes,
                               max_edges=args.max_edges, base_seed=args.seed)
    else:
        name = args.network or "abilene"
        topo = compile_topology(_network_spec(name),
                                max_nodes=args.max_nodes,
                                max_edges=args.max_edges)
        try:
            driver = EpisodeDriver.single(topo, sim_cfg, service,
                                          agent.episode_steps, name,
                                          base_seed=args.seed)
        except ValueError as e:
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


def _serve(args) -> int:
    from .serve import run_serve

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
    try:
        buckets = tuple(sorted({int(b) for b in args.buckets.split(",")}))
    except ValueError:
        raise SystemExit(f"--buckets must be comma-separated ints, got "
                         f"{args.buckets!r}")
    try:
        report = run_serve(agent, sim_cfg, service, spec, seed=args.seed,
                           pool_steps=args.pool_steps,
                           requests=args.requests,
                           concurrency=args.concurrency, buckets=buckets,
                           deadline_ms=args.deadline_ms,
                           max_nodes=args.max_nodes,
                           max_edges=args.max_edges,
                           request_timeout=args.request_timeout,
                           device=args.device, checkpoint=args.checkpoint)
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


def _train(args) -> dict:
    from .agents.trainer import Trainer
    from .device import resolve_device
    from .resilience.ckpt import CheckpointManager
    from .utils.checkpoint import (checkpoint_precision, load_full_or_partial,
                                   save_checkpoint)

    dev = resolve_device(args.device)
    resume = _resume_path(args)
    precision = args.precision
    if resume:
        try:
            precision = checkpoint_precision(resume, precision)
        except ValueError as e:
            raise SystemExit(str(e))
    env, driver, agent = _build(args, precision)
    trainer = Trainer(env, driver, agent, seed=args.seed,
                      result_dir=args.result_dir, device=dev)
    manager = (CheckpointManager(os.path.join(args.result_dir, "ckpts"),
                                 meta={"precision": agent.precision})
               if args.result_dir else None)
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
        else:
            print("[resume] replay not restorable (replay config such as "
                  "mem_limit or --replicas changed since the checkpoint): "
                  "restored the learner state only, replay starts empty",
                  file=sys.stderr)
        start_episode = int(restored["extra"].get("episode", 0))
        if start_episode >= args.episodes:
            raise SystemExit(
                f"--episodes ({args.episodes}) must exceed the checkpoint's "
                f"completed episode count ({start_episode})")
    on_row = lambda row: print(json.dumps(row), flush=True)
    t0 = time.perf_counter()
    if args.replicas > 1:
        state, buffer = trainer.train_parallel(
            args.episodes, args.replicas, chunk=args.chunk, on_row=on_row,
            init_state=init_state, init_buffers=init_buffer,
            start_episode=start_episode, ckpt_manager=manager,
            ckpt_interval=args.ckpt_interval)
    else:
        state, buffer = trainer.train(
            args.episodes, init_state=init_state, init_buffer=init_buffer,
            start_episode=start_episode, ckpt_manager=manager,
            ckpt_interval=args.ckpt_interval, on_row=on_row)
    train_s = time.perf_counter() - t0
    ckpt = args.checkpoint or (os.path.join(args.result_dir, "checkpoint")
                               if args.result_dir else None)
    save_s = None
    if ckpt:
        t1 = time.perf_counter()
        ckpt = save_checkpoint(ckpt, state, buffer=buffer,
                               meta={"precision": agent.precision,
                                     "episode": args.episodes},
                               checksum=True, draws=trainer.draws,
                               extra={"episode": args.episodes})
        save_s = time.perf_counter() - t1
    wall_s = time.perf_counter() - t0
    test = trainer.evaluate(state, episodes=1, test_mode=True,
                            telemetry=True)
    last = trainer.history[-1] if trainer.history else {}
    summary = {"device": str(dev), "precision": agent.precision,
               "replicas": args.replicas, "episodes": args.episodes,
               "start_episode": start_episode,
               "episode_steps": agent.episode_steps,
               "train_s": train_s, "wall_s": wall_s,
               "ckpt_save_s": save_s, "ckpt_load_s": load_s,
               "final_return": last.get("episodic_return"),
               "sps": last.get("sps"),
               "result_dir": (os.path.abspath(args.result_dir)
                              if args.result_dir else None),
               "checkpoint": ckpt, **test}
    print(json.dumps(summary), flush=True)
    return {"summary": summary, "trainer": trainer, "state": state,
            "buffers": buffer, "eval": test}


def run_train(argv: List[str]) -> dict:
    """``train`` with these arguments; returns the summary, the trainer,
    the learner state, the replay and the evaluation."""
    return _train(_parser().parse_args(["train", *argv]))


def _infer(args) -> dict:
    from .agents.trainer import Trainer
    from .device import resolve_device
    from .utils.checkpoint import checkpoint_precision, load_full_or_partial

    dev = resolve_device(args.device)
    # an explicit --precision overrides the recorded one, as in the JAX CLI
    precision = (args.precision
                 or checkpoint_precision(args.checkpoint, implicit=None))
    env, driver, agent = _build(args, precision)
    trainer = Trainer(env, driver, agent, seed=args.seed, device=dev)
    state = trainer.init_state()
    load_full_or_partial(args.checkpoint, state)
    out = trainer.evaluate(state, episodes=args.episodes, test_mode=True)
    print(json.dumps(out), flush=True)
    return {"eval": out, "trainer": trainer, "state": state}


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
    _device_arg(p)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gsc_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("init-configs", help="write an example config set "
                       "(agent, simulator, service, scheduler, networks)")
    c.add_argument("--out", default="configs")

    s = sub.add_parser("serve", help="serve greedy-policy requests from a "
                       "trained or seeded actor and report requests/s and "
                       "p50/p99")
    _config_args(s, "serve on")
    s.add_argument("--checkpoint", default=None,
                   help="a `train` checkpoint directory: serve its actor "
                   "under the precision its sidecar records (default: an "
                   "actor drawn from --seed)")
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

    t = sub.add_parser("train", help="DDPG training over a topology "
                       "schedule: one env (--replicas 1) or B replicas")
    _config_args(t, "train and infer on")
    t.add_argument("--scheduler", help="scheduler yaml: GraphML training "
                   "networks, switching period, inference network")
    t.add_argument("--replicas", type=int, default=1,
                   help="1: the single-env loop; B > 1: B replicas in "
                   "lockstep, rollout chunks of --chunk steps")
    t.add_argument("--chunk", type=int, default=50)
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
                   help="save a checkpoint to <result-dir>/ckpts every N "
                   "episodes, keeping the newest 3 (0: never)")

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
    if args.command == "init-configs":
        init_configs(args.out)
        print(f"wrote example configs under {args.out}/")
        return 0
    return _serve(args)


if __name__ == "__main__":
    sys.exit(main())
