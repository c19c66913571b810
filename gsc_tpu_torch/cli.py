"""Command line of the port: ``python -m gsc_tpu_torch.cli serve`` and
``python -m gsc_tpu_torch.cli train``.

``serve`` runs :func:`gsc_tpu_torch.serve.run_serve` and prints its
summary (requests/s, p50/p99 latency per bucket) as one JSON line; with
``--checkpoint`` it serves the trained actor of a ``train --checkpoint``
run under the precision policy its sidecar records (a contradicting
``--precision`` is refused), else an actor drawn from ``--seed``.
``train`` runs replica-parallel DDPG training
(:meth:`gsc_tpu_torch.agents.trainer.Trainer.train_parallel`): one JSON
line per episode (return, mean and final success ratio, critic and actor
loss, q, env-steps/s), ``rewards.csv`` in ``--result-dir`` and a final
summary line naming the precision policy; ``--precision`` overrides the
agent yaml's, and ``--checkpoint`` saves the learner state, the replay
shards and the random source at the end, with the policy in the
checkpoint's sidecar.  The agent, simulator and service configs load from
the same YAML files as ``gsc_tpu.cli`` writes with ``init-configs`` when
given (``yaml`` must be importable then); without them the init-configs
values are built in code, with the attention kernel
(``gnn_impl="pallas"``); on the card every simulator interval runs the
substep megakernel.  The network is a built-in topology (GraphML reading
is not ported).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

_NETWORKS = ("abilene", "bteurope")
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


def _serve(args) -> int:
    from .config import abc_service, init_configs_sim
    from .config.loader import load_service, load_sim
    from .serve import run_serve
    from .topology import synthetic

    precision = args.precision
    if args.checkpoint:
        from .utils.checkpoint import checkpoint_precision
        try:
            precision = checkpoint_precision(args.checkpoint, precision)
        except ValueError as e:
            raise SystemExit(str(e))
    agent = _agent(args, precision)
    sim_cfg = (load_sim(args.simulator_config) if args.simulator_config
               else init_configs_sim())
    service = load_service(args.service) if args.service else abc_service()
    spec = getattr(synthetic, args.network)()
    try:
        buckets = tuple(sorted({int(b) for b in args.buckets.split(",")}))
    except ValueError:
        raise SystemExit(f"--buckets must be comma-separated ints, got "
                         f"{args.buckets!r}")
    report = run_serve(agent, sim_cfg, service, spec, seed=args.seed,
                       pool_steps=args.pool_steps, requests=args.requests,
                       concurrency=args.concurrency, buckets=buckets,
                       deadline_ms=args.deadline_ms,
                       max_nodes=args.max_nodes, max_edges=args.max_edges,
                       request_timeout=args.request_timeout,
                       device=args.device, checkpoint=args.checkpoint)
    print(json.dumps(report.summary()))
    return 1 if report.errors else 0


def _train(args) -> dict:
    from .agents.trainer import Trainer
    from .config import abc_service, init_configs_sim
    from .config.loader import load_service, load_sim
    from .config.schema import EnvLimits
    from .device import resolve_device
    from .env.driver import EpisodeDriver
    from .env.env import ServiceCoordEnv
    from .topology import synthetic
    from .topology.compiler import compile_topology

    dev = resolve_device(args.device)
    agent = _agent(args, args.precision)
    sim_cfg = (load_sim(args.simulator_config) if args.simulator_config
               else init_configs_sim())
    service = load_service(args.service) if args.service else abc_service()
    limits = EnvLimits.for_service(service, max_nodes=args.max_nodes,
                                   max_edges=args.max_edges)
    topo = compile_topology(getattr(synthetic, args.network)(),
                            max_nodes=args.max_nodes,
                            max_edges=args.max_edges)
    env = ServiceCoordEnv(service, sim_cfg, agent, limits)
    driver = EpisodeDriver(topo, sim_cfg, service, agent.episode_steps,
                           base_seed=args.seed)
    trainer = Trainer(env, driver, agent, seed=args.seed,
                      result_dir=args.result_dir, device=dev)
    t0 = time.perf_counter()
    state, buffers = trainer.train_parallel(
        args.episodes, args.replicas, chunk=args.chunk,
        on_row=lambda row: print(json.dumps(row), flush=True))
    if args.checkpoint:
        from .utils.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, state, buffer=buffers,
                        meta={"precision": agent.precision,
                              "episode": args.episodes},
                        checksum=True, draws=trainer.pddpg.draws)
    summary = {"device": str(dev), "precision": agent.precision,
               "replicas": args.replicas, "episodes": args.episodes,
               "episode_steps": agent.episode_steps,
               "wall_s": time.perf_counter() - t0,
               "final_return": trainer.history[-1]["episodic_return"]
               if trainer.history else None,
               "sps": trainer.history[-1]["sps"] if trainer.history
               else None,
               "checkpoint": (os.path.abspath(args.checkpoint)
                              if args.checkpoint else None)}
    print(json.dumps(summary), flush=True)
    return {"summary": summary, "trainer": trainer, "state": state,
            "buffers": buffers}


def run_train(argv: List[str]) -> dict:
    """``train`` with these arguments; returns the summary, the trainer,
    the learner state and the replay shards."""
    args = _parser().parse_args(["train", *argv])
    return _train(args)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gsc_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("serve", help="serve greedy-policy requests from a "
                       "trained or seeded actor and report requests/s and "
                       "p50/p99")
    s.add_argument("--agent-config", help="agent yaml, whose gnn_impl "
                   "picks the attention path (default: the init-configs "
                   "agent with gnn_impl 'pallas', the fused kernel)")
    s.add_argument("--checkpoint", default=None,
                   help="a `train --checkpoint` directory: serve its actor "
                   "under the precision its sidecar records (default: an "
                   "actor drawn from --seed)")
    s.add_argument("--precision", choices=_PRECISIONS, default=None,
                   help="precision policy of a seeded actor (default: the "
                   "agent yaml's); with --checkpoint it must match the "
                   "checkpoint's")
    s.add_argument("--simulator-config", help="simulator yaml")
    s.add_argument("--service", help="service catalog yaml (default: abc)")
    s.add_argument("--network", choices=_NETWORKS, default="abilene")
    s.add_argument("--requests", type=int, default=64)
    s.add_argument("--concurrency", type=int, default=4)
    s.add_argument("--buckets", default="1,4,8")
    s.add_argument("--deadline-ms", type=float, default=5.0)
    s.add_argument("--pool-steps", type=int, default=8)
    s.add_argument("--request-timeout", type=float, default=120.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--max-nodes", type=int, default=24)
    s.add_argument("--max-edges", type=int, default=37)
    s.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                   "versions)")
    t = sub.add_parser("train", help="replica-parallel DDPG training on a "
                       "built-in network")
    t.add_argument("--agent-config", help="agent yaml (default: the "
                   "init-configs agent with gnn_impl 'pallas')")
    t.add_argument("--simulator-config", help="simulator yaml (default: "
                   "the init-configs simulator)")
    t.add_argument("--service", help="service catalog yaml (default: abc)")
    t.add_argument("--network", choices=_NETWORKS, default="abilene")
    t.add_argument("--replicas", type=int, default=64)
    t.add_argument("--chunk", type=int, default=50)
    t.add_argument("--episodes", type=int, default=2)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--result-dir", default=None,
                   help="directory for rewards.csv (none: not written)")
    t.add_argument("--precision", choices=_PRECISIONS, default=None,
                   help="precision policy, overriding the agent yaml's "
                   "(f32: the f32 stack; bf16: bf16 GNN, MLP heads and "
                   "replay, f32 masters and outputs)")
    t.add_argument("--checkpoint", default=None,
                   help="directory to save the learner state, replay and "
                   "random source in at the end (its precision goes to "
                   "<dir>.meta.json)")
    t.add_argument("--max-nodes", type=int, default=24)
    t.add_argument("--max-edges", type=int, default=37)
    t.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                   "versions)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.command == "train":
        _train(args)
        return 0
    return _serve(args)


if __name__ == "__main__":
    sys.exit(main())
