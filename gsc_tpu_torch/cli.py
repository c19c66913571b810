"""Command line of the port: ``python -m gsc_tpu_torch.cli serve``.

``serve`` runs :func:`gsc_tpu_torch.serve.run_serve` and prints its
summary (requests/s, p50/p99 latency per bucket) as one JSON line.  The
agent, simulator and service configs load from the same YAML files as
``gsc_tpu.cli`` writes with ``init-configs`` when given (``yaml`` must be
importable then); without them the init-configs values are built in code.
The network is a built-in topology (GraphML reading is not ported).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

_NETWORKS = ("abilene", "bteurope")


def _serve(args) -> int:
    from .config import abc_service, init_configs_agent, init_configs_sim
    from .config.loader import load_agent, load_service, load_sim
    from .serve import run_serve
    from .topology import synthetic

    agent = (load_agent(args.agent_config) if args.agent_config
             else init_configs_agent(gnn_impl="pallas"))
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
                       device=args.device)
    print(json.dumps(report.summary()))
    return 1 if report.errors else 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m gsc_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("serve", help="serve greedy-policy requests from a "
                       "seeded actor and report requests/s and p50/p99")
    s.add_argument("--agent-config", help="agent yaml, whose gnn_impl "
                   "picks the attention path (default: the init-configs "
                   "agent with gnn_impl 'pallas', the fused kernel)")
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
    args = p.parse_args(argv)
    return _serve(args)


if __name__ == "__main__":
    sys.exit(main())
