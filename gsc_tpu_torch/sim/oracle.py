"""The uniform-action engine harness of the coordsim oracles.

The port's copy of ``tools/reward_curve.py``'s ``uniform_engine_run``,
the harness behind the frozen numbers of the reference simulator
(tests/test_reference_parity.py): the ``cli simulate`` semantics over one
GraphML network, with a uniform schedule over the real nodes and every
SF placed on every real node, for ``steps`` control intervals, traffic
sampled once from ``seed``, 24 nodes and 37 edges.  It runs on the card
unless ``device="cpu"``; there every interval is one launch of kernel #2.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config.catalog import abc_service
from ..config.loader import load_sim
from ..config.schema import EnvLimits
from ..device import resolve_device
from .engine import SimEngine
from .state import DROP_REASONS, SimMetrics
from .traffic import generate_traffic

# the oracles' padding (tools/reward_curve.py's harness)
MAX_NODES, MAX_EDGES = 24, 37


def uniform_engine_run(network: str, steps: int, seed: int, config: str,
                       device=None, per_step: bool = False
                       ) -> Tuple[SimMetrics, int, List[Dict]]:
    """``steps`` intervals of the engine on ``network`` under the
    simulator yaml ``config`` and the reference's abc chain (3 x 5 ms).
    Returns the final metrics of the one replica (on the host), the
    number of real nodes and, when ``per_step``, the cumulative counters
    (generated, processed, dropped, drop_reasons, e2e_sum) after every
    interval."""
    from ..agents.ddpg import Draws
    from ..topology.compiler import load_topology

    dev = resolve_device(device)
    svc = abc_service()
    sim_cfg = load_sim(config)
    limits = EnvLimits.for_service(svc, max_nodes=MAX_NODES,
                                   max_edges=MAX_EDGES)
    topo = load_topology(network, max_nodes=MAX_NODES, max_edges=MAX_EDGES,
                         force_link_cap=sim_cfg.force_link_cap,
                         force_node_cap=sim_cfg.force_node_cap, seed=seed)
    traffic = generate_traffic(sim_cfg, svc, topo, steps, seed)
    engine = SimEngine(svc, sim_cfg, limits)
    nm = topo.node_mask.numpy()
    sched = np.zeros(limits.scheduling_shape, np.float32)
    sched[:, :, :, nm] = 1.0 / max(int(nm.sum()), 1)
    placement = np.broadcast_to(nm[:, None],
                                (MAX_NODES, limits.sf_pool)).copy()
    topo, traffic = topo.to(dev), traffic.to(dev)
    sched_t = torch.from_numpy(sched)[None].to(dev)
    place_t = torch.from_numpy(placement)[None].to(dev)
    state = engine.init(1, dev)
    draws = Draws(seed, dev)
    rows: List[Dict] = []
    for _ in range(steps):
        state, _ = engine.apply(state, topo, traffic, sched_t, place_t,
                                draws.sim_noise(engine, 1))
        if per_step:
            m = state.metrics
            rows.append({"generated": int(m.generated[0]),
                         "processed": int(m.processed[0]),
                         "dropped": int(m.dropped[0]),
                         "drop_reasons": m.drop_reasons[0].tolist(),
                         "e2e_sum": float(m.sum_e2e[0])})
    return state.metrics.map(lambda t: t[0].cpu()), int(nm.sum()), rows


def oracle_numbers(metrics: SimMetrics) -> Dict:
    """The oracle's fields of one replica's final metrics."""
    return {"generated": int(metrics.generated),
            "processed": int(metrics.processed),
            "dropped": int(metrics.dropped),
            "drop_reasons": {k: int(v) for k, v in
                             zip(DROP_REASONS, metrics.drop_reasons.tolist())},
            "avg_e2e": float(metrics.avg_e2e())}
