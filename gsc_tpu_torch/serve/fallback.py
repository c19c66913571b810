"""The non-learned serving tier: the SPR heuristic at schedule
granularity.

The port of ``gsc_tpu.serve.fallback``.  Without a checkpoint the server
answers from the shortest-path heuristic.  The per-flow SPR rule,
projected onto the schedule a request asks for:

1. a source node with capacity of its own keeps its traffic (process
   here);
2. otherwise all of its weight goes to the nearest capable node by
   shortest-path delay, unreachable nodes (the finite ``INF_DELAY``
   sentinel) excluded;
3. with no capable reachable node the weight stays put and the simulator
   records the NODE_CAP drop.

The projection depends on the topology alone (capacities and
shortest-path delays), so the tier computes one flat action at start and
answers every request with it: pure numpy on the host, no device call,
the same queue and latency accounting as the learned tier.
"""
from __future__ import annotations

import numpy as np

from ..config.schema import EnvLimits
from ..topology.compiler import INF_DELAY, Topology
from .policy import ObsTemplate


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def spr_schedule_action(topo: Topology, limits: EnvLimits) -> np.ndarray:
    """Flat ``[A]`` scheduling action; rows are one-hot, so the env's
    threshold and renormalisation leave it as it is."""
    node_mask = _host(topo.node_mask).astype(bool)
    cap = _host(topo.node_cap)
    pd = _host(topo.path_delay)
    n = limits.scheduling_shape[0]
    sched = np.zeros(limits.scheduling_shape, np.float32)
    capable = node_mask & (cap > 0)
    for src in range(n):
        if not node_mask[src]:
            continue
        if capable[src]:
            dst = src                                    # rule 1
        else:
            delays = np.where(capable, pd[src], INF_DELAY)
            dst = int(np.argmin(delays))                 # rule 2
            if delays[dst] >= INF_DELAY:
                dst = src                                # rule 3
        sched[src, :, :, dst] = 1.0
    return sched.reshape(-1)


class SPRFallbackPolicy:
    """Batcher backend of the SPR tier: the precomputed action, once per
    request.  ``sample_obs`` declares the request's shape, so a client
    sends the same observation to either tier (validated, then
    ignored)."""

    def __init__(self, topo: Topology, limits: EnvLimits, sample_obs):
        self.action = spr_schedule_action(topo, limits)
        self.template = ObsTemplate(sample_obs)

    def run_batch(self, leaves, n_real: int, bucket: int) -> np.ndarray:
        # np.tile, not broadcast_to: every answer is a writable row of
        # its own, as the learned tier's are
        return np.tile(self.action[None, :], (bucket, 1))
