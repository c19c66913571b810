"""``run_serve``: the body of ``cli serve`` for the port.

Builds the env, rolls a pool of real graph observations under the uniform
schedule, starts the learned serving tier with the actor of a checkpoint
(``train --checkpoint``, under the precision policy its sidecar records)
or actor weights drawn from a seeded ``torch.Generator``, fires
``requests`` closed-loop requests from ``concurrency`` client threads, and
reports requests/s and p50/p99 latency.  Requests keep f32 observation
leaves whatever the policy: a bf16 actor casts inside.  Everything runs on
``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..agents.ddpg import DDPG
from ..config.catalog import abc_service, init_configs_agent, init_configs_sim
from ..config.schema import (AgentConfig, EnvLimits, ServiceConfig,
                             SimConfig, replace)
from ..device import resolve_device
from ..env.driver import refuse_force_caps
from ..env.env import ServiceCoordEnv
from ..env.observations import GraphObs
from ..obs.hub import MetricsHub
from ..sim.traffic import generate_traffic
from ..topology import synthetic
from ..topology.compiler import NetworkSpec, compile_topology
from ..utils.checkpoint import checkpoint_precision, load_actor_state
from .policy import GreedyServePolicy
from .server import PolicyServer


def uniform_schedule_action(limits: EnvLimits,
                            node_mask: np.ndarray) -> np.ndarray:
    """Flat [A] uniform schedule over real nodes."""
    sched = np.zeros(limits.scheduling_shape, np.float32)
    sched[:, :, :, node_mask] = 1.0 / max(int(node_mask.sum()), 1)
    return sched.reshape(-1)


def host_obs(obs: GraphObs, row: int = 0) -> GraphObs:
    """One replica's observation as host (numpy) arrays."""
    return GraphObs(**{f.name: getattr(obs, f.name)[row].cpu().numpy()
                       for f in dataclasses.fields(GraphObs)})


@dataclass
class ServeReport:
    """What one ``run_serve`` measured and answered."""

    device: str
    requests: int
    errors: List[str]
    wall_s: float
    latency: Dict[str, float]
    per_bucket: Dict[str, Dict[str, float]]
    startup: Dict
    flushes: List[Tuple[int, int]]
    # (pool index, answer [A]) per completed request
    answers: List[Tuple[int, np.ndarray]] = field(repr=False)
    pool: List[GraphObs] = field(repr=False)
    ddpg: DDPG = field(repr=False)

    def summary(self) -> Dict:
        return {
            "device": self.device,
            "requests": self.requests,
            "completed": len(self.answers),
            "errors": len(self.errors),
            "wall_s": self.wall_s,
            "requests_per_s": len(self.answers) / self.wall_s,
            "p50_ms": self.latency.get("p50", 0.0),
            "p99_ms": self.latency.get("p99", 0.0),
            "per_bucket": self.per_bucket,
            "dispatches": len(self.flushes),
            "startup_s": self.startup.get("startup_s"),
        }


def run_serve(agent: Optional[AgentConfig] = None,
              sim_cfg: Optional[SimConfig] = None,
              service: Optional[ServiceConfig] = None,
              spec: Optional[NetworkSpec] = None, *, seed: int = 0,
              pool_steps: int = 8, requests: int = 64, concurrency: int = 4,
              buckets: Sequence[int] = (1, 4, 8), deadline_ms: float = 5.0,
              max_nodes: int = 24, max_edges: int = 37,
              request_timeout: float = 120.0, device=None,
              checkpoint: Optional[str] = None) -> ServeReport:
    """Serve ``requests`` greedy-policy requests; defaults are the
    ``init-configs`` flagship (Abilene, abc chain, GATv2 22x2x2 with the
    fused attention kernel, actor hidden 256).  With ``checkpoint`` the
    actor's weights are that checkpoint's and the agent takes the
    precision policy its sidecar records (without a readable sidecar,
    ``agent``'s); else they are drawn from ``seed``."""
    if requests < 1 or concurrency < 1:
        raise ValueError("requests and concurrency must be positive")
    dev = resolve_device(device)
    agent = agent if agent is not None else init_configs_agent(gnn_impl="pallas")
    recorded = (checkpoint_precision(checkpoint, implicit=None)
                if checkpoint is not None else None)
    if recorded:
        agent = replace(agent, precision=recorded)
    sim_cfg = sim_cfg if sim_cfg is not None else init_configs_sim()
    refuse_force_caps(sim_cfg, "the served network")
    service = service if service is not None else abc_service()
    spec = spec if spec is not None else synthetic.abilene()

    limits = EnvLimits.for_service(service, max_nodes=max_nodes,
                                   max_edges=max_edges)
    env = ServiceCoordEnv(service, sim_cfg, agent, limits)
    topo_host = compile_topology(spec, max_nodes=max_nodes,
                                 max_edges=max_edges)
    traffic = generate_traffic(sim_cfg, service, topo_host,
                               agent.episode_steps, seed).to(dev)
    topo = topo_host.to(dev)

    # request pool: real observations from rolling the env under the
    # uniform schedule, collected before serving starts
    env_state, ob = env.reset(topo, traffic, batch=1)
    action = torch.from_numpy(uniform_schedule_action(
        limits, topo_host.node_mask.numpy())).to(dev)[None]
    pool = [host_obs(ob)]
    for _ in range(max(pool_steps, 0)):
        env_state, ob, _, _, _ = env.step(env_state, topo, traffic, action)
        pool.append(host_obs(ob))

    ddpg = DDPG(env, agent, device=dev)
    if checkpoint is not None:
        ddpg.actor.load_state_dict(load_actor_state(checkpoint))
        ddpg.actor.to(dev)
    else:
        ddpg.init(torch.Generator().manual_seed(seed))
    hub = MetricsHub()
    server = PolicyServer(GreedyServePolicy(ddpg, pool[0]), buckets=buckets,
                          deadline_ms=deadline_ms, hub=hub).start()

    errors: List[str] = []
    answers: List[Tuple[int, np.ndarray]] = []
    lock = threading.Lock()
    shares = [requests // concurrency + (1 if i < requests % concurrency
                                         else 0)
              for i in range(concurrency)]

    def client(tid: int, n: int):
        for j in range(n):
            k = (tid + j * concurrency) % len(pool)
            try:
                out = server.submit(pool[k]).result(request_timeout)
            except Exception as e:  # noqa: BLE001 - reported in the result
                with lock:
                    errors.append(f"client{tid}/{j}: {type(e).__name__}: {e}")
                continue
            with lock:
                answers.append((k, out))

    threads = [threading.Thread(target=client, args=(i, n),
                                name=f"gsc-serve-client-{i}", daemon=True)
               for i, n in enumerate(shares) if n]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(request_timeout * max(shares))
        wall = time.perf_counter() - t0
    finally:
        server.close()
    if any(t.is_alive() for t in threads):
        raise RuntimeError("serve clients still running after their timeout")

    per_bucket = {}
    for b in server.buckets:
        s = server.latency_summary(b)
        if s and s.get("count"):
            call = hub.histogram_summary("serve_batch_ms", bucket=b)
            per_bucket[str(b)] = {"requests": int(s["count"]),
                                  "p50_ms": s["p50"], "p99_ms": s["p99"],
                                  "dispatches": int(call["count"]),
                                  "call_ms_mean": call["mean"]}
    return ServeReport(
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        requests=requests, errors=errors, wall_s=wall,
        latency=server.latency_summary() or {}, per_bucket=per_bucket,
        startup=server.startup, flushes=list(server.flushes),
        answers=answers, pool=pool, ddpg=ddpg)
