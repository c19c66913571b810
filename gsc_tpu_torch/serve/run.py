"""``run_serve``: the body of ``cli serve`` for the port.

The port of the JAX package's ``cli serve``.  It builds the env and rolls
a pool of real graph observations under the uniform schedule before
serving starts, then picks the tier: the learned tier with the actor of a
checkpoint (``train --checkpoint``, under the precision policy its
sidecar records), or without one the SPR tier
(:class:`~gsc_tpu_torch.serve.fallback.SPRFallbackPolicy`).  The Python
API alone can serve an actor drawn from ``seed`` (``seeded_actor=True``);
no CLI flag does.  One server, or ``workers`` of them behind a
:class:`~gsc_tpu_torch.serve.fleet.FleetDispatcher` (a learned fleet with
an SPR brownout tier); ``continuous`` picks the continuous batcher;
``hot_swap_dir`` makes every server watch a publish directory, and
``fire_swaps`` publishes that many versions of the served weights into it
while the load runs, each after the previous one was adopted by every
worker.  Closed-loop load: ``concurrency`` client threads submit
``requests`` requests (with ``until``, a ``threading.Event``, they go on
until it is set).  With an ``observer`` (a ``RunObserver``, started and
closed here, with status ``"error"`` on an exception) the servers trace
requests (``trace_sample``, ``slo``) and write ``slo.json``.

Learned workers on the card each dispatch on a CUDA stream of their own,
so a batch never queues behind another worker's or a trainer's launches
on the default stream.  Requests keep f32 observation leaves whatever the
policy: a bf16 actor casts inside.  Everything runs on ``device`` (the
card unless the caller asks for the CPU).
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
from ..config.registry import load_resource_function_plugins
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
from ..utils.checkpoint import (check_graph_mode, checkpoint_fingerprint,
                                checkpoint_precision, load_actor_state)
from .fallback import SPRFallbackPolicy
from .fleet import FleetDispatcher, WeightPublisher
from .policy import GreedyServePolicy
from .server import PolicyServer


def uniform_schedule_action(limits: EnvLimits,
                            node_mask: np.ndarray) -> np.ndarray:
    """Flat [A] uniform schedule over real nodes."""
    sched = np.zeros(limits.scheduling_shape, np.float32)
    sched[:, :, :, node_mask] = 1.0 / max(int(node_mask.sum()), 1)
    return sched.reshape(-1)


def host_obs(obs, row: int = 0):
    """One replica's observation as host (numpy) arrays: a ``GraphObs``
    of them, or the flat observation's array."""
    if not isinstance(obs, GraphObs):
        return obs[row].cpu().numpy()
    return GraphObs(**{f.name: getattr(obs, f.name)[row].cpu().numpy()
                       for f in dataclasses.fields(GraphObs)})


@dataclass
class ServeReport:
    """What one ``run_serve`` measured and answered."""

    device: str
    tier: str
    mode: str
    workers: int
    requests: int
    errors: List[str]
    wall_s: float
    latency: Dict[str, float]
    per_bucket: Dict[str, Dict[str, float]]
    startup: Dict
    # (n_real, bucket) of every dispatch of the tier's workers (not of a
    # brownout tier), and the learned tier's warm-up calls before them
    # (one per bucket and worker)
    flushes: List[Tuple[int, int]]
    warm_calls: int
    swaps: int
    published_versions: int
    policy_version: int
    brownout: Optional[Dict[str, int]]
    rejected: int
    slo: Optional[Dict]
    result_dir: Optional[str]
    # (pool index, answer [A]) per completed request, and beside each
    # (policy version, bucket, perf_counter at enqueue, latency ms)
    answers: List[Tuple[int, np.ndarray]] = field(repr=False)
    stamps: List[Tuple[Optional[int], Optional[int], float, float]] = \
        field(repr=False)
    pool: List = field(repr=False)
    ddpg: Optional[DDPG] = field(repr=False)
    spr_action: Optional[np.ndarray] = field(repr=False, default=None)

    def summary(self) -> Dict:
        """``cli serve``'s JSON: the JAX command's keys (without its
        compile-cache and artifact-cache paths) and the port's own."""
        done = len(self.answers)
        return {
            "tier": self.tier, "requests": self.requests,
            "workers": self.workers, "mode": self.mode,
            "errors": len(self.errors), "error_detail": self.errors[:5],
            "wall_s": round(self.wall_s, 3),
            "rps": round(done / self.wall_s, 3) if self.wall_s > 0 else 0.0,
            "p50_ms": round(self.latency.get("p50", 0.0), 3),
            "p99_ms": round(self.latency.get("p99", 0.0), 3),
            "buckets": {b: {k: v[k] for k in ("requests", "p50_ms",
                                               "p99_ms")}
                        for b, v in self.per_bucket.items()},
            "slo": self.slo, "swaps": self.swaps,
            "published_versions": self.published_versions,
            "policy_version": self.policy_version,
            "brownout": self.brownout, "startup": self.startup,
            "result_dir": self.result_dir,
            "device": self.device, "completed": done,
            "rejected": self.rejected,
            "per_bucket": self.per_bucket,
            "dispatches": len(self.flushes),
        }


def run_serve(agent: Optional[AgentConfig] = None,
              sim_cfg: Optional[SimConfig] = None,
              service: Optional[ServiceConfig] = None,
              spec: Optional[NetworkSpec] = None, *, seed: int = 0,
              pool_steps: int = 8, requests: int = 64, concurrency: int = 4,
              buckets: Sequence[int] = (1, 4, 8), deadline_ms: float = 5.0,
              max_nodes: int = 24, max_edges: int = 37,
              request_timeout: float = 120.0, device=None,
              checkpoint: Optional[str] = None, seeded_actor: bool = False,
              continuous: bool = False, workers: int = 1,
              brownout_burn: Optional[float] = 2.0,
              hot_swap_dir: Optional[str] = None, swap_poll_s: float = 0.2,
              fire_swaps: int = 0, stats_interval: int = 50,
              max_queue: int = 4096, observer=None, trace_sample: int = 0,
              slo=None, until: Optional[threading.Event] = None,
              resource_functions_path: Optional[str] = None
              ) -> ServeReport:
    """Serve ``requests`` requests; defaults are the ``init-configs``
    flagship (Abilene, abc chain, GATv2 22x2x2 with the fused attention
    kernel, actor hidden 256).  ``slo`` is an ``SLOObjectives``;
    ``brownout_burn`` None turns the fleet's burn shedding off (overflow
    shedding stays).  ``resource_functions_path`` loads resource-function
    plugins (``config.registry``) before the engine is built, for a
    ``service`` whose SFs name them; the request pool's intervals run
    them compiled into the substep kernel on the card."""
    if requests < 1 or concurrency < 1:
        raise ValueError("requests and concurrency must be positive")
    if workers < 1:
        raise ValueError("workers must be >= 1")
    if fire_swaps and not hot_swap_dir:
        raise ValueError("fire_swaps publishes into the hot-swap "
                         "directory: give hot_swap_dir")
    if (trace_sample or slo is not None) and observer is None:
        raise ValueError("trace_sample and slo need an observer")
    dev = resolve_device(device)
    if resource_functions_path:
        load_resource_function_plugins(resource_functions_path)
    agent = agent if agent is not None \
        else init_configs_agent(gnn_impl="pallas")
    recorded = (checkpoint_precision(checkpoint, implicit=None)
                if checkpoint is not None else None)
    if recorded:
        agent = replace(agent, precision=recorded)
    if checkpoint is not None:
        check_graph_mode(checkpoint, agent.graph_mode)
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

    tier = "learned" if checkpoint is not None or seeded_actor else "spr"
    ddpg = fingerprint = None
    if tier == "learned":
        ddpg = DDPG(env, agent, device=dev)
        if checkpoint is not None:
            ddpg.actor.load_state_dict(load_actor_state(checkpoint))
            ddpg.actor.to(dev)
            fingerprint = checkpoint_fingerprint(checkpoint)
        else:
            ddpg.init(torch.Generator().manual_seed(seed))
            fingerprint = f"seed:{seed}"
    mode = "continuous" if continuous else "deadline"
    if observer is not None:
        observer.start(meta={
            "mode": "serve", "tier": tier, "seed": seed,
            "requests": requests, "concurrency": concurrency,
            "buckets": sorted(set(buckets)), "deadline_ms": deadline_ms,
            "batch_mode": mode, "workers": workers,
            "hot_swap_dir": hot_swap_dir, "fire_swaps": fire_swaps,
            "trace_sample": trace_sample,
            "slo": slo.to_doc() if slo is not None else None,
            "precision": agent.precision, "device": str(dev),
            "checkpoint": checkpoint})
    try:
        hub = observer.hub if observer is not None \
            else MetricsHub(tags={"seed": seed})
        slo_path = observer.slo_path if observer is not None else None

        def tracer():
            # each server gets its own: a tracer binds one SLO engine; the
            # shared hub merges their histograms and events fleet-wide
            if observer is None:
                return None
            from ..obs.slo import ServeTracer
            return ServeTracer(hub=hub, sample=trace_sample)

        common = dict(buckets=buckets, deadline_ms=deadline_ms, hub=hub,
                      graph_mode=agent.graph_mode,
                      stats_interval=stats_interval, mode=mode, slo=slo,
                      hot_swap_dir=hot_swap_dir, swap_poll_s=swap_poll_s,
                      max_queue=max_queue)
        spr = lambda: SPRFallbackPolicy(topo_host, limits, pool[0])
        learned = tier == "learned"
        # the cost ledger rides one server: the per-bucket capture is the
        # same on every worker, and the serve_batch_ms histogram it reads
        # at close is the fleet's already
        perf = observer.perf if observer is not None else None
        if perf is not None:
            perf.precision = agent.precision
        if learned:
            # a CUDA stream of its own for each learned worker on the card
            make = lambda **kw: PolicyServer(
                GreedyServePolicy(ddpg, pool[0], stream=(
                    torch.cuda.Stream(dev) if dev.type == "cuda" else None)),
                fingerprint=fingerprint, tracer=tracer(), **common, **kw)
        else:
            make = lambda **kw: PolicyServer(fallback=spr(), tracer=tracer(),
                                             **common, **kw)
        if workers == 1:
            fleet = [make(slo_path=slo_path, perf=perf)]
            frontend = server = fleet[0]
        else:
            fleet = [make(worker=f"w{i}", perf=perf if i == 0 else None)
                     for i in range(workers)]
            # a learned fleet sheds to an SPR tier; an SPR fleet is the bottom
            # tier already, and refuses overflow as one server would
            brownout = (PolicyServer(fallback=spr(), buckets=buckets,
                                     deadline_ms=deadline_ms, hub=hub,
                                     worker="spr", mode=mode,
                                     stats_interval=stats_interval,
                                     tracer=tracer(), slo=slo)
                        if learned else None)
            frontend = FleetDispatcher(fleet, spr=brownout, hub=hub,
                                       brownout_burn=(brownout_burn
                                                      if learned else None))
            server = fleet[0]
        # what --fire-swaps publishes: the served weights themselves (the SPR
        # tier's "weights" are its action), so answers stay the same while the
        # whole swap path runs under load
        payload = (server.policy.leaves() if learned
                   else [np.asarray(server.fallback.action)])
        frontend.start()
        publisher = None
        fire_stop = threading.Event()
        fire_thread = None
        if fire_swaps:
            publisher = WeightPublisher(hot_swap_dir, hub=hub)
            targets = [max(1, int(requests * (i + 1) / (fire_swaps + 1)))
                       for i in range(fire_swaps)]

            def fire():
                # each publish waits until every worker adopted the previous
                # one: a watcher swaps straight to the newest version, so two
                # publishes within one poll would count as one swap
                fired = 0
                while fired < len(targets) and not fire_stop.is_set():
                    done = hub.get_counter("serve_requests_total")
                    adopted = min(w.policy_version for w in fleet)
                    if done >= targets[fired] \
                            and adopted >= publisher.version:
                        publisher.publish(payload,
                                          meta={"fired_at": int(done)})
                        fired += 1
                    else:
                        fire_stop.wait(0.003)

            fire_thread = threading.Thread(target=fire, daemon=True,
                                           name="gsc-swap-firer")
            fire_thread.start()

        errors: List[str] = []
        answers: List[Tuple[int, np.ndarray]] = []
        stamps: List[Tuple] = []
        lock = threading.Lock()
        shares = [requests // concurrency + (1 if i < requests % concurrency
                                             else 0)
                  for i in range(concurrency)]

        def client(tid: int, n: int):
            j = 0
            while j < n or (until is not None and not until.is_set()):
                k = (tid + j * concurrency) % len(pool)
                j += 1
                try:
                    fut = frontend.submit(pool[k])
                    out = fut.result(request_timeout)
                except Exception as e:  # noqa: BLE001 - reported in the result
                    with lock:
                        errors.append(f"client{tid}/{j - 1}: "
                                      f"{type(e).__name__}: {e}")
                    continue
                with lock:
                    answers.append((k, out))
                    stamps.append((fut.policy_version, fut.bucket,
                                   fut.t_enqueued,
                                   (fut.t_completed - fut.t_enqueued) * 1e3))

        threads = [threading.Thread(target=client, args=(i, n),
                                    name=f"gsc-serve-client-{i}", daemon=True)
                   for i, n in enumerate(shares) if n]
        t0 = time.perf_counter()
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(None if until is not None
                       else request_timeout * max(shares))
            wall = time.perf_counter() - t0
            if any(t.is_alive() for t in threads):
                raise RuntimeError("serve clients still running after their "
                                   "timeout")
            if fire_thread is not None:
                # the firer's last publishes are adoption-gated: a few polls
                fire_thread.join(timeout=10.0)
                fire_stop.set()
                fire_thread.join(timeout=5.0)
            if hot_swap_dir is not None:
                # a bounded wait for every watcher to adopt the newest
                # version, so the swap count is the same from run to run
                from .fleet import read_latest
                rec = read_latest(hot_swap_dir)
                latest = rec["version"] if rec is not None else 0
                end = time.perf_counter() + 5.0
                while min(w.policy_version for w in fleet) < latest \
                        and time.perf_counter() < end:
                    time.sleep(swap_poll_s / 4)
        finally:
            fire_stop.set()
            frontend.close()
        # after close: the tracers' final drains have run
        lat = server.latency_summary() or {}
        per_bucket = {}
        for b in server.buckets:
            s = server.latency_summary(b)
            if s and s.get("count"):
                call = hub.histogram_summary("serve_batch_ms", bucket=b)
                per_bucket[str(b)] = {"requests": int(s["count"]),
                                      "p50_ms": round(s["p50"], 3),
                                      "p99_ms": round(s["p99"], 3),
                                      "dispatches": int(call["count"]),
                                      "call_ms_mean": call["mean"]}
        brownout = None
        slo_block = server.slo_summary()
        if workers > 1:
            brownout = {reason: int(hub.get_counter("serve_brownout_total",
                                                    reason=reason))
                        for reason in ("slo_burn", "overflow")}
            slo_block = frontend.slo_summary()
            merged = frontend.merged_slo()
            if slo_path is not None and merged is not None:
                # the fleet's slo.json: the merged engine snapshots with the
                # fleet-wide percentiles (per-worker numbers under per_worker)
                from ..obs.slo import SLO_SCHEMA_VERSION, write_slo_json
                write_slo_json(slo_path, {
                    "schema_version": SLO_SCHEMA_VERSION,
                    "ts": round(time.time(), 3),
                    "run": hub.base_tags.get("run"), "tier": server.tier,
                    "buckets": list(server.buckets),
                    "requests_completed": frontend.completed,
                    "p50_latency_ms": round(lat.get("p50", 0.0), 4),
                    "p99_latency_ms": round(lat.get("p99", 0.0), 4),
                    **merged})
        if observer is not None:
            observer.close(status="ok")
        return ServeReport(
            device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
            tier=tier, mode=mode, workers=workers, requests=requests,
            errors=errors, wall_s=wall, latency=lat, per_bucket=per_bucket,
            startup=server.startup,
            flushes=[f for w in fleet for f in w.flushes],
            warm_calls=len(fleet) * len(server.buckets) if learned else 0,
            swaps=sum(w.swaps for w in fleet),
            published_versions=publisher.version if publisher else 0,
            policy_version=server.policy_version, brownout=brownout,
            rejected=sum(int(hub.get_counter("serve_rejected_total",
                                             reason=r))
                         for r in ("queue_full", "stopping")),
            slo=slo_block,
            result_dir=observer.out_dir if observer is not None else None,
            answers=answers, stamps=stamps, pool=pool, ddpg=ddpg,
            spr_action=spr().action)
    except BaseException:
        if observer is not None:
            try:
                observer.close(status="error")
            except Exception:
                pass
        raise
