"""Check scenarios of the substep megakernel, built in code.

The cases of the JAX package's megakernel battery (tests/test_megakernel.py:
the six drop-taxonomy scenarios on a 3-node line, the WRR-collision
triangle, the saturated-link line of tests/assets/line3-linkcap2.graphml
under tests/assets/linkcap_config.yaml), one with fractional data rates,
Abilene with many replicas under a seeded non-uniform schedule, and the
seeded Abilene golden trajectory (tests/test_debug_and_golden.py), whose
frozen end-of-run numbers are ``GOLDEN``; and the generalization path's
cases (``generalization_cases``): a mixed batch of five networks, a link
and a node fault, and scenario-factory draws.  Everything is made from seeds
with numpy and torch, so ``chip_smoke.py`` and the card-only tests run the
same cases as the CPU tests.  Per-flow control has its own cases
(``perflow_cases``, ``perflow_apply_case``), driven substep by substep
by ``run_perflow_case``; ``chained_launches`` runs an interval as one
launch and as one launch per substep.  ``with_plugins`` re-runs any case
with resource-function plugins (``PLUGINS``: a quadratic, a capped
``where`` and a square root with a division; ``MATH_PLUGINS``: a
saturating ``tanh``, a ``log1p`` overhead and ``load ** 1.5`` behind a
``where``) in its SF columns, which the kernel then runs compiled in.

``run_case(case, device)`` drives ``SimEngine.apply`` over the case's
intervals on ``device`` and returns every state after an interval;
``run_case(case, device, plain=True)`` drives the kernel's plain version
instead, the reference that the kernel is held against.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config.catalog import abc_service, mixed_service
from ..config.schema import (EnvLimits, ServiceConfig, ServiceFunction,
                             SimConfig)
from ..topology import synthetic
from ..topology.compiler import NetworkSpec, Topology, compile_topology
from .engine import SimEngine
from .state import SimState, TrafficSchedule, stack_traffic, state_leaves
from .traffic import generate_traffic

# tests/test_debug_and_golden.py: seed 42, uniform schedule, caps 4,
# everything placed, 20 intervals
GOLDEN = {"generated": 800, "processed": 658, "dropped": 133, "active": 9,
          "drop_reasons": [0, 0, 0, 133], "avg_e2e": 34.75}
GOLDEN_AVG_E2E_TOL = 0.1


@dataclass
class SubstepCase:
    """One scenario: an engine, a topology (shared by the replicas, or
    stacked per replica), one TrafficSchedule per replica stacked [B, ...]
    (replica r's drawn with ``seeds[r]``), a schedule [B, N, C, S, N] and
    placement [B, N, P] held for ``intervals`` intervals."""

    name: str
    engine: SimEngine
    topo: Topology
    traffic: TrafficSchedule
    schedule: torch.Tensor
    placement: torch.Tensor
    intervals: int
    # the traffic seed of each replica
    seeds: Tuple[int, ...]

    @property
    def batch(self) -> int:
        return self.schedule.shape[0]

    def noise(self, interval: int) -> Optional[torch.Tensor]:
        """[B, substeps, M] normals for one interval (None when every
        processing delay is deterministic), drawn on the CPU so every
        device gets the same numbers."""
        gen = torch.Generator().manual_seed(interval)
        return self.engine.draw_noise(self.batch, gen, "cpu")


def _service(std: float = 0.0, startup: float = 0.0) -> ServiceConfig:
    sf = lambda n: ServiceFunction(name=n, processing_delay_mean=5.0,
                                   processing_delay_stdev=std,
                                   startup_delay=startup)
    return ServiceConfig(sfc_list={"sfc_1": ("a", "b", "c")},
                         sf_list={n: sf(n) for n in "abc"})


def _line(node_cap=10.0, link_cap=100.0, link_delay=3.0, n=8, e=8):
    return compile_topology(NetworkSpec(
        node_caps=[node_cap] * 3, node_types=["Ingress", "Normal", "Normal"],
        edges=[(0, 1, link_cap, link_delay), (1, 2, link_cap, link_delay)]),
        max_nodes=n, max_edges=e)


def _triangle(n=8, e=8):
    return compile_topology(NetworkSpec(
        node_caps=[20.0] * 3, node_types=["Ingress", "Normal", "Normal"],
        edges=[(0, 1, 100.0, 1.0), (0, 2, 100.0, 1.0), (1, 2, 100.0, 1.0)]),
        max_nodes=n, max_edges=e)


def _sched_to(limits: EnvLimits, dst: int) -> np.ndarray:
    s = np.zeros(limits.scheduling_shape, np.float32)
    s[:, :, :, dst] = 1.0
    return s


def _place(limits: EnvLimits, pairs) -> np.ndarray:
    p = np.zeros((limits.max_nodes, limits.sf_pool), bool)
    for n, s in pairs:
        p[n, s] = True
    return p


def _case(name, service, cfg, limits, topo, sched, place, intervals,
          steps, seeds=(0,)) -> SubstepCase:
    engine = SimEngine(service, cfg, limits)
    traffic = stack_traffic([generate_traffic(cfg, service, topo, steps,
                                              seed=s) for s in seeds])
    b = len(seeds)
    sched = np.broadcast_to(sched, (b,) + sched.shape[-4:]) \
        if sched.ndim == 4 else sched
    place = np.broadcast_to(place, (b,) + place.shape[-2:]) \
        if place.ndim == 2 else place
    return SubstepCase(name, engine, topo, traffic,
                       torch.from_numpy(np.array(sched, copy=True)),
                       torch.from_numpy(np.array(place, copy=True)),
                       intervals, tuple(seeds))


PLACE_ALL1 = [(1, 0), (1, 1), (1, 2)]
# tests/test_megakernel.py SCENARIOS: name -> (service, line kwargs, ttl,
# placement, schedule to node 1 or empty)
_BATTERY = {
    "stochastic_startup": (dict(std=1.0, startup=2.0), {}, 100.0,
                           PLACE_ALL1, True),
    "node_cap": ({}, dict(node_cap=0.5), 100.0, PLACE_ALL1, True),
    "link_cap": ({}, dict(link_cap=0.5), 100.0, PLACE_ALL1, True),
    "ttl": ({}, {}, 10.0, PLACE_ALL1, True),
    "unplaced_sf": ({}, {}, 100.0, [(1, 0), (1, 1)], True),
    "empty_schedule": ({}, {}, 100.0, [], False),
}


def battery_case(name: str) -> SubstepCase:
    """One of the six scenarios of tests/test_megakernel.py:137-144: 2
    intervals on the 3-node line (padded to 8 nodes / 8 edges)."""
    svc_kw, line_kw, ttl, place, to1 = _BATTERY[name]
    limits = EnvLimits(max_nodes=8, max_edges=8, num_sfcs=1, max_sfs=3)
    cfg = SimConfig(ttl_choices=(ttl,))
    sched = (_sched_to(limits, 1) if to1
             else np.zeros(limits.scheduling_shape, np.float32))
    return _case(name, _service(**svc_kw), cfg, limits, _line(**line_kw),
                 sched, _place(limits, place), intervals=2, steps=4)


def wrr_case() -> SubstepCase:
    """The WRR-collision triangle (tests/test_megakernel.py:160): a 50/50
    split at the ingress, same-substep collisions in one cell."""
    limits = EnvLimits(max_nodes=8, max_edges=8, num_sfcs=1, max_sfs=3)
    sched = np.zeros(limits.scheduling_shape, np.float32)
    sched[0, 0, 0, 1] = 0.5
    sched[0, 0, 0, 2] = 0.5
    for n in (1, 2):
        sched[n, 0, 1, n] = 1.0
        sched[n, 0, 2, n] = 1.0
    place = _place(limits, [(n, s) for n in (1, 2) for s in range(3)])
    return _case("wrr_collisions", _service(),
                 SimConfig(ttl_choices=(100.0,)), limits,
                 _triangle(), sched, place, intervals=2, steps=4)


def linkcap_case() -> SubstepCase:
    """The saturated-link line (tests/test_megakernel.py:177): the values
    of tests/assets/line3-linkcap2.graphml (node caps 100, links of
    capacity 2 and delay 10) and linkcap_config.yaml (arrivals every 2 ms,
    size 0.02), everything scheduled to the far end, 6 intervals."""
    service = abc_service()
    limits = EnvLimits.for_service(service, max_nodes=8, max_edges=8)
    cfg = SimConfig(inter_arrival_mean=2.0, deterministic_arrival=True,
                    flow_dr_mean=1.0, flow_dr_stdev=0.0,
                    flow_size_shape=0.02, deterministic_size=True,
                    run_duration=100.0, ttl_choices=(100.0,))
    topo = _line(node_cap=100.0, link_cap=2.0, link_delay=10.0)
    nm = topo.node_mask.numpy()
    place = np.broadcast_to(nm[:, None], (8, limits.sf_pool)).copy()
    return _case("saturated_link", service, cfg, limits, topo,
                 _sched_to(limits, 2), place, intervals=6, steps=6)


def fractional_case(batch: int = 2) -> SubstepCase:
    """Fractional data rates (dr ~ N(1, 0.35)) on the line with tight node
    and link capacities, so admissions fall on sums of fractions."""
    limits = EnvLimits(max_nodes=8, max_edges=8, num_sfcs=1, max_sfs=3)
    cfg = SimConfig(inter_arrival_mean=1.5, flow_dr_mean=1.0,
                    flow_dr_stdev=0.35, flow_size_shape=0.004,
                    ttl_choices=(60.0, 100.0))
    sched = np.zeros(limits.scheduling_shape, np.float32)
    sched[:, :, :, 1] = 0.5
    sched[:, :, :, 2] = 0.5
    place = _place(limits, [(n, s) for n in (1, 2) for s in range(3)])
    return _case("fractional_dr", _service(), cfg, limits,
                 _line(node_cap=3.3, link_cap=4.7), sched, place,
                 intervals=3, steps=4, seeds=tuple(range(batch)))


def wide_range_case() -> SubstepCase:
    """Data rates 1e10 and 1e-30 beside rates ~N(1, 0.35) on the line,
    everything placed on every node and scheduled to every node: the
    admission rounds hold values spanning ~2^130, more than a double's 53
    bits, so the kernel's exactness test sends them to its sequential
    scan (its serial-round count must grow)."""
    limits = EnvLimits(max_nodes=8, max_edges=8, num_sfcs=1, max_sfs=3)
    cfg = SimConfig(inter_arrival_mean=1.0, flow_dr_mean=1.0,
                    flow_dr_stdev=0.35, flow_size_shape=0.004,
                    ttl_choices=(60.0, 100.0))
    sched = np.zeros(limits.scheduling_shape, np.float32)
    sched[:, :, :, :3] = 1.0 / 3.0
    place = _place(limits, [(n, s) for n in range(3) for s in range(3)])
    case = _case("wide_range_dr", _service(), cfg, limits,
                 _line(node_cap=3.3, link_cap=4.7), sched, place,
                 intervals=3, steps=4, seeds=(0, 1))
    rng = np.random.default_rng(11)
    dr = case.traffic.arr_dr.numpy().copy()
    kind = rng.integers(0, 3, size=dr.shape)
    dr = np.where(kind == 0, np.float32(1e10),
                  np.where(kind == 1, np.float32(1e-30), dr))
    case.traffic = case.traffic.replace(arr_dr=torch.from_numpy(dr))
    return case


def _seeded_tables(limits: EnvLimits, node_mask: np.ndarray, batch: int,
                   seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per replica a seeded non-uniform schedule (rows over the replica's
    real nodes, some weights zero) and placement (each real node hosts
    each SF with probability 0.8); ``node_mask`` [N] or [B, N]."""
    nm = np.broadcast_to(node_mask, (batch, limits.max_nodes))
    rng = np.random.default_rng(seed)
    w = rng.uniform(size=(batch,) + limits.scheduling_shape)
    w = np.where(w < 0.6, 0.0, w) * nm[:, None, None, None, :]
    w[..., 0] += 1e-3 * (w.sum(-1) == 0)     # no row without a destination
    sched = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    place = (rng.uniform(size=(batch, limits.max_nodes, limits.sf_pool))
             < 0.8) & nm[:, :, None]
    return sched, place


def _seeded_case(name: str, service: ServiceConfig, cfg: SimConfig,
                 limits: EnvLimits, topo: Topology, batch: int,
                 intervals: int, seed: int) -> SubstepCase:
    """``batch`` replicas, each with its own traffic seed, schedule and
    placement (``_seeded_tables``)."""
    sched, place = _seeded_tables(limits, topo.node_mask.numpy(), batch,
                                  seed)
    return _case(name, service, cfg, limits, topo, sched,
                 place, intervals=intervals, steps=max(intervals, 4),
                 seeds=tuple(seed + 100 + r for r in range(batch)))


def abilene_case(batch: int = 64, intervals: int = 3, seed: int = 0,
                 max_flows: int = 128,
                 inter_arrival_mean: float = 10.0) -> SubstepCase:
    """Abilene (11 nodes padded to 24, 14 edges to 37) with ``batch``
    seeded replicas (``_seeded_case``), ``max_flows`` slots and
    ``inter_arrival_mean`` ms between a node's arrivals."""
    service = abc_service()
    limits = EnvLimits.for_service(service)
    cfg = SimConfig(ttl_choices=(100.0,), max_flows=max_flows,
                    inter_arrival_mean=inter_arrival_mean)
    topo = compile_topology(synthetic.abilene(node_cap_range=(2, 6)))
    name = f"abilene_b{batch}" + ("" if max_flows == 128
                                  else f"_m{max_flows}")
    return _seeded_case(name, service, cfg, limits, topo, batch, intervals,
                        seed)


def slot_sums_case(batch: int = 2, intervals: int = 2) -> SubstepCase:
    """Abilene under heavy traffic with stochastic processing delays (5 +-
    1 ms) and the "overhead" resource function: three or more fractional
    processing delays and end-to-end delays meet in one substep, where
    the whole-slot sums depend on the order of their terms, which the
    plain version keeps as the kernel does (``slot_order_sum``)."""
    sf = lambda n: ServiceFunction(name=n, processing_delay_mean=5.0,
                                   processing_delay_stdev=1.0,
                                   resource_function_id="overhead")
    service = ServiceConfig(sfc_list={"sfc_1": ("a", "b", "c")},
                            sf_list={n: sf(n) for n in "abc"})
    limits = EnvLimits.for_service(service)
    cfg = SimConfig(ttl_choices=(100.0,), inter_arrival_mean=1.0)
    topo = compile_topology(synthetic.abilene(node_cap_range=(4, 9)))
    return _seeded_case("slot_sums_abilene", service, cfg, limits, topo,
                        batch, intervals, seed=3)


def interroute_case(batch: int = 2, intervals: int = 1) -> SubstepCase:
    """bench.py's interroute stack: Interoute (110 nodes padded to 128, 146
    edges to 192, 4 ingress), the abc chain, 1024 flow slots, arrivals
    every 1 ms per ingress, seeded replicas (``_seeded_case``)."""
    service = abc_service()
    limits = EnvLimits.for_service(service, max_nodes=128, max_edges=192)
    cfg = SimConfig(ttl_choices=(100.0,), max_flows=1024,
                    inter_arrival_mean=1.0)
    topo = compile_topology(synthetic.interroute(), max_nodes=128,
                            max_edges=192)
    return _seeded_case("interroute", service, cfg, limits, topo, batch,
                        intervals, seed=5)


def rung5_case(batch: int = 2, intervals: int = 1) -> SubstepCase:
    """bench.py's rung-5 stack: ``random_network(200, num_ingress=8,
    seed=11)`` padded to 256 nodes and 384 edges, the mixed catalog (two
    chains over 5 SFs), 1024 flow slots, arrivals every 1 ms per ingress
    (at most the 8 a substep takes), seeded replicas."""
    service = mixed_service()
    limits = EnvLimits.for_service(service, max_nodes=256, max_edges=384)
    cfg = SimConfig(ttl_choices=(100.0,), max_flows=1024,
                    inter_arrival_mean=1.0)
    topo = compile_topology(
        synthetic.random_network(200, num_ingress=8, seed=11),
        max_nodes=256, max_edges=384)
    return _seeded_case("rung5", service, cfg, limits, topo, batch,
                        intervals, seed=7)


def golden_case() -> SubstepCase:
    """The seeded Abilene golden trajectory: caps 4 everywhere, traffic
    seed 42, uniform schedule over real nodes, everything placed, 20
    intervals (tests/test_debug_and_golden.py:24-43)."""
    service = _service()
    limits = EnvLimits(max_nodes=24, max_edges=37, num_sfcs=1, max_sfs=3)
    cfg = SimConfig(ttl_choices=(100.0,))
    topo = compile_topology(synthetic.abilene(node_cap_range=(4, 5)))
    nm = topo.node_mask.numpy()
    sched = np.zeros(limits.scheduling_shape, np.float32)
    sched[:, :, :, nm] = 1.0 / nm.sum()
    place = np.broadcast_to(nm[:, None], (24, 3)).copy()
    return _case("golden_abilene", service, cfg, limits, topo, sched, place,
                 intervals=20, steps=20, seeds=(42,))


# the mixed batch's networks, padded to Abilene's 24 nodes / 37 edges
MIXED_TOPO_MIX = "abilene,star12,ring10,line6,random12:7"


def _mixed_case(name: str, topo: Topology, traffic: TrafficSchedule,
                cfg: SimConfig, intervals: int, seed: int,
                seeds: Tuple[int, ...]) -> SubstepCase:
    """A case of per-replica topologies ``topo`` [B, ...] on the abc
    chain with seeded per-replica schedules and placements."""
    service = abc_service()
    limits = EnvLimits.for_service(service, max_nodes=topo.max_nodes,
                                   max_edges=topo.max_edges)
    batch = topo.node_cap.shape[0]
    sched, place = _seeded_tables(limits, topo.node_mask.numpy(), batch,
                                  seed)
    return SubstepCase(name, SimEngine(service, cfg, limits), topo, traffic,
                       torch.from_numpy(sched), torch.from_numpy(place),
                       intervals, seeds)


def mixed_topology_case(batch: int = 8, intervals: int = 3) -> SubstepCase:
    """A mixed batch: ``batch`` replicas round-robin over Abilene, star12,
    ring10, line6 and random12:7 (``MIXED_TOPO_MIX``) in one 24/37 bucket,
    each with its own host traffic (seed ``100 + r``): kernel #2 reads a
    different topology per replica through its per-replica strides."""
    from ..topology.compiler import TopologyBucket
    from ..topology.scenarios import (DEFAULT_REGISTRY, build_mix_entries,
                                      mix_traffic_host, plan_mix)

    cfg = SimConfig(ttl_choices=(100.0,), inter_arrival_mean=5.0)
    bucket = TopologyBucket(24, 37)
    entries = build_mix_entries(MIXED_TOPO_MIX, DEFAULT_REGISTRY, bucket)
    plan = plan_mix(entries, batch, bucket, cfg, intervals)
    seeds = tuple(100 + r for r in range(batch))
    traffic = mix_traffic_host(plan, cfg, abc_service(), intervals,
                               seed_for=lambda r: seeds[r])
    return _mixed_case("mixed_topology", plan.topo, traffic, cfg, intervals,
                       seed=21, seeds=seeds)


def _fault_case(name: str, faults: str) -> SubstepCase:
    """The 3-node line (links of capacity 100, nodes of 10, padded to 8/8)
    under a fault plan, everything scheduled to node 1 and placed there,
    two replicas of host traffic, 3 intervals."""
    from ..topology.scenarios import parse_topo_faults

    limits = EnvLimits(max_nodes=8, max_edges=8, num_sfcs=1, max_sfs=3)
    cfg = SimConfig(ttl_choices=(100.0,))
    topo = _line()
    plan = parse_topo_faults(faults)
    per = [generate_traffic(cfg, _service(), topo, 4, seed=s, faults=plan)
           for s in (0, 1)]
    place = _place(limits, PLACE_ALL1)
    b = len(per)
    return SubstepCase(
        name, SimEngine(_service(), cfg, limits), topo, stack_traffic(per),
        torch.from_numpy(np.broadcast_to(_sched_to(limits, 1),
                                         (b,) + limits.scheduling_shape)
                         .copy()),
        torch.from_numpy(np.broadcast_to(place, (b,) + place.shape).copy()),
        3, (0, 1))


def link_fault_case() -> SubstepCase:
    """The line with link 0 (ingress -> node 1) zeroed from interval 1:
    from then on every flow forwarded over it is dropped for link
    capacity (the per-interval ``edge_cap_t`` row)."""
    return _fault_case("link_fault", "link@1.0")


def node_fault_case() -> SubstepCase:
    """The line with node 1 (where every SF runs) zeroed from interval 1:
    from then on its processing is refused for node capacity."""
    return _fault_case("node_fault", "node@1.1")


def factory_case(batch: int = 16, intervals: int = 3,
                 seed: int = 5) -> SubstepCase:
    """``batch`` scenario-factory draws (``factory:all+shapes~faults``,
    every replica faulted: ``fault_rate`` 1) in the 24/37 bucket, sampled
    on the CPU from a generator seeded ``seed``: per-replica topologies,
    shaped traffic and link or node faults at once."""
    import dataclasses as dc

    from ..topology.factory import ScenarioFactory, parse_factory

    cfg = SimConfig(ttl_choices=(100.0,), inter_arrival_mean=5.0)
    spec = dc.replace(parse_factory("factory:all+shapes~faults"),
                      fault_rate=1.0)
    factory = ScenarioFactory(spec, cfg, abc_service(), intervals,
                              max_nodes=24, max_edges=37, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    probs = torch.full((spec.num_families,), 1.0 / spec.num_families)
    topo, traffic = factory.sample_batch(gen, probs, batch)
    return _mixed_case("factory", topo, traffic.map(
        lambda t: t.contiguous()), cfg, intervals, seed=seed + 1,
        seeds=(seed,) * batch)


def generalization_cases() -> List[SubstepCase]:
    """The generalization path's inputs of kernel #2: a mixed batch, a
    link fault, a node fault and factory draws.  None takes the
    sequential admission scan (``serial_rounds`` stays 0)."""
    return [mixed_topology_case(), link_fault_case(), node_fault_case(),
            factory_case()]


def mixed_attention_inputs(batch: int = 100, features: int = 22,
                           seed: int = 0):
    """Kernel #1's inputs on a mixed batch of graphs, as the
    generalization path's learn bursts give it: ``batch`` graphs taken in
    turn from the mixed case's five networks and from scenario-factory
    draws (4 to 24 real nodes in the 24/37 bucket), their dense
    adjacency with self-loops on real nodes (``ops.gat.dense_adj``), and
    seeded unit-normal ``xl``, ``xr``, ``att``, ``bias`` and a grad_out.
    Returns CPU tensors (xl, xr, att, bias, adj, grad)."""
    from ..ops.gat import dense_adj

    mixed = mixed_topology_case(batch=5, intervals=1).topo
    drawn = factory_case(batch=max(batch - 5, 1), intervals=1).topo
    pick = lambda t, r: t.map(lambda x: x[r])
    graphs = [pick(mixed, r) for r in range(5)] \
        + [pick(drawn, r) for r in range(drawn.node_cap.shape[0])]
    graphs = [graphs[r % len(graphs)] for r in range(batch)]
    ei, em, nm = [], [], []
    for g in graphs:
        e, m = g.directed_edge_index()
        ei.append(e)
        em.append(m)
        nm.append(g.node_mask)
    adj = dense_adj(torch.stack(ei), torch.stack(em), torch.stack(nm))
    rng = np.random.default_rng(seed)
    n = adj.shape[-1]
    f = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    return (f(batch, n, features), f(batch, n, features), f(features),
            f(features), adj, f(batch, n, features))


def all_cases(abilene_batch: int = 64) -> List[SubstepCase]:
    """The battery ``chip_smoke.py`` runs: the six scenarios, the WRR
    triangle, the saturated link, fractional rates, rates of a range no
    double holds, Abilene with ``abilene_batch`` replicas and with one (the
    single-env trainer's batch), Abilene under heavy traffic at 1024
    flow slots (32 warps) and at 200 (a partial last warp), and Abilene
    with stochastic delays under "overhead" (order-dependent whole-slot
    sums)."""
    return ([battery_case(n) for n in _BATTERY]
            + [wrr_case(), linkcap_case(), fractional_case(),
               wide_range_case(), abilene_case(batch=abilene_batch),
               abilene_case(batch=1)]
            + [abilene_case(batch=b, max_flows=m, inter_arrival_mean=1.0)
               for b, m in ((4, 1024), (2, 200))]
            + [slot_sums_case()])


def run_case(case: SubstepCase, device, plain: bool = False
             ) -> List[SimState]:
    """Drive the case's intervals on ``device`` through ``SimEngine.apply``
    (the megakernel on the card), or with ``plain`` through the kernel's
    plain version ``substep_plain``, the reference on either device;
    returns the state after each interval."""
    from ..ops.substep import substep_plain

    engine = case.engine
    b = case.batch
    topo = case.topo.to(device)
    traffic = case.traffic.to(device)
    sched = case.schedule.to(device)
    place = case.placement.to(device)
    state = engine.init(b, device)
    states = []
    for i in range(case.intervals):
        z = case.noise(i)
        z = None if z is None else z.to(device)
        if plain:
            state, cap_now = engine.begin_interval(
                state, traffic.expand(b), sched, place)
            topo_i = engine.interval_topology(state, topo.expand(b),
                                              traffic.expand(b))
            state = substep_plain(engine, state, topo_i,
                                  traffic.expand(b), cap_now, z)
            state = state.replace(run_idx=state.run_idx + 1)
        else:
            state, _ = engine.apply(state, topo, traffic, sched, place, z)
        states.append(state)
    return states


# ------------------------------------------- resource-function plugins
def _rf_quadratic(load):
    return load * load * 0.25 + load


def _rf_capped(load):
    return torch.where(load > 2.0, 2.0 + 0.5 * (load - 2.0), load)


def _rf_sqrt_ratio(load):
    return torch.sqrt(torch.relu(load)) + load / 3.0


def _rf_saturating(load):
    return 2.0 * torch.tanh(load / 2.0)


def _rf_log_overhead(load):
    return torch.where(load > 0.0, torch.log1p(load) + 0.1 * load,
                       torch.zeros_like(load))


def _rf_pow_where(load):
    return torch.where(load > 1.0, load ** 1.5, load)


# the plugins of the plugin cases, registered under these names
PLUGINS = {"case_quadratic": _rf_quadratic, "case_capped": _rf_capped,
           "case_sqrt_ratio": _rf_sqrt_ratio}
# the second set: functions kernel #2 evaluates in double (csrc/rf_math.cuh)
MATH_PLUGINS = {"case_tanh": _rf_saturating, "case_log1p": _rf_log_overhead,
                "case_pow15": _rf_pow_where}


def register_plugins() -> Tuple[str, ...]:
    """Register ``PLUGINS`` and ``MATH_PLUGINS`` (again, harmlessly);
    returns the names of ``PLUGINS``."""
    from ..config.registry import register_resource_function

    for name, fn in {**PLUGINS, **MATH_PLUGINS}.items():
        register_resource_function(name)(fn)
    return tuple(PLUGINS)


def _plugin_engine(engine: SimEngine, ids) -> SimEngine:
    """The engine with its SFs' resource functions replaced, column by
    column, by the plugins named in ``ids`` (cycled)."""
    register_plugins()
    sfs = {name: dataclasses.replace(sf, resource_function_id=ids[i % len(ids)])
           for i, (name, sf) in enumerate(engine.service.sf_list.items())}
    service = ServiceConfig(sfc_list=dict(engine.service.sfc_list),
                            sf_list=sfs)
    return SimEngine(service, engine.cfg, engine.limits)


def with_plugins(case, ids=tuple(PLUGINS)):
    """A ``SubstepCase`` or ``PerFlowCase`` whose engine runs the plugins
    named in ``ids`` in its SF columns (in column order, cycled);
    ``ids`` may be ``MATH_PLUGINS`` (any mapping of names) too."""
    ids = tuple(ids)
    label = "math_plugins" if ids == tuple(MATH_PLUGINS) else "plugins"
    return dataclasses.replace(case, name=f"{case.name}+{label}",
                               engine=_plugin_engine(case.engine, ids))


# ------------------------------------------------------ per-flow control
@dataclass
class PerFlowCase:
    """One per-flow scenario: ``substeps`` substeps of ``apply_substep``
    from an empty state under a policy: "local" (every deciding flow
    processes at its node) or "random" (a destination drawn per slot from
    the real nodes on a generator seeded by the substep, -1 with
    probability ``park``, so about that share of the decisions leave a
    flow parked)."""

    name: str
    engine: SimEngine
    topo: Topology
    traffic: TrafficSchedule
    batch: int
    substeps: int
    policy: str = "local"
    park: float = 1.0 / 3.0

    def decisions(self, state: SimState, k: int) -> torch.Tensor:
        """[B, M] i32 decisions before substep ``k``, on the state's
        device (the random ones drawn on the CPU, so every device gets
        the same numbers)."""
        from .perflow import local_decisions

        if self.policy == "local":
            return local_decisions(state)
        gen = torch.Generator().manual_seed(10_000 + k)
        shape = (self.batch, self.engine.M)
        n_real = int(self.topo.node_mask.reshape(-1, self.engine.N)
                     .sum(-1).min())
        dst = torch.randint(0, n_real, shape, generator=gen,
                            dtype=torch.int32)
        park = torch.rand(shape, generator=gen) < self.park
        return torch.where(park, -1, dst).to(state.t.device, torch.int32)

    def noise(self, k: int) -> Optional[torch.Tensor]:
        """[B, M] normals of substep ``k`` (None when every processing
        delay is deterministic), drawn on the CPU."""
        gen = torch.Generator().manual_seed(20_000 + k)
        z = self.engine.draw_noise(self.batch, gen, "cpu", substeps=1)
        return None if z is None else z[:, 0]


def perflow_local_case(intervals: int = 20) -> PerFlowCase:
    """The per-flow oracle: the local policy on
    tests/assets/line3-egress.graphml (padded to 8 nodes / 8 edges) under
    tests/assets/perflow_config.yaml (read by the loader: the FlowController
    key), the abc chain, traffic seed 1234; 20 intervals (2000 ms) give
    the frozen numbers ``PERFLOW_ORACLE``."""
    from pathlib import Path

    from ..config.loader import load_sim
    from ..topology.compiler import load_topology

    assets = Path(__file__).resolve().parents[2] / "tests" / "assets"
    service = abc_service()
    cfg = load_sim(str(assets / "perflow_config.yaml"))
    limits = EnvLimits.for_service(service, max_nodes=8, max_edges=8)
    topo = load_topology(str(assets / "line3-egress.graphml"), max_nodes=8,
                         max_edges=8)
    engine = SimEngine(service, cfg, limits)
    traffic = generate_traffic(cfg, service, topo, intervals, 1234)
    return PerFlowCase("perflow_local_line3", engine, topo, traffic, 1,
                       intervals * engine.substeps)


# tests/test_reference_parity.py:221-225: the reference's FlowController
# on line3-egress, 2000 ms at seed 1234 (generated within 2)
PERFLOW_ORACLE = {"generated": 201, "processed": 197, "dropped": 0,
                  "avg_e2e": 35.0}


def check_perflow_oracle(state: SimState) -> Dict:
    """Raise unless replica 0 meets ``PERFLOW_ORACLE``; returns its
    numbers."""
    m = state.metrics
    got = {"generated": int(m.generated[0]), "processed": int(m.processed[0]),
           "dropped": int(m.dropped[0]), "avg_e2e": float(m.avg_e2e()[0])}
    want = PERFLOW_ORACLE
    if abs(got["generated"] - want["generated"]) > 2 \
            or got["processed"] != want["processed"] \
            or got["dropped"] != want["dropped"] \
            or abs(got["avg_e2e"] - want["avg_e2e"]) > 1e-6 * want["avg_e2e"]:
        raise AssertionError(f"per-flow oracle: {got} against {want}")
    return got


def _perflow_cfg(**kw) -> SimConfig:
    return SimConfig(**{"ttl_choices": (100.0,), "controller": "per_flow",
                        **kw})


def perflow_random_case(batch: int = 64, substeps: int = 250,
                        seed: int = 0) -> PerFlowCase:
    """Abilene (24/37, caps 2-6, the abc chain) with ``batch`` replicas of
    their own traffic, random decisions with about a third parked, over
    ``substeps`` substeps (250: across two interval boundaries, where the
    run metrics reset)."""
    service = abc_service()
    limits = EnvLimits.for_service(service)
    cfg = _perflow_cfg()
    topo = compile_topology(synthetic.abilene(node_cap_range=(2, 6)))
    intervals = -(-substeps // cfg.substeps_per_run) + 1
    traffic = stack_traffic([generate_traffic(cfg, service, topo, intervals,
                                              seed=seed + 100 + r)
                             for r in range(batch)])
    return PerFlowCase(f"perflow_random_b{batch}",
                       SimEngine(service, cfg, limits), topo, traffic, batch,
                       substeps, policy="random")


def perflow_timeout_case() -> PerFlowCase:
    """tests/test_perflow.py:124's expiry: one early flow on the 3-node
    line, then silence; the local policy places its SFs on decision, they
    drain and expire after ``vnf_timeout`` 30 ms within 100 ms."""
    cfg = _perflow_cfg(ttl_choices=(1000.0,), vnf_timeout=30.0,
                       inter_arrival_mean=1000.0)
    limits = EnvLimits(max_nodes=8, max_edges=8, num_sfcs=1, max_sfs=3)
    topo = _line()
    traffic = generate_traffic(cfg, _service(), topo, 4, seed=0)
    return PerFlowCase("perflow_vnf_timeout",
                       SimEngine(_service(), cfg, limits), topo,
                       stack_traffic([traffic]), 1, 100)


def perflow_link_fault_case() -> PerFlowCase:
    """Random decisions on the 3-node line whose link 0 is zeroed from
    interval 1 (the ``edge_cap_t`` timeline of ``link_fault_case``), two
    replicas, 300 substeps."""
    from ..topology.scenarios import parse_topo_faults

    cfg = _perflow_cfg()
    limits = EnvLimits(max_nodes=8, max_edges=8, num_sfcs=1, max_sfs=3)
    topo = _line()
    plan = parse_topo_faults("link@1.0")
    traffic = stack_traffic([generate_traffic(cfg, _service(), topo, 4,
                                              seed=s, faults=plan)
                             for s in (0, 1)])
    return PerFlowCase("perflow_link_fault",
                       SimEngine(_service(), cfg, limits), topo, traffic, 2,
                       300, policy="random", park=0.2)


def perflow_stochastic_case() -> PerFlowCase:
    """The local policy on the 3-node line with stochastic processing
    delays (5 +- 1 ms) and a 2 ms startup delay, noise per substep, two
    replicas, 200 substeps."""
    cfg = _perflow_cfg()
    limits = EnvLimits(max_nodes=8, max_edges=8, num_sfcs=1, max_sfs=3)
    topo = _line()
    service = _service(std=1.0, startup=2.0)
    traffic = stack_traffic([generate_traffic(cfg, service, topo, 3, seed=s)
                             for s in (0, 1)])
    return PerFlowCase("perflow_stochastic", SimEngine(service, cfg, limits),
                       topo, traffic, 2, 200)


def perflow_cases() -> List[PerFlowCase]:
    """Phase 18's battery of the kernel's per-flow mode."""
    return [perflow_local_case(), perflow_random_case(),
            perflow_timeout_case(), perflow_link_fault_case(),
            perflow_stochastic_case()]


def perflow_apply_case() -> SubstepCase:
    """A duration-style ``apply`` under a per-flow config (the expiry
    without external decisions): the 3-node line, everything scheduled to
    node 1 and placed there, sparse traffic, ``vnf_timeout`` 30, so placed
    instances expire within an interval; 3 intervals."""
    limits = EnvLimits(max_nodes=8, max_edges=8, num_sfcs=1, max_sfs=3)
    cfg = _perflow_cfg(vnf_timeout=30.0, inter_arrival_mean=40.0)
    return _case("perflow_apply_expiry", _service(), cfg, limits, _line(),
                 _sched_to(limits, 1), _place(limits, PLACE_ALL1),
                 intervals=3, steps=4, seeds=(0, 1))


def run_perflow_case(case: PerFlowCase, device, plain: bool = False,
                     every: Optional[int] = None) -> List[SimState]:
    """Drive the case's substeps through ``SimEngine.apply_substep`` on
    ``device`` (one launch of the kernel's per-flow mode per substep on
    the card), or with ``plain`` through the plain substep on either
    device; returns the state after every ``every`` substeps (default:
    every interval) and after the last."""
    from ..ops.substep import substep_plain

    engine = case.engine
    b = case.batch
    every = every or engine.substeps
    topo = case.topo.to(device)
    traffic = case.traffic.to(device)
    state = engine.init(b, device)
    states = []
    for k in range(case.substeps):
        z = case.noise(k)
        z = None if z is None else z.to(device)
        dec = case.decisions(state, k)
        if plain:
            state, topo_k, cap = engine.begin_substep(
                state, topo.expand(b), traffic.expand(b))
            state = substep_plain(engine, state, topo_k, traffic.expand(b),
                                  cap, None if z is None else z[:, None], 1,
                                  dec)
        else:
            state = engine.apply_substep(state, topo, traffic, dec, z)
        if (k + 1) % every == 0 or k + 1 == case.substeps:
            states.append(state)
    return states


def chained_launches(case: SubstepCase, device
                     ) -> Tuple[SimState, SimState]:
    """The case's last interval from the state after its first intervals,
    as one launch of all its substeps and as that many chained launches of
    one substep each (on the card the kernel, on the CPU the plain
    version): (one launch's state, the chain's)."""
    from ..ops.substep import substep_megakernel

    engine = case.engine
    b = case.batch
    start = (run_case(case, device)[-2] if case.intervals > 1
             else engine.init(b, device))
    traffic = case.traffic.to(device).expand(b)
    state, cap = engine.begin_interval(start, traffic,
                                       case.schedule.to(device),
                                       case.placement.to(device))
    topo = engine.interval_topology(state, case.topo.to(device).expand(b),
                                    traffic)
    z = case.noise(case.intervals - 1)
    z = None if z is None else z.to(device)
    one = substep_megakernel(engine, state, topo, traffic, cap, z)
    chained = state
    for k in range(engine.substeps):
        chained = substep_megakernel(
            engine, chained, topo, traffic, cap,
            None if z is None else z[:, k:k + 1], substeps=1)
    return one, chained


def golden_numbers(state: SimState) -> Dict:
    """The golden trajectory's end-of-run counters of replica 0."""
    m = state.metrics
    proc = int(m.processed[0])
    return {"generated": int(m.generated[0]), "processed": proc,
            "dropped": int(m.dropped[0]), "active": int(m.active[0]),
            "drop_reasons": m.drop_reasons[0].tolist(),
            "avg_e2e": float(m.sum_e2e[0]) / proc if proc else 0.0}


def check_golden(state: SimState) -> Dict:
    """Raise unless the golden trajectory's numbers are the frozen ones."""
    got = golden_numbers(state)
    for k in ("generated", "processed", "dropped", "active", "drop_reasons"):
        if got[k] != GOLDEN[k]:
            raise AssertionError(f"golden {k}: {got[k]} != {GOLDEN[k]}")
    if abs(got["avg_e2e"] - GOLDEN["avg_e2e"]) > GOLDEN_AVG_E2E_TOL:
        raise AssertionError(f"golden avg_e2e {got['avg_e2e']} != "
                             f"{GOLDEN['avg_e2e']} +- {GOLDEN_AVG_E2E_TOL}")
    return got


def compare_states(got: SimState, want: SimState, rtol: float,
                   atol: float, what: str = "") -> float:
    """Integer and boolean leaves must be equal, float leaves within
    ``rtol``/``atol``; returns the largest float difference."""
    worst = 0.0
    w = state_leaves(want)
    for name, g in state_leaves(got).items():
        ref = w[name].to(g.device)
        if g.shape != ref.shape or g.dtype != ref.dtype:
            raise AssertionError(f"{what}{name}: {tuple(g.shape)} {g.dtype}"
                                 f" vs {tuple(ref.shape)} {ref.dtype}")
        if not g.is_floating_point():
            if not torch.equal(g, ref):
                bad = int((g != ref).sum())
                raise AssertionError(f"{what}{name}: {bad} integer entries "
                                     "differ")
            continue
        if g.numel():
            worst = max(worst, float((g - ref).abs().max()))
        if not torch.allclose(g, ref, rtol=rtol, atol=atol):
            raise AssertionError(
                f"{what}{name}: max abs diff "
                f"{float((g - ref).abs().max())} beyond rtol {rtol}, "
                f"atol {atol}")
    return worst


def bit_equal(a: SimState, b: SimState) -> bool:
    """Every leaf of two states identical, bit for bit."""
    lb = state_leaves(b)
    for name, x in state_leaves(a).items():
        y = lb[name]
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True
