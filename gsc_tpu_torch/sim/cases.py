"""Check scenarios of the substep megakernel, built in code.

The cases of the JAX package's megakernel battery (tests/test_megakernel.py:
the six drop-taxonomy scenarios on a 3-node line, the WRR-collision
triangle, the saturated-link line of tests/assets/line3-linkcap2.graphml
under tests/assets/linkcap_config.yaml), one with fractional data rates,
Abilene with many replicas under a seeded non-uniform schedule, and the
seeded Abilene golden trajectory (tests/test_debug_and_golden.py), whose
frozen end-of-run numbers are ``GOLDEN``.  Everything is made from seeds
with numpy and torch, so ``chip_smoke.py`` and the card-only tests run the
same cases as the CPU tests.

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
from .state import SimState, TrafficSchedule
from .traffic import generate_traffic

# tests/test_debug_and_golden.py: seed 42, uniform schedule, caps 4,
# everything placed, 20 intervals
GOLDEN = {"generated": 800, "processed": 658, "dropped": 133, "active": 9,
          "drop_reasons": [0, 0, 0, 133], "avg_e2e": 34.75}
GOLDEN_AVG_E2E_TOL = 0.1


@dataclass
class SubstepCase:
    """One scenario: an engine, a topology (shared by the replicas), one
    TrafficSchedule per replica stacked [B, ...] (replica r's drawn with
    ``seeds[r]``), a schedule [B, N, C, S, N] and placement [B, N, P] held
    for ``intervals`` intervals."""

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
    per = [generate_traffic(cfg, service, topo, steps, seed=s) for s in seeds]
    traffic = TrafficSchedule(**{
        f: torch.stack([getattr(t, f) for t in per])
        for f in TrafficSchedule._RANKS})
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


def _seeded_case(name: str, service: ServiceConfig, cfg: SimConfig,
                 limits: EnvLimits, topo: Topology, batch: int,
                 intervals: int, seed: int) -> SubstepCase:
    """``batch`` replicas, each with its own traffic seed and its own
    seeded non-uniform schedule (rows over real nodes, some weights zero)
    and placement (each real node hosts each SF with probability 0.8)."""
    nm = topo.node_mask.numpy()
    rng = np.random.default_rng(seed)
    w = rng.uniform(size=(batch,) + limits.scheduling_shape)
    w = np.where(w < 0.6, 0.0, w) * nm
    w[..., 0] += 1e-3 * (w.sum(-1) == 0)     # no row without a destination
    sched = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    place = (rng.uniform(size=(batch, limits.max_nodes, limits.sf_pool))
             < 0.8) & nm[:, None]
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
            state = substep_plain(engine, state, topo.expand(b),
                                  traffic.expand(b), cap_now, z)
            state = state.replace(run_idx=state.run_idx + 1)
        else:
            state, _ = engine.apply(state, topo, traffic, sched, place, z)
        states.append(state)
    return states


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


def state_leaves(state: SimState) -> Dict[str, torch.Tensor]:
    """Every tensor of a state by dotted name (flows and metrics
    included)."""
    out = {}

    def walk(tree, prefix):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, torch.Tensor):
                out[prefix + f.name] = v
            elif v is not None:
                walk(v, prefix + f.name + ".")
    walk(state, "")
    return out


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
