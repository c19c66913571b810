"""Scenario registry and mixed-topology batch planning.

The port of ``gsc_tpu.topology.scenarios``: named topology generators
(``topology.synthetic``), named traffic shapes (bursty, diurnal and
flash-crowd arrival-mean profiles, realised as trace rows) and
deterministic mid-episode capacity faults, which zero node rows of the
per-interval ``node_cap`` table or link rows of the per-interval
``edge_cap_t`` table (``sim.state.EdgeCapSchedule``) that the engine
takes at every interval start.

Mix grammar (``EpisodeDriver(topo_mix=...)``, ``cli train --topo-mix``)::

    mix    := entry ("," entry)*
    entry  := "schedule" | name["+" shape]["~" faults][":" seed]
    faults := fault ("&" fault)*
    fault  := ("link" | "node") "@" interval ["." index]

``schedule`` expands to the scheduler's training networks; every other
entry names a registry generator (static names and the families
``random<N>``, ``star<N>``, ``ring<N>``, ``line<N>``).  The replicas are
filled round-robin over the expanded entries, so one batch carries the
whole mixture as per-replica topologies.  A ``factory:`` mix is the
on-device scenario factory instead (``topology.factory``).

Examples::

    schedule,abilene,random12:7
    abilene+bursty,abilene~link@3.2&node@5.0,ring8:11
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import synthetic
from .compiler import NetworkSpec, Topology, TopologyBucket


# --------------------------------------------------------------- fault plans
@dataclass(frozen=True)
class TopoFault:
    """One deterministic capacity fault: from control interval
    ``interval`` on, the capacity of ``site`` (``link``: undirected edge
    id, ``node``: node id) ``index`` is zero for the rest of the
    episode."""

    site: str       # "link" | "node"
    interval: int   # control interval the zeroing starts at
    index: int      # edge id (link) / node id (node)


def parse_topo_faults(spec: str) -> Tuple[TopoFault, ...]:
    """``site@interval[.index]`` joined by ``&`` (or ``;``)."""
    faults = []
    for cell in re.split(r"[&;]", spec):
        cell = cell.strip()
        if not cell:
            continue
        m = re.fullmatch(r"(link|node)@(\d+)(?:\.(\d+))?", cell)
        if not m:
            raise ValueError(
                f"bad fault {cell!r}: expected 'link@<interval>[.<index>]' "
                "or 'node@<interval>[.<index>]'")
        faults.append(TopoFault(site=m.group(1), interval=int(m.group(2)),
                                index=int(m.group(3) or 0)))
    if not faults:
        raise ValueError(f"empty fault plan {spec!r}")
    return tuple(faults)


def validate_faults(topo: Topology, faults: Sequence[TopoFault]):
    """Fault indices must name real elements of ``topo``: a fault on a
    padding row would never fire."""
    n_nodes = int(topo.n_nodes)
    n_edges = int(topo.n_edges)
    for f in faults:
        limit = n_nodes if f.site == "node" else n_edges
        if not 0 <= f.index < limit:
            raise ValueError(
                f"{f.site} fault index {f.index} out of range: topology "
                f"has {limit} real {f.site}s (indices into the padded "
                "tables would silently never fire)")


def apply_faults(topo: Topology, caps: np.ndarray, steps: int,
                 faults: Sequence[TopoFault], with_edge_cap: bool = False):
    """The fault application both traffic producers share: validates the
    indices, folds node faults into the per-interval ``caps`` [T, N] and
    builds the [T, E] edge table when a link fault (or ``with_edge_cap``)
    needs it.  Returns ``(caps, edge_cap_t or None)``, the table a CPU
    tensor."""
    if faults:
        validate_faults(topo, faults)
        caps = apply_node_faults(caps, faults)
    edge_cap_t = None
    if with_edge_cap or any(f.site == "link" for f in faults):
        edge_cap_t = torch.from_numpy(build_edge_cap_table(
            topo.edge_cap.cpu().numpy(), steps, faults))
    return caps, edge_cap_t


def apply_node_faults(caps: np.ndarray, faults: Sequence[TopoFault]
                      ) -> np.ndarray:
    """Zero node-capacity rows [T, N] from each fault's interval on."""
    caps = np.asarray(caps).copy()
    steps = caps.shape[0]
    for f in faults:
        if f.site != "node":
            continue
        if not 0 <= f.index < caps.shape[1]:
            raise ValueError(f"node fault index {f.index} out of range "
                             f"(max_nodes {caps.shape[1]})")
        caps[min(f.interval, steps):, f.index] = 0.0
    return caps


def build_edge_cap_table(edge_cap: np.ndarray, steps: int,
                         faults: Sequence[TopoFault]) -> np.ndarray:
    """[T, E] per-interval edge capacities: the static ones broadcast
    over time, link-fault columns zeroed from their interval on."""
    base = np.asarray(edge_cap, np.float32)
    table = np.broadcast_to(base, (steps, base.shape[0])).copy()
    for f in faults:
        if f.site != "link":
            continue
        if not 0 <= f.index < base.shape[0]:
            raise ValueError(f"link fault index {f.index} out of range "
                             f"(max_edges {base.shape[0]})")
        table[min(f.interval, steps):, f.index] = 0.0
    return table


# ------------------------------------------------------------ traffic shapes
def _bursty(steps: int) -> np.ndarray:
    """4-interval blocks: calm (2x the base arrival mean), then burst
    (0.5x), repeating."""
    k = np.arange(steps)
    return np.where((k // 4) % 2 == 0, 2.0, 0.5)


def _diurnal(steps: int) -> np.ndarray:
    """One daily cycle over the episode: the mean swings in [0.5x, 2.5x]."""
    k = np.arange(steps)
    return 1.5 - np.cos(2.0 * np.pi * k / max(steps, 1))


def _flash_crowd(steps: int) -> np.ndarray:
    """Base traffic with one mid-episode window at mean / 8 for ~1/8 of
    the episode."""
    scale = np.ones(steps)
    w0 = steps // 2
    scale[w0:w0 + max(steps // 8, 1)] = 0.125
    return scale


# name -> (profile: steps -> [steps] arrival-mean scale, the traffic
# capacity factor that covers the densest profile)
TRAFFIC_SHAPES: Dict[str, Tuple[Callable[[int], np.ndarray], float]] = {
    "bursty": (_bursty, 1.3),
    "diurnal": (_diurnal, 1.2),
    "flash_crowd": (_flash_crowd, 1.8),
}


def shape_trace(shape: str, cfg, topo: Topology, steps: int):
    """Trace rows realising a traffic shape on every ingress of ``topo``:
    one mean-override row per (interval, ingress)."""
    from ..sim.traffic import TraceEvents

    profile = TRAFFIC_SHAPES[shape][0](steps)
    base = cfg.inter_arrival_mean
    ing = np.nonzero(topo.is_ingress.cpu().numpy()
                     & topo.node_mask.cpu().numpy())[0]
    rows = [(float(k * cfg.run_duration), int(n),
             float(base * profile[k]), None)
            for k in range(steps) for n in ing]
    return TraceEvents(rows)


# ---------------------------------------------------------------- scenarios
@dataclass(frozen=True)
class Scenario:
    """One parsed mix entry: a named generator with an optional traffic
    shape and fault plan; the name determines the topology."""

    name: str                           # canonical entry string
    topo_name: str
    seed: int = 0
    traffic_shape: Optional[str] = None
    faults: Tuple[TopoFault, ...] = ()


# (pattern, builder, seeded): the deterministic families refuse a seed
_DYNAMIC = (
    (re.compile(r"random(\d+)"), lambda n, seed: synthetic.random_network(
        n, seed=seed), True),
    (re.compile(r"star(\d+)"), lambda n, seed: synthetic.star(n), False),
    (re.compile(r"ring(\d+)"), lambda n, seed: synthetic.ring(n), False),
    (re.compile(r"line(\d+)"), lambda n, seed: synthetic.line(n), False),
)

# static names whose generator ignores the seed
_SEEDLESS = frozenset({"triangle", "two_node", "claranet", "compuserve"})


class ScenarioRegistry:
    """Named topology generators (``fn(seed) -> NetworkSpec``);
    ``register`` adds more."""

    def __init__(self):
        self._gen: Dict[str, Callable[[int], NetworkSpec]] = {
            "abilene": lambda seed: synthetic.abilene(seed=seed),
            "triangle": lambda seed: synthetic.triangle(),
            "two_node": lambda seed: synthetic.two_node(),
            "bteurope": lambda seed: synthetic.bteurope(
                node_cap_range=(1, 3), seed=seed),
            "claranet": lambda seed: synthetic.claranet(),
            "compuserve": lambda seed: synthetic.compuserve(),
            "tinet": lambda seed: synthetic.tinet(seed=seed),
            "chinanet": lambda seed: synthetic.chinanet(seed=seed),
        }

    def register(self, name: str, fn: Callable[[int], NetworkSpec]):
        self._gen[name] = fn

    def names(self) -> List[str]:
        return sorted(self._gen) + ["random<N>", "star<N>", "ring<N>",
                                    "line<N>"]

    def spec(self, topo_name: str, seed: int = 0) -> NetworkSpec:
        """The generator's network; a non-zero seed on a deterministic
        generator is an error (two seeded copies would be one network
        under two names)."""
        deterministic = topo_name in _SEEDLESS
        fn = self._gen.get(topo_name)
        build = None
        if fn is None:
            for pat, b, seeded in _DYNAMIC:
                m = pat.fullmatch(topo_name)
                if m:
                    build, deterministic = b, not seeded
                    break
            else:
                raise ValueError(
                    f"unknown scenario topology {topo_name!r} (known: "
                    f"{', '.join(self.names())})")
        if seed and deterministic:
            raise ValueError(
                f"{topo_name!r} is a deterministic generator — ':{seed}' "
                "has no effect (two seeded copies would be identical "
                "networks labeled as distinct); drop the seed")
        return fn(seed) if fn is not None else build(int(m.group(1)), seed)

    def parse(self, entry: str) -> Scenario:
        """One mix entry (grammar in the module docstring)."""
        raw = entry.strip()
        if not raw:
            raise ValueError("empty mix entry")
        body, seed = raw, 0
        if ":" in body:
            head, tail = body.rsplit(":", 1)
            if not tail.isdigit():
                raise ValueError(
                    f"bad seed in mix entry {raw!r} (expected ':<int>')")
            body, seed = head, int(tail)
        faults: Tuple[TopoFault, ...] = ()
        if "~" in body:
            body, fspec = body.split("~", 1)
            faults = parse_topo_faults(fspec)
        shape = None
        if "+" in body:
            body, shape = body.split("+", 1)
            if shape not in TRAFFIC_SHAPES:
                raise ValueError(
                    f"unknown traffic shape {shape!r} (known: "
                    f"{', '.join(sorted(TRAFFIC_SHAPES))})")
        self.spec(body, seed)   # validate the generator name now
        return Scenario(name=raw, topo_name=body, seed=seed,
                        traffic_shape=shape, faults=faults)

    def parse_mix(self, mix: str) -> List[Union[str, Scenario]]:
        """The comma-separated entries; ``"schedule"`` stays a literal
        for the driver to expand."""
        entries: List[Union[str, Scenario]] = []
        for cell in mix.split(","):
            cell = cell.strip()
            if not cell:
                continue
            entries.append("schedule" if cell == "schedule"
                           else self.parse(cell))
        if not entries:
            raise ValueError(f"empty topology mix {mix!r}")
        return entries


DEFAULT_REGISTRY = ScenarioRegistry()


def validate_mix(mix: str, registry: Optional[ScenarioRegistry] = None):
    """Grammar check of both mix forms before anything is built: a
    ``factory:`` mix parses to a ``FactorySpec``, any other to the
    registry's entry list."""
    from . import factory as _factory

    if _factory.is_factory_mix(mix):
        return _factory.parse_factory(mix)
    return (registry or DEFAULT_REGISTRY).parse_mix(mix)


# ------------------------------------------------------------- mix planning
@dataclass
class MixEntry:
    """One distinct member of a mixed batch: its compiled topology
    (stamped ``topo_id`` = entry position) and the scenario that made it
    (None for a schedule network)."""

    name: str
    topo: Topology
    scenario: Optional[Scenario] = None

    @property
    def faults(self) -> Tuple[TopoFault, ...]:
        return self.scenario.faults if self.scenario else ()

    @property
    def traffic_shape(self) -> Optional[str]:
        return self.scenario.traffic_shape if self.scenario else None


def build_mix_entries(mix: str, registry: ScenarioRegistry,
                      bucket: TopologyBucket,
                      schedule_topos: Optional[Sequence[Topology]] = None,
                      schedule_names: Optional[Sequence[str]] = None,
                      dt: Optional[float] = None) -> List[MixEntry]:
    """Parse and compile a mix into bucketed entries, each stamped
    ``topo_id`` = its position; fault indices are checked against each
    entry's real elements here.  ``dt`` runs the dt-quantization check on
    the generated networks."""
    from .compiler import check_dt_quantization

    entries: List[MixEntry] = []
    for item in registry.parse_mix(mix):
        if item == "schedule":
            if not schedule_topos:
                raise ValueError(
                    "mix entry 'schedule' needs scheduler topologies "
                    "(bench has none — name registry scenarios instead)")
            for i, t in enumerate(schedule_topos):
                name = (schedule_names[i] if schedule_names
                        and i < len(schedule_names) else f"schedule{i}")
                entries.append(MixEntry(
                    name=name, topo=bucket.adopt(("schedule", i), t,
                                                 topo_id=len(entries))))
        else:
            spec = registry.spec(item.topo_name, item.seed)
            topo = bucket.compile((item.topo_name, item.seed), spec,
                                  topo_id=len(entries))
            if dt is not None:
                check_dt_quantization(topo, dt, name=item.name)
            validate_faults(topo, item.faults)
            entries.append(MixEntry(name=item.name, topo=topo,
                                    scenario=item))
    return entries


@dataclass
class MixPlan:
    """Round-robin assignment of ``B`` replicas over the mix entries and
    the stacked [B] topology (the same object every episode)."""

    entries: List[MixEntry]
    assignment: np.ndarray          # [B] replica -> entry index
    topo: Topology                  # stacked [B, ...]
    names: List[str]                # [B] per-replica entry names
    capacity: int                   # one traffic capacity (stackable)
    has_link_faults: bool
    counts: List[int] = field(default_factory=list)   # replicas per entry
    inv: np.ndarray = None          # [B] concat order -> replica order

    @property
    def num_entries(self) -> int:
        return len(self.entries)


def plan_mix(entries: Sequence[MixEntry], num_replicas: int,
             bucket: TopologyBucket, cfg, episode_steps: int) -> MixPlan:
    from ..sim.traffic import traffic_capacity

    k = len(entries)
    if num_replicas < k:
        raise ValueError(
            f"num_replicas ({num_replicas}) < mix entries ({k}): the "
            "round-robin fill would silently drop mixture members — "
            "raise --replicas or shrink the mix")
    assignment = np.arange(num_replicas) % k
    counts = [int((assignment == e).sum()) for e in range(k)]
    # one traffic capacity for every replica: the largest entry's bound,
    # scaled by its shape's densest profile, rounded up to 64
    caps = []
    for e in entries:
        n_ing = int((e.topo.is_ingress & e.topo.node_mask).sum())
        c = traffic_capacity(cfg, n_ing, episode_steps)
        f = TRAFFIC_SHAPES[e.traffic_shape][1] if e.traffic_shape else 1.0
        caps.append(int(math.ceil(c * f / 64.0)) * 64)
    # entry e's o-th replica sits at concat position offset[e] + o and is
    # replica e + o * k
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    inv = offsets[assignment] + np.arange(num_replicas) // k
    return MixPlan(
        entries=list(entries), assignment=assignment,
        topo=bucket.stack([entries[a].topo for a in assignment]),
        names=[entries[a].name for a in assignment],
        capacity=max(caps),
        has_link_faults=any(f.site == "link" for e in entries
                            for f in e.faults),
        counts=counts, inv=inv)


# ------------------------------------------------------- traffic production
def entry_trace(entry: MixEntry, cfg, episode_steps: int,
                default_trace=None):
    """The trace an entry's traffic follows: its shape's rows, or the
    driver's trace for plain and schedule entries."""
    if entry.traffic_shape:
        return shape_trace(entry.traffic_shape, cfg, entry.topo,
                           episode_steps)
    return default_trace


def mix_traffic_host(plan: MixPlan, cfg, service, episode_steps: int,
                     seed_for: Callable[[int], int], default_trace=None):
    """[B]-stacked host traffic of one episode: replica ``r`` on its
    entry, seeded ``seed_for(r)``."""
    from ..sim.state import stack_traffic
    from ..sim.traffic import generate_traffic

    schedules = []
    for r in range(len(plan.assignment)):
        e = plan.entries[int(plan.assignment[r])]
        schedules.append(generate_traffic(
            cfg, service, e.topo, episode_steps, seed_for(r),
            trace=entry_trace(e, cfg, episode_steps, default_trace),
            capacity=plan.capacity, faults=e.faults,
            with_edge_cap=plan.has_link_faults))
    return stack_traffic(schedules)


def mix_device_samplers(plan: MixPlan, cfg, service, episode_steps: int,
                        default_trace=None, device="cpu") -> List:
    """One ``DeviceTraffic`` sampler per mix entry (built once per run)."""
    from ..sim.traffic_device import DeviceTraffic

    return [DeviceTraffic(cfg, service, e.topo, episode_steps,
                          trace=entry_trace(e, cfg, episode_steps,
                                            default_trace),
                          capacity=plan.capacity, faults=e.faults,
                          with_edge_cap=plan.has_link_faults, device=device)
            for e in plan.entries]


def sample_mix_device(plan: MixPlan, samplers: Sequence,
                      generator: torch.Generator):
    """[B]-stacked traffic of one episode sampled on the samplers'
    device: each entry draws its replicas' share in entry order from
    ``generator``, then one gather puts the rows in replica order (row r
    belongs to entry ``r % K``)."""
    parts = [samplers[e].sample_batch(generator, plan.counts[e])
             for e in range(plan.num_entries)]
    inv = torch.as_tensor(plan.inv, dtype=torch.long,
                          device=parts[0].arr_time.device)
    return type(parts[0])(**{
        f: torch.cat([getattr(p, f) for p in parts])[inv]
        for f in type(parts[0])._RANKS})
