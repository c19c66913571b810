"""On-device scenario factory: per-replica topology, traffic and fault
sampling in PyTorch on the tensors' device.

The port of ``gsc_tpu.topology.factory``.  Each episode draws a fresh
randomized (topology, traffic, fault plan) for every replica on the
card, all in one fixed ``[max_nodes, max_edges]`` shape bucket, with the
family of each replica drawn from the curriculum's weights
(``env.curriculum``).

Mix grammar (``EpisodeDriver(topo_mix=...)``, ``cli train --topo-mix``)::

    factory  := "factory:" families ["+shapes"] ["~faults"]
    families := "all" | family ("-" family)*
    family   := "star" | "ring" | "line" | "random"

A factory mix fills the whole replica axis and cannot be combined with
registry entries.  ``+shapes`` samples a traffic shape per replica and
episode (uniform, bursty, diurnal, flash crowd); ``~faults`` samples one
capacity fault per replica with probability ``fault_rate`` (a link or a
node, zeroed from a random interval on, in the same ``node_cap`` /
``edge_cap_t`` tables the registry's fault plans use).

What one :meth:`ScenarioFactory.sample_batch` draws per replica:

- **family** from the curriculum's ``probs`` (uniform without one),
  stamped as ``topo_id``, so replay rows and the learn ledger attribute
  per family;
- **topology**: the node count within the bucket, integer node caps,
  the family's edge list (random family: a uniform random spanning tree
  plus deduplicated chords, integer delays), then all-pairs shortest
  paths on the device: Floyd-Warshall over the compiler's edge weight
  ``1/(cap + 1/delay)`` with path-delay and next-hop accumulation, the
  matrices the simulator reads.  Where shortest paths are unique (the
  line, star and odd ring) they equal the host compiler's Dijkstra;
- **traffic**: ``sim.traffic_device.renewal_stream`` over interval tables
  of the sampled topology and shape;
- **faults**: Bernoulli(``fault_rate``); the site (link or node), start
  interval and element uniform over the topology's real elements.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .compiler import INF_DELAY, Topology

FACTORY_PREFIX = "factory:"
FAMILIES = ("star", "ring", "line", "random")

# traffic-shape profile ids (0 = the plain uniform profile)
SHAPE_NAMES = ("uniform", "bursty", "diurnal", "flash_crowd")


@dataclass(frozen=True)
class FactorySpec:
    """A parsed ``factory:`` mix and the sampler's knobs (only the
    families and the two flags come from the mix string)."""

    families: Tuple[str, ...] = FAMILIES
    traffic_shapes: bool = False
    faults: bool = False
    # topology knobs
    n_min: int = 4
    n_max: int = 0                    # 0 = the bucket's max_nodes
    num_ingress: int = 1
    node_cap_range: Tuple[int, int] = (1, 4)   # [lo, hi) integers
    link_cap: float = 100.0
    link_delay: float = 1.0           # star/ring/line fixed delay
    delay_range: Tuple[float, float] = (1.0, 10.0)  # random family
    extra_edge_frac: float = 0.25     # random family chords per node
    # fault knobs
    fault_rate: float = 0.5           # P(any fault) per replica episode

    @property
    def num_families(self) -> int:
        return len(self.families)


_FACTORY_RE = re.compile(r"factory:([a-z-]+)((?:\+shapes|~faults)*)$")


def is_factory_mix(mix) -> bool:
    """True when a mix string selects the scenario factory."""
    return bool(mix) and mix.strip().startswith(FACTORY_PREFIX)


def parse_factory(mix: str) -> FactorySpec:
    """Parse a ``factory:`` mix (grammar in the module docstring); it must
    be the whole mix string."""
    raw = (mix or "").strip()
    if not is_factory_mix(raw):
        raise ValueError(f"not a factory mix: {mix!r} (expected "
                         f"'{FACTORY_PREFIX}<families>[+shapes][~faults]')")
    if "," in raw:
        raise ValueError(
            "a factory mix fills the whole replica axis and cannot be "
            f"combined with registry entries: {mix!r} (drop the comma "
            "entries or use a pure registry mix)")
    m = _FACTORY_RE.fullmatch(raw)
    if not m:
        raise ValueError(
            f"bad factory mix {mix!r}: expected "
            f"'{FACTORY_PREFIX}<fam>[-<fam>...][+shapes][~faults]' with "
            f"families from {', '.join(FAMILIES)} (or 'all')")
    fams_raw, flags = m.group(1), m.group(2)
    if fams_raw == "all":
        families = FAMILIES
    else:
        families = tuple(fams_raw.split("-"))
        unknown = [f for f in families if f not in FAMILIES]
        if unknown:
            raise ValueError(
                f"unknown factory families {unknown} in {mix!r} "
                f"(known: {', '.join(FAMILIES)}, or 'all')")
        if len(set(families)) != len(families):
            raise ValueError(
                f"duplicate factory families in {mix!r}: two copies of "
                "one family would be identical distributions labeled as "
                "distinct curriculum arms")
    return FactorySpec(families=families,
                       traffic_shapes="+shapes" in flags,
                       faults="~faults" in flags)


def _shape_profiles(steps: int) -> np.ndarray:
    """[S, steps] arrival-mean scale profiles in :data:`SHAPE_NAMES`
    order; rows 1..3 are the registry's own profiles."""
    from .scenarios import TRAFFIC_SHAPES

    rows = [np.ones(steps)]
    for name in SHAPE_NAMES[1:]:
        rows.append(TRAFFIC_SHAPES[name][0](steps))
    return np.stack(rows).astype(np.float32)


def _max_shape_factor(spec: FactorySpec) -> float:
    from .scenarios import TRAFFIC_SHAPES

    if not spec.traffic_shapes:
        return 1.0
    return max(f for _, f in TRAFFIC_SHAPES.values())


class ScenarioFactory:
    """Per-(replica, episode) scenario sampler over one shape bucket on
    ``device``; ``sample_batch(generator, probs, B)`` returns a
    [B]-stacked (Topology, TrafficSchedule)."""

    def __init__(self, spec: FactorySpec, sim_cfg, service,
                 episode_steps: int, max_nodes: int = 24,
                 max_edges: int = 37, device="cpu"):
        from ..sim.traffic import traffic_capacity

        if sim_cfg.use_states:
            raise ValueError(
                "the scenario factory samples arrival means from the "
                "base inter_arrival_mean (+ shape profiles); MMPP state "
                "chains (SimConfig.use_states) are host-table-driven — "
                "use a registry --topo-mix for MMPP scenarios")
        if not spec.families:
            raise ValueError("factory spec has no families")

        # the densest draw of each family must fit the bucket: ring needs
        # n edges, random (n - 1) tree edges plus its chords
        def edges_needed(n):
            need = n if "ring" in spec.families else n - 1
            if "random" in spec.families:
                need = max(need, n - 1
                           + int(math.ceil(spec.extra_edge_frac * n)))
            return need

        n_max = spec.n_max
        if not n_max:
            n_max = max_nodes
            while n_max > spec.n_min and edges_needed(n_max) > max_edges:
                n_max -= 1
        if not 3 <= spec.n_min <= n_max <= max_nodes:
            raise ValueError(
                f"factory node range [{spec.n_min}, {n_max}] must satisfy "
                f"3 <= n_min <= n_max <= bucket max_nodes ({max_nodes})")
        if edges_needed(n_max) > max_edges:
            raise ValueError(
                f"factory families need up to {edges_needed(n_max)} edges "
                f"at n_max={n_max}, bucket has max_edges={max_edges} — "
                "shrink n_max or widen the bucket")
        self.spec = spec
        self.cfg = sim_cfg
        self.device = torch.device(device)
        self.episode_steps = int(episode_steps)
        self.max_nodes = int(max_nodes)
        self.max_edges = int(max_edges)
        self.n_max = int(n_max)
        self.n_sfcs = max(len(service.sfc_names), 1)
        self.horizon = float(episode_steps * sim_cfg.run_duration)
        cap = traffic_capacity(sim_cfg, spec.num_ingress, episode_steps)
        self.capacity = int(math.ceil(
            cap * _max_shape_factor(spec) / 64.0)) * 64
        self.ttl_choices = torch.as_tensor(sim_cfg.ttl_choices,
                                           dtype=torch.float32,
                                           device=self.device)
        profiles = _shape_profiles(episode_steps)
        self.num_shapes = len(SHAPE_NAMES) if spec.traffic_shapes else 1
        self.profiles = torch.as_tensor(profiles, device=self.device)
        self.min_mean = float(sim_cfg.inter_arrival_mean
                              * profiles[:self.num_shapes].min())

    @property
    def family_names(self):
        """topo_id -> family name (the curriculum's arms)."""
        return list(self.spec.families)

    # ------------------------------------------------------- topology half
    def _uniform(self, g, shape):
        return torch.rand(shape, generator=g, device=self.device)

    def _randint(self, g, low, high, shape):
        """Uniform integers in [low, high) with per-element tensor bounds."""
        low = torch.as_tensor(low, device=self.device)
        high = torch.as_tensor(high, device=self.device)
        span = (high - low).to(torch.float32)
        draw = (self._uniform(g, shape) * span).floor().long()
        return low + torch.minimum(draw, (span - 1).clamp(min=0).long())

    def _random_edges(self, g, n):
        """Random-family edges [B, E]: a uniform random spanning tree
        (node i + 1's parent uniform over [0, i]) and up to
        ``extra_edge_frac * n`` deduplicated chords behind it, so that
        ``edge_mask == arange < n_edges``."""
        b = n.shape[0]
        N, E = self.max_nodes, self.max_edges
        dev = self.device
        i = torch.arange(E, device=dev)
        parent = torch.minimum(
            (self._uniform(g, (b, E)) * (i + 1)).floor().long(), i)
        tree = i[None, :] < (n - 1)[:, None]
        tu = torch.where(tree, parent, N)
        tv = torch.where(tree, i + 1, N)
        # adjacency over an [N+1] grid: masked slots land in a discard row
        adj = torch.zeros((b, N + 1, N + 1), dtype=torch.bool, device=dev)
        bi = torch.arange(b, device=dev)[:, None]
        adj[bi, tu, tv] = True
        adj[bi, tv, tu] = True
        adj |= torch.eye(N + 1, dtype=torch.bool, device=dev)
        wanted = torch.minimum(
            torch.round(self.spec.extra_edge_frac * n.float()).long(),
            E - (n - 1))
        # column E of the edge lists is the discard slot
        pad = torch.zeros((b, 1), dtype=torch.long, device=dev)
        eu = torch.cat([torch.where(tree, parent, 0), pad], 1)
        ev = torch.cat([torch.where(tree, i + 1, 0), pad], 1)
        cnt = torch.zeros(b, dtype=torch.long, device=dev)
        ar = torch.arange(b, device=dev)
        for _ in range(E):
            a = self._randint(g, 0, n, (b,))
            c = self._randint(g, 0, n, (b,))
            ok = ~adj[ar, a, c] & (cnt < wanted)
            adj[ar, a, c] |= ok
            adj[ar, c, a] |= ok
            slot = torch.where(ok, n - 1 + cnt, E)
            eu[ar, slot] = torch.where(ok, a, eu[ar, slot])
            ev[ar, slot] = torch.where(ok, c, ev[ar, slot])
            cnt = cnt + ok.long()
        lo, hi = self.spec.delay_range
        delay = torch.round(lo + (hi - lo) * self._uniform(g, (b, E)))
        return eu[:, :E], ev[:, :E], n - 1 + cnt, delay

    def _family_edges(self, g, fam, n):
        """(edge_u, edge_v, n_edges, edge_delay, edge_mask) [B, E] of each
        replica's family: every family's edges are built and ``fam``
        selects."""
        b = n.shape[0]
        E = self.max_edges
        dev = self.device
        i = torch.arange(E, device=dev).expand(b, E)
        fixed = torch.full((b, E), float(self.spec.link_delay), device=dev)
        built = []
        for name in self.spec.families:
            if name == "line":
                built.append((i, i + 1, n - 1, fixed))
            elif name == "ring":
                built.append((i, (i + 1) % n.clamp(min=1)[:, None], n,
                              fixed))
            elif name == "star":
                built.append((torch.zeros_like(i), i + 1, n - 1, fixed))
            elif name == "random":
                built.append(self._random_edges(g, n))
            else:   # pragma: no cover - parse_factory validates
                raise ValueError(f"unknown factory family {name!r}")
        pick = lambda k: torch.stack([x[k] for x in built])[
            fam, torch.arange(b, device=dev)]
        eu, ev, ne, ed = pick(0), pick(1), pick(2), pick(3)
        mask = i < ne[:, None]
        zero = torch.zeros((), device=dev)
        return (torch.where(mask, eu, 0), torch.where(mask, ev, 0), ne,
                torch.where(mask, ed, zero), mask)

    def _shortest_paths(self, eu, ev, edge_delay, edge_mask, node_mask):
        """Floyd-Warshall over ``1/(cap + 1/delay)`` (f32, strict
        improvement keeps the first path) with path-delay and next-hop
        accumulation; returns (next_hop, path_delay, diameter)."""
        b = eu.shape[0]
        N = self.max_nodes
        dev = self.device
        bi = torch.arange(b, device=dev)[:, None]
        w = 1.0 / (self.spec.link_cap + 1.0 / edge_delay.clamp(min=1e-9))
        uu = torch.where(edge_mask, eu, N)
        vv = torch.where(edge_mask, ev, N)
        inf = float("inf")
        wadj = torch.full((b, N + 1, N + 1), inf, device=dev)
        dadj = torch.full((b, N + 1, N + 1), inf, device=dev)
        for x, y in ((uu, vv), (vv, uu)):
            wadj[bi, x, y] = torch.minimum(wadj[bi, x, y], w)
            dadj[bi, x, y] = torch.minimum(dadj[bi, x, y], edge_delay)
        wadj, dadj = wadj[:, :N, :N], dadj[:, :N, :N]
        eye = torch.eye(N, dtype=torch.bool, device=dev)
        ii = torch.arange(N, device=dev)
        dist = torch.where(eye, 0.0, wadj)
        delay = torch.where(eye, 0.0, dadj)
        nxt = torch.where(torch.isfinite(wadj), ii[None, None, :], -1)
        nxt = torch.where(eye, ii[:, None], nxt)
        for k in range(N):
            alt = dist[:, :, k, None] + dist[:, None, k, :]
            better = alt < dist
            dist = torch.where(better, alt, dist)
            delay = torch.where(
                better, delay[:, :, k, None] + delay[:, None, k, :], delay)
            nxt = torch.where(better, nxt[:, :, k, None], nxt)
        real = node_mask[:, :, None] & node_mask[:, None, :]
        reach = real & torch.isfinite(dist)
        path_delay = torch.where(reach, delay, INF_DELAY)
        next_hop = torch.where(reach, nxt, -1).to(torch.int32)
        diameter = torch.where(reach, path_delay, 0.0).amax((1, 2))
        return next_hop, path_delay, diameter

    def _sample_topology(self, g, fam, n) -> Topology:
        b = n.shape[0]
        N, E = self.max_nodes, self.max_edges
        dev = self.device
        eu, ev, n_edges, edge_delay, edge_mask = self._family_edges(g, fam,
                                                                    n)
        node_mask = torch.arange(N, device=dev)[None, :] < n[:, None]
        lo, hi = self.spec.node_cap_range
        node_cap = self._randint(g, lo, hi, (b, N)).float() * node_mask
        n_ing = (n - 1).clamp(max=self.spec.num_ingress).clamp(min=1)
        is_ingress = torch.arange(N, device=dev)[None, :] < n_ing[:, None]
        edge_cap = torch.where(edge_mask, float(self.spec.link_cap), 0.0)
        bi = torch.arange(b, device=dev)[:, None]
        uu = torch.where(edge_mask, eu, N)
        vv = torch.where(edge_mask, ev, N)
        ids = torch.arange(E, dtype=torch.int32, device=dev).expand(b, E)
        aei = torch.full((b, N + 1, N + 1), -1, dtype=torch.int32,
                         device=dev)
        aei[bi, uu, vv] = ids
        aei[bi, vv, uu] = ids
        next_hop, path_delay, diameter = self._shortest_paths(
            eu, ev, edge_delay, edge_mask, node_mask)
        i32 = torch.int32
        return Topology(
            node_cap=node_cap, node_mask=node_mask, is_ingress=is_ingress,
            is_egress=torch.zeros((b, N), dtype=torch.bool, device=dev),
            edge_u=eu.to(i32), edge_v=ev.to(i32), edge_cap=edge_cap,
            edge_delay=edge_delay, edge_mask=edge_mask,
            adj_edge_id=aei[:, :N, :N].contiguous(), next_hop=next_hop,
            path_delay=path_delay, n_nodes=n.to(i32),
            n_edges=n_edges.to(i32), diameter=diameter,
            # the family index: the curriculum's and the learn ledger's
            # segment axis
            topo_id=fam.to(i32))

    # -------------------------------------------------------- traffic half
    def _sample_traffic(self, g, topo: Topology):
        from ..sim.state import TrafficSchedule, attach_edge_cap
        from ..sim.traffic_device import renewal_stream

        steps, N, E = self.episode_steps, self.max_nodes, self.max_edges
        b = topo.node_cap.shape[0]
        dev = self.device
        ing = topo.is_ingress & topo.node_mask                  # [B, N]
        shape = (self._randint(g, 0, self.num_shapes, (b,))
                 if self.num_shapes > 1
                 else torch.zeros(b, dtype=torch.long, device=dev))
        profile = self.profiles[shape]                          # [B, T]
        means = torch.where(
            ing[:, None, :],
            (self.cfg.inter_arrival_mean * profile.double())[:, :, None],
            float("inf"))
        active = ing[:, None, :].expand(b, steps, N)
        next_active = torch.where(
            ing[:, None, :], torch.arange(steps, device=dev)[None, :, None],
            steps)
        caps = topo.node_cap[:, None, :].expand(b, steps, N)
        edge_cap_t = None
        if self.spec.faults:
            occurs = self._uniform(g, (b,)) < self.spec.fault_rate
            is_link = self._uniform(g, (b,)) < 0.5
            k0 = self._randint(g, 1, max(steps, 2), (b,))
            nidx = self._randint(g, 0, topo.n_nodes.long(), (b,))
            eidx = self._randint(g, 0, topo.n_edges.long().clamp(min=1),
                                 (b,))
            from_k0 = (torch.arange(steps, device=dev)[None, :]
                       >= k0[:, None])[:, :, None]             # [B, T, 1]
            hit_n = (torch.arange(N, device=dev)[None, :]
                     == nidx[:, None])[:, None, :]
            hit_e = (torch.arange(E, device=dev)[None, :]
                     == eidx[:, None])[:, None, :]
            node_f = (occurs & ~is_link)[:, None, None]
            link_f = (occurs & is_link)[:, None, None]
            caps = torch.where(node_f & from_k0 & hit_n, 0.0, caps)
            edge_cap_t = torch.where(
                link_f & from_k0 & hit_e, 0.0,
                topo.edge_cap[:, None, :].expand(b, steps, E))
        times, ingress, drs, durs, ttls, sfcs, egs = renewal_stream(
            self.cfg, means, active, next_active, self.horizon,
            self.capacity, self.n_sfcs, self.ttl_choices,
            torch.zeros(1, dtype=torch.long, device=dev), 0, g,
            self.min_mean)
        return attach_edge_cap(TrafficSchedule(
            arr_time=times, arr_ingress=ingress, arr_dr=drs,
            arr_duration=durs, arr_ttl=ttls, arr_sfc=sfcs, arr_egress=egs,
            ingress_active=active, node_cap=caps.contiguous()), edge_cap_t)

    # ------------------------------------------------------------ sampling
    def sample_batch(self, generator: torch.Generator, probs,
                     num_replicas: int):
        """[B]-stacked (Topology, TrafficSchedule) of one episode, drawn
        from ``generator`` on this factory's device; ``probs`` [K] the
        family weights."""
        probs = torch.as_tensor(probs, dtype=torch.float32,
                                device=self.device)
        if tuple(probs.shape) != (self.spec.num_families,):
            raise ValueError(
                f"probs must be [{self.spec.num_families}] (one weight "
                f"per family {self.spec.families}), got "
                f"{tuple(probs.shape)}")
        b = num_replicas
        fam = torch.multinomial(probs, b, replacement=True,
                                generator=generator)
        n = self._randint(generator, self.spec.n_min, self.n_max + 1, (b,))
        topo = self._sample_topology(generator, fam, n)
        return topo, self._sample_traffic(generator, topo)
