"""Topology compiler: network descriptions -> padded dense tensors.

The port of ``gsc_tpu.topology.compiler``.  All graph work (shortest
paths, geo delays) happens once on the host; the simulator then does only
dense lookups (next-hop matrix, path-delay matrix).

- geo link delay from node lat/long: distance/c * 1000 * 0.77, rounded to
  integer ms (haversine great-circle distance);
- edge weight for path selection = 1/(cap + 1/delay), delay==0 -> 0,
  cap==0 -> inf (such edges are never selected);
- all-pairs shortest paths by Dijkstra from every source over those
  weights, path delay = sum of per-edge delays along the chosen path;
- GraphML files (``read_graphml``) parsed with the standard library's
  ``xml.etree.ElementTree``, in the node and edge order networkx (which
  the JAX package reads them with) gives, with the attribute types of the
  ``<key attr.type>`` declarations, and the capacity overrides
  ``force_link_cap`` / ``force_node_cap`` (node caps drawn in node order
  from ``np.random.default_rng(seed)``, as the JAX package draws them).

Ties between equal-weight paths are broken exactly as networkx's Johnson
(which the JAX package calls) breaks them, so ``next_hop`` is byte-equal:
with non-negative weights Johnson's reweighting is the identity, and its
Dijkstra pops the heap in (distance, push order), relaxes neighbours in
edge-insertion order and keeps the first path found at equal distance.
"""
from __future__ import annotations

import heapq
import math
import os
import warnings
import xml.etree.ElementTree as ET
from collections import OrderedDict
from dataclasses import dataclass, field
from itertools import count
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.tree import TensorTree

SPEED_OF_LIGHT = 299792458  # m/s
PROPAGATION_FACTOR = 0.77
DEFAULT_LINK_DELAY = 3.0
INF_DELAY = 1e9


@dataclass
class Topology(TensorTree):
    """Padded dense topology.  Fields may carry a leading batch dim."""

    node_cap: torch.Tensor      # [N] f32, 0 for padding
    node_mask: torch.Tensor     # [N] bool
    is_ingress: torch.Tensor    # [N] bool
    is_egress: torch.Tensor     # [N] bool
    edge_u: torch.Tensor        # [E] i32 undirected endpoints (0 for padding)
    edge_v: torch.Tensor        # [E] i32
    edge_cap: torch.Tensor      # [E] f32
    edge_delay: torch.Tensor    # [E] f32
    edge_mask: torch.Tensor     # [E] bool
    adj_edge_id: torch.Tensor   # [N,N] i32 undirected edge id or -1
    next_hop: torch.Tensor      # [N,N] i32 first hop from i toward j (-1 unreachable)
    path_delay: torch.Tensor    # [N,N] f32 shortest-path delay (INF_DELAY unreachable)
    n_nodes: torch.Tensor       # [] i32
    n_edges: torch.Tensor       # [] i32
    diameter: torch.Tensor      # [] f32 max finite path delay
    topo_id: torch.Tensor       # [] i32

    _RANKS = {"node_cap": 1, "node_mask": 1, "is_ingress": 1,
              "is_egress": 1, "edge_u": 1, "edge_v": 1, "edge_cap": 1,
              "edge_delay": 1, "edge_mask": 1, "adj_edge_id": 2,
              "next_hop": 2, "path_delay": 2, "n_nodes": 0, "n_edges": 0,
              "diameter": 0, "topo_id": 0}

    @property
    def max_nodes(self) -> int:
        return self.node_cap.shape[-1]

    @property
    def max_edges(self) -> int:
        return self.edge_cap.shape[-1]

    def directed_edge_index(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both-direction edge index [..., 2, 2E] and mask [..., 2E]."""
        src = torch.cat([self.edge_u, self.edge_v], dim=-1)
        dst = torch.cat([self.edge_v, self.edge_u], dim=-1)
        mask = torch.cat([self.edge_mask, self.edge_mask], dim=-1)
        return torch.stack([src, dst], dim=-2), mask


@dataclass
class NetworkSpec:
    """Host-side network description (before padding)."""

    node_caps: List[float]
    node_types: List[str]                      # "Normal" | "Ingress" | "Egress"
    edges: List[Tuple[int, int, float, float]]  # (u, v, cap, delay)
    node_names: List[str] = field(default_factory=list)
    coords: Optional[List[Tuple[float, float]]] = None  # (lat, long)


def haversine_m(lat1: float, lon1: float, lat2: float, lon2: float) -> float:
    """Great-circle distance in meters."""
    r = 6371008.8
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = p2 - p1
    dl = math.radians(lon2 - lon1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * r * math.asin(math.sqrt(a))


def geo_delay_ms(lat1, lon1, lat2, lon2) -> float:
    """Link delay from geo coordinates, integer ms."""
    distance = haversine_m(lat1, lon1, lat2, lon2)
    return float(int(np.around((distance / SPEED_OF_LIGHT * 1000) * PROPAGATION_FACTOR)))


def edge_weight(cap: float, delay: float) -> float:
    """Path-selection weight."""
    if cap == 0:
        return math.inf
    if delay == 0:
        return 0.0
    return 1.0 / (cap + 1.0 / delay)


_GRAPHML_NS = "{http://graphml.graphdrawing.org/xmlns}"
_GRAPHML_TYPES = {"integer": int, "int": int, "long": int, "float": float,
                  "double": float, "boolean": bool, "string": str,
                  "yfiles": str}
_GRAPHML_BOOL = {"true": True, "false": False, "0": False, "1": True}


def _graphml_value(text: Optional[str], kind) -> object:
    if text is None:
        return ""
    if kind is bool:
        return _GRAPHML_BOOL[text.lower()]
    return kind(text)


def _graphml_data(elem, keys) -> dict:
    """An element's ``<data>`` children, typed by their key declarations
    (elements with children, yFiles extensions, are skipped)."""
    data = {}
    for d in elem.findall(f"{_GRAPHML_NS}data"):
        key = d.get("key")
        if key not in keys:
            raise ValueError(f"Bad GraphML data: no key {key}")
        if len(d):
            continue
        name, kind = keys[key]
        data[name] = _graphml_value(d.text, kind)
    return data


def _graphml_graph(path: str):
    """(nodes, edges) of a GraphML file as networkx's ``read_graphml(path,
    node_type=int)`` yields them: nodes {id: attrs} in document order;
    edges [(u, v, attrs)] in the order ``edges(data=True)`` gives (each
    node in turn, its neighbours in the order their first edge appears,
    an undirected edge once, from the endpoint that comes first; parallel
    edges one by one, as the multigraph networkx then returns)."""
    root = ET.parse(path).getroot()
    keys = {}
    for k in root.findall(f"{_GRAPHML_NS}key"):
        name, kind = k.get("attr.name"), k.get("attr.type") or "string"
        if k.get("yfiles.type") is not None:
            name, kind = k.get("yfiles.type"), "yfiles"
        if name is None:
            raise ValueError(f"Unknown key for id {k.get('id')}.")
        keys[k.get("id")] = (name, _GRAPHML_TYPES[kind])
    graph = root.find(f"{_GRAPHML_NS}graph")
    if graph is None:
        raise ValueError(f"{path} holds no GraphML graph")
    if graph.find(f"{_GRAPHML_NS}hyperedge") is not None:
        raise ValueError("GraphML hyperedges are not supported")
    directed = graph.get("edgedefault") == "directed"
    nodes: Dict[int, dict] = {}
    for n in graph.findall(f"{_GRAPHML_NS}node"):
        nodes.setdefault(int(n.get("id")), {}).update(_graphml_data(n, keys))
    # adjacency u -> {v: {edge key: attrs}}, one dict per node pair
    adj: Dict[int, Dict[int, dict]] = {}
    parallel = False
    for e in graph.findall(f"{_GRAPHML_NS}edge"):
        u, v = int(e.get("source")), int(e.get("target"))
        data = _graphml_data(e, keys)
        key = e.get("id") or data.get("key")
        if key is not None:
            try:
                key = int(key)
            except ValueError:
                pass
        for x in (u, v):
            nodes.setdefault(x, {})
            adj.setdefault(x, {})
        keyed = adj[u].get(v)
        if keyed is None:
            keyed = adj[u][v] = {}
            if not directed:
                adj[v][u] = keyed
        else:
            parallel = True
        keyed.setdefault(object() if key is None else key, {}).update(data)
    edges, done = [], set()
    for u in nodes:
        for v, keyed in adj.get(u, {}).items():
            if v in done:
                continue
            if parallel:
                edges.extend((u, v, dict(a)) for a in keyed.values())
            else:
                edges.append((u, v, dict(next(iter(keyed.values())))))
        if not directed:
            done.add(u)
    return nodes, edges


def read_graphml(path: str, node_cap: Optional[float] = None,
                 link_cap: float = 1000.0,
                 force_link_cap: Optional[float] = None,
                 force_node_cap: Optional[Tuple[float, float]] = None,
                 rng: Optional[np.random.Generator] = None) -> NetworkSpec:
    """Parse a GraphML network file.

    Node attrs: NodeCap, NodeType (Ingress/Egress/Normal), label, Latitude,
    Longitude.  Edge attrs: LinkFwdCap, LinkDelay (else geo-derived, or
    ``DEFAULT_LINK_DELAY`` without coordinates).  ``force_node_cap=(lo,
    hi)`` draws integer caps uniformly per node from ``rng``;
    ``force_link_cap`` overrides all link caps."""
    if not path.endswith(".graphml"):
        raise ValueError(f"{path} is not a GraphML file")
    if rng is None:
        rng = np.random.default_rng(0)
    nodes, graph_edges = _graphml_graph(path)
    order = {n: i for i, n in enumerate(nodes)}

    caps, types, names, coords = [], [], [], []
    for n, d in nodes.items():
        cap = d.get("NodeCap", node_cap)
        if force_node_cap is not None:
            cap = float(rng.integers(int(force_node_cap[0]),
                                     int(force_node_cap[1])))
        if cap is None:
            raise ValueError(f"No NodeCap set for node {n} in {path}")
        caps.append(float(cap))
        types.append(d.get("NodeType", "Normal"))
        names.append(d.get("label", f"pop{n}"))
        lat, lon = d.get("Latitude"), d.get("Longitude")
        coords.append((float(lat), float(lon))
                      if lat is not None and lon is not None else None)

    edges = []
    for u, v, d in graph_edges:
        cap = d.get("LinkFwdCap", link_cap)
        if force_link_cap is not None:
            cap = force_link_cap
        delay = d.get("LinkDelay")
        if delay is None:
            cu, cv = coords[order[u]], coords[order[v]]
            delay = (geo_delay_ms(*cu, *cv)
                     if cu is not None and cv is not None
                     else DEFAULT_LINK_DELAY)
        edges.append((order[u], order[v], float(cap), float(delay)))

    return NetworkSpec(node_caps=caps, node_types=types, edges=edges,
                       node_names=names,
                       coords=[c if c else (0.0, 0.0) for c in coords])


def _dijkstra_paths(adj: Dict[int, Dict[int, float]], source: int
                    ) -> Dict[int, List[int]]:
    """Shortest paths from ``source``; ties keep the first path found."""
    dist: Dict[int, float] = {}
    seen = {source: 0}
    pred: Dict[int, int] = {}
    c = count()
    fringe = [(0, next(c), source)]
    while fringe:
        d, _, v = heapq.heappop(fringe)
        if v in dist:
            continue
        dist[v] = d
        for u, w in adj[v].items():
            vu = d + w
            if u in dist:
                continue
            if u not in seen or vu < seen[u]:
                seen[u] = vu
                heapq.heappush(fringe, (vu, next(c), u))
                pred[u] = v
    paths = {source: [source]}
    for v in list(dist)[1:]:   # dist is in pop order: predecessors come first
        paths[v] = paths[pred[v]] + [v]
    return paths


def _all_pairs(spec: NetworkSpec) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs shortest paths -> (next_hop, path_delay)."""
    n = len(spec.node_caps)
    adj: Dict[int, Dict[int, float]] = {i: {} for i in range(n)}
    delay_of = {}
    for u, v, cap, delay in spec.edges:
        w = edge_weight(cap, delay)
        if math.isinf(w):
            continue  # cap-0 edges can never be selected
        adj[u][v] = w
        adj[v][u] = w
        delay_of[(u, v)] = delay
        delay_of[(v, u)] = delay

    next_hop = np.full((n, n), -1, dtype=np.int32)
    path_delay = np.full((n, n), INF_DELAY, dtype=np.float32)
    for s in range(n):
        for t, path in _dijkstra_paths(adj, s).items():
            d = sum(delay_of[(path[i], path[i + 1])] for i in range(len(path) - 1))
            path_delay[s, t] = d
            next_hop[s, t] = path[1] if len(path) > 1 else s
    return next_hop, path_delay


def compile_topology(spec: NetworkSpec, max_nodes: int = 24,
                     max_edges: int = 37, topo_id: int = 0) -> Topology:
    """Pad and tensorize a NetworkSpec (CPU tensors; ``.to(device)``)."""
    n = len(spec.node_caps)
    e = len(spec.edges)
    if n > max_nodes:
        raise ValueError(f"{n} nodes > max_nodes={max_nodes}")
    if e > max_edges:
        raise ValueError(f"{e} edges > max_edges={max_edges}")

    node_cap = np.zeros(max_nodes, np.float32)
    node_cap[:n] = spec.node_caps
    node_mask = np.zeros(max_nodes, bool)
    node_mask[:n] = True
    is_ingress = np.zeros(max_nodes, bool)
    is_egress = np.zeros(max_nodes, bool)
    for i, t in enumerate(spec.node_types):
        is_ingress[i] = t == "Ingress"
        is_egress[i] = t == "Egress"

    edge_u = np.zeros(max_edges, np.int32)
    edge_v = np.zeros(max_edges, np.int32)
    edge_cap = np.zeros(max_edges, np.float32)
    edge_delay = np.zeros(max_edges, np.float32)
    edge_mask = np.zeros(max_edges, bool)
    adj_edge_id = np.full((max_nodes, max_nodes), -1, np.int32)
    for i, (u, v, cap, delay) in enumerate(spec.edges):
        edge_u[i], edge_v[i] = u, v
        edge_cap[i], edge_delay[i] = cap, delay
        edge_mask[i] = True
        adj_edge_id[u, v] = i
        adj_edge_id[v, u] = i  # undirected: capacity shared both ways

    nh, pd = _all_pairs(spec)
    next_hop = np.full((max_nodes, max_nodes), -1, np.int32)
    path_delay = np.full((max_nodes, max_nodes), INF_DELAY, np.float32)
    next_hop[:n, :n] = nh
    path_delay[:n, :n] = pd
    finite = pd[pd < INF_DELAY]
    diameter = float(finite.max()) if finite.size else 0.0

    t = torch.from_numpy
    return Topology(
        node_cap=t(node_cap), node_mask=t(node_mask),
        is_ingress=t(is_ingress), is_egress=t(is_egress),
        edge_u=t(edge_u), edge_v=t(edge_v), edge_cap=t(edge_cap),
        edge_delay=t(edge_delay), edge_mask=t(edge_mask),
        adj_edge_id=t(adj_edge_id), next_hop=t(next_hop),
        path_delay=t(path_delay),
        n_nodes=torch.tensor(n, dtype=torch.int32),
        n_edges=torch.tensor(e, dtype=torch.int32),
        diameter=torch.tensor(diameter, dtype=torch.float32),
        topo_id=torch.tensor(topo_id, dtype=torch.int32),
    )


def stack_topologies(topos) -> Topology:
    """Stack topologies along a new leading batch dim."""
    import dataclasses

    return Topology(**{f.name: torch.stack([getattr(t, f.name) for t in topos])
                       for f in dataclasses.fields(Topology)})


class TopologyBucket:
    """One (max_nodes, max_edges) padding for several networks, whose
    compiled topologies stack along a leading replica dim.  Both steps
    are memoized: ``compile(key, spec, topo_id)`` per (key, topo_id), and
    ``stack(topos)`` per tuple of member objects, so a mixed batch's
    stacked topology is the same object every episode."""

    def __init__(self, max_nodes: int = 24, max_edges: int = 37):
        self.max_nodes = max_nodes
        self.max_edges = max_edges
        self._compiled = {}   # (key, topo_id) -> Topology
        self._stacked = {}    # tuple(id(t)) -> (members, stacked)

    def compile(self, key, spec: NetworkSpec, topo_id: int = 0) -> Topology:
        """``spec`` compiled into this bucket's padding; raises ValueError
        naming the bucket when it does not fit."""
        memo_key = (key, topo_id)
        hit = self._compiled.get(memo_key)
        if hit is not None:
            return hit
        try:
            topo = compile_topology(spec, max_nodes=self.max_nodes,
                                    max_edges=self.max_edges,
                                    topo_id=topo_id)
        except ValueError as e:
            raise ValueError(
                f"topology {key!r} does not fit bucket "
                f"[{self.max_nodes} nodes, {self.max_edges} edges]: {e}")
        self._compiled[memo_key] = topo
        return topo

    def adopt(self, key, topo: Topology, topo_id: int = 0) -> Topology:
        """An already compiled topology of this bucket's padding,
        stamped ``topo_id``."""
        if (topo.max_nodes, topo.max_edges) != (self.max_nodes,
                                                self.max_edges):
            raise ValueError(
                f"topology {key!r} is padded to [{topo.max_nodes}, "
                f"{topo.max_edges}], bucket is [{self.max_nodes}, "
                f"{self.max_edges}]")
        memo_key = (key, topo_id)
        hit = self._compiled.get(memo_key)
        if hit is not None:
            return hit
        stamped = topo.replace(topo_id=torch.tensor(topo_id,
                                                    dtype=torch.int32))
        self._compiled[memo_key] = stamped
        return stamped

    def stack(self, topos) -> Topology:
        """Memoized :func:`stack_topologies` over bucket members."""
        key = tuple(id(t) for t in topos)
        hit = self._stacked.get(key)
        if hit is not None:
            return hit[1]
        stacked = stack_topologies(list(topos))
        self._stacked[key] = (tuple(topos), stacked)
        return stacked


def check_dt_quantization(topo: Topology, dt: float, name: str = "") -> bool:
    """Warn when edge delays are not integer multiples of ``dt``: the
    fixed-step engine quantizes hop timers to the substep grid, which then
    differs from the reference's event-driven timeline.  Returns True when
    a warning fired."""
    delays = topo.edge_delay.double().numpy()[topo.edge_mask.numpy()]

    def fractional(f):
        # relative: f32-sourced delays carry ~1e-7 relative error
        return np.abs(f - np.round(f)) > 1e-6 * np.maximum(np.abs(f), 1.0)

    bad = fractional(delays / dt)
    if bad.any():
        suggest = dt
        for cand in (0.5, 0.25, 0.125, 0.1, 0.05, 0.025):
            if not fractional(delays / cand).any():
                suggest = cand
                break
        label = f" {name!r}" if name else ""
        warnings.warn(
            f"topology{label} has {int(bad.sum())} edge delay(s) that are "
            f"not integer multiples of dt={dt} (e.g. {delays[bad][0]:.3f} ms)"
            f"; the fixed-step engine quantizes hop timers to dt, which "
            f"diverges from the reference's event-driven contention physics"
            + (f" — consider dt={suggest}" if suggest != dt else ""),
            stacklevel=2)
        return True
    return False


def load_topology(path: str, max_nodes: int = 24, max_edges: int = 37,
                  force_link_cap: Optional[float] = None,
                  force_node_cap: Optional[Tuple[float, float]] = None,
                  seed: int = 0) -> Topology:
    """GraphML file -> Topology (node-cap draws from
    ``np.random.default_rng(seed)``)."""
    spec = read_graphml(path, force_link_cap=force_link_cap,
                        force_node_cap=force_node_cap,
                        rng=np.random.default_rng(seed))
    return compile_topology(spec, max_nodes=max_nodes, max_edges=max_edges)


# Compiled topologies shared by every EpisodeDriver of the process, keyed
# by every input that shapes the result and the file's mtime (an edited
# file is never served stale); bounded.
_LOAD_MEMO: "OrderedDict" = OrderedDict()
_LOAD_MEMO_MAX = 64


def load_topology_cached(path: str, max_nodes: int = 24, max_edges: int = 37,
                         force_link_cap: Optional[float] = None,
                         force_node_cap: Optional[Tuple[float, float]] = None,
                         seed: int = 0, topo_id: int = 0) -> Topology:
    """Memoized :func:`load_topology` stamped with ``topo_id``: a repeated
    key returns the same Topology object."""
    ap = os.path.abspath(path)
    try:
        mtime = os.path.getmtime(ap)
    except OSError:
        mtime = None   # load_topology raises its own error
    key = (ap, mtime, max_nodes, max_edges, force_link_cap, force_node_cap,
           seed, topo_id)
    hit = _LOAD_MEMO.get(key)
    if hit is not None:
        _LOAD_MEMO.move_to_end(key)
        return hit
    topo = load_topology(path, max_nodes=max_nodes, max_edges=max_edges,
                         force_link_cap=force_link_cap,
                         force_node_cap=force_node_cap, seed=seed)
    if topo_id:
        topo = topo.replace(topo_id=torch.tensor(topo_id, dtype=torch.int32))
    _LOAD_MEMO[key] = topo
    while len(_LOAD_MEMO) > _LOAD_MEMO_MAX:
        _LOAD_MEMO.popitem(last=False)
    return topo
