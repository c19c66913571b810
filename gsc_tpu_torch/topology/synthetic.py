"""Programmatic topology builders.

The port of the ``gsc_tpu.topology.synthetic`` builders on the serving
slice's path and in its tests: Abilene (11 nodes / 14 edges / 4 ingress,
the flagship scenario), BT Europe (24 nodes / 37 edges), triangle and
line.  Node lists are the public Internet Topology Zoo ones; link delays
come from the city coordinates.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .compiler import NetworkSpec, geo_delay_ms

# (label, lat, long) — public Topology Zoo Abilene city list.
_ABILENE_CITIES = [
    ("New York", 40.71427, -74.00597),
    ("Chicago", 41.85003, -87.65005),
    ("Washington DC", 38.89511, -77.03637),
    ("Seattle", 47.60621, -122.33207),
    ("Sunnyvale", 37.36883, -122.03635),
    ("Los Angeles", 34.05223, -118.24368),
    ("Denver", 39.73915, -104.9847),
    ("Kansas City", 39.11417, -94.62746),
    ("Houston", 29.76328, -95.36327),
    ("Atlanta", 33.749, -84.38798),
    ("Indianapolis", 39.76838, -86.15804),
]
_ABILENE_EDGES = [
    (0, 1), (0, 2), (1, 10), (2, 9), (3, 4), (3, 6), (4, 5), (4, 6),
    (5, 8), (6, 7), (7, 8), (7, 10), (8, 9), (9, 10),
]


def abilene(num_ingress: int = 4, link_cap: float = 1000.0,
            node_cap_range: Tuple[int, int] = (1, 3),
            seed: int = 0) -> NetworkSpec:
    """Abilene with the first ``num_ingress`` cities as ingress and random
    integer node caps in [lo, hi) — the shape of the reference's
    abilene-in4-rand-cap1-2 benchmark scenario."""
    return _geo_zoo_network(_ABILENE_CITIES, _ABILENE_EDGES, num_ingress,
                            link_cap, node_cap_range, seed)


# (label, lat, long) — public Internet Topology Zoo "BT Europe" node list
# (the reference's 24-node/37-edge ladder-rung-3 scenario,
# configs/networks/BtEurope-in2-cap1.graphml; its 24/37 scale is exactly
# the reference's padding limits, environment_limits.py:44-64).  New York
# and Washington are satellite/transatlantic PoPs without coordinates in
# Topology Zoo; their links use the reader's 3 ms default (reader.py:212).
_BTEUROPE_CITIES = [
    ("Budapest", 47.49801, 19.03991),
    ("Munich", 48.13743, 11.57549),
    ("Prague", 50.08804, 14.42076),
    ("Vienna", 48.20849, 16.37208),
    ("Dusseldorf", 51.22172, 6.77616),
    ("Frankfurt", 50.11667, 8.68333),
    ("Zurich", 47.36667, 8.55),
    ("Paris", 48.85341, 2.3488),
    ("Milan", 45.46427, 9.18951),
    ("Barcelona", 41.38879, 2.15899),
    ("Goonhilly", 50.05, -5.2),
    ("New York", None, None),
    ("Washington", None, None),
    ("Madrid", 40.4165, -3.70256),
    ("Helsinki", 60.16952, 24.93545),
    ("Copenhagen", 55.67594, 12.56553),
    ("London1", 51.50853, -0.12574),
    ("London2", 51.50853, -0.12574),
    ("Madley", 52.03333, -2.85),
    ("Dublin", 53.34399, -6.26719),
    ("Brussels", 50.85045, 4.34878),
    ("Amsterdam", 52.37403, 4.88969),
    ("Gothenburg", 57.70716, 11.96679),
    ("Stockholm", 59.33258, 18.0649),
]
_BTEUROPE_EDGES = [
    (0, 17), (0, 5), (1, 4), (1, 5), (2, 16), (2, 5), (3, 5), (3, 21),
    (4, 5), (4, 21), (5, 6), (5, 8), (5, 17), (5, 21), (6, 17), (7, 17),
    (7, 21), (8, 17), (9, 13), (9, 21), (10, 17), (11, 17), (12, 16),
    (13, 17), (14, 23), (15, 23), (16, 17), (16, 21), (16, 23), (17, 18),
    (17, 19), (17, 20), (17, 21), (19, 21), (21, 22), (21, 23), (22, 23),
]


def bteurope(num_ingress: int = 2, link_cap: float = 1000.0,
             node_cap: float = 1.0,
             node_cap_range: Optional[Tuple[int, int]] = None,
             seed: int = 0) -> NetworkSpec:
    """BT Europe (Topology Zoo): 24 nodes / 37 edges, first ``num_ingress``
    nodes ingress — the BtEurope-in2-cap1 rung-3 scenario shape.  With
    ``node_cap_range`` caps are random integers in [lo, hi) like the
    rand-cap variants."""
    return _geo_zoo_network(_BTEUROPE_CITIES, _BTEUROPE_EDGES, num_ingress,
                            link_cap, node_cap_range, seed,
                            node_cap=node_cap)


def _geo_zoo_network(cities, edge_list, num_ingress, link_cap,
                     node_cap_range, seed,
                     node_cap: float = 1.0) -> NetworkSpec:
    """Zoo network with per-link geodesic delay (3 ms default where a PoP
    has no coordinates, reader.py:212).  Node caps are random integers in
    [lo, hi) — the reference's rand-capL-H assets — or the fixed
    ``node_cap`` when ``node_cap_range`` is None (capK assets)."""
    rng = np.random.default_rng(seed)
    n = len(cities)
    if node_cap_range is None:
        caps = [float(node_cap)] * n
    else:
        caps = [float(rng.integers(*node_cap_range)) for _ in range(n)]
    types = ["Ingress" if i < num_ingress else "Normal" for i in range(n)]
    edges = []
    for u, v in edge_list:
        _, lat1, lon1 = cities[u]
        _, lat2, lon2 = cities[v]
        if None in (lat1, lon1, lat2, lon2):
            delay = 3.0
        else:
            delay = geo_delay_ms(lat1, lon1, lat2, lon2)
        edges.append((u, v, link_cap, delay))
    return NetworkSpec(
        node_caps=caps, node_types=types, edges=edges,
        node_names=[c[0] for c in cities],
        coords=[(c[1] or 0.0, c[2] or 0.0) for c in cities])


def triangle(node_caps: Sequence[float] = (10.0, 10.0, 10.0),
             link_cap: float = 100.0, link_delay: float = 1.0,
             num_ingress: int = 1) -> NetworkSpec:
    types = ["Ingress" if i < num_ingress else "Normal" for i in range(3)]
    edges = [(0, 1, link_cap, link_delay), (1, 2, link_cap, link_delay),
             (0, 2, link_cap, link_delay)]
    return NetworkSpec(node_caps=list(node_caps), node_types=types, edges=edges)


def line(n: int = 3, node_cap: float = 10.0, link_cap: float = 100.0,
         link_delay: float = 1.0, num_ingress: int = 1) -> NetworkSpec:
    types = ["Ingress" if i < num_ingress else "Normal" for i in range(n)]
    edges = [(i, i + 1, link_cap, link_delay) for i in range(n - 1)]
    return NetworkSpec(node_caps=[node_cap] * n, node_types=types, edges=edges)
