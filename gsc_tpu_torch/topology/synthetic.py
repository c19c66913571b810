"""Programmatic topology builders.

The port of ``gsc_tpu.topology.synthetic``: Abilene (11 nodes / 14 edges
/ 4 ingress, the flagship scenario), BT Europe (24 nodes / 37 edges),
Claranet (15 / 18), Compuserve (14 / 17), Tinet (53 / 89), Chinanet (42 /
66), Interoute (110 / 146, the largest real network), triangle, line,
star, ring and two_node; ``random_network`` (seeded, bench.py's rung-4
and rung-5 topologies), ``mutate_caps``, ``set_ingress``; and
``write_graphml``.  Node lists are the public Internet Topology Zoo ones;
link delays come from the city coordinates (3 ms where a network has
none).  Every builder returns the JAX package's ``NetworkSpec`` value
for value, the numpy-seeded ones included.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import List, Optional, Sequence, Tuple

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


# Internet Topology Zoo graph structures of the reference's two other
# small real scenarios (Claranet-in4, Compuserve-in4).  Their assets carry
# no coordinates, so every link takes the 3 ms default delay.
_CLARANET_EDGES = [  # 15 nodes / 18 edges
    (0, 3), (1, 3), (1, 4), (2, 3), (3, 14), (4, 12), (5, 14), (6, 14),
    (7, 8), (7, 10), (7, 14), (9, 10), (9, 11), (10, 11), (10, 12),
    (10, 14), (12, 13), (12, 14),
]
_COMPUSERVE_EDGES = [  # 14 nodes / 17 edges
    (0, 12), (1, 12), (2, 11), (2, 12), (2, 5), (3, 12), (4, 5), (4, 13),
    (6, 13), (6, 7), (7, 8), (7, 12), (8, 9), (9, 10), (9, 12), (10, 11),
    (12, 13),
]


def _zoo_network(n: int, edge_list, num_ingress: int, link_cap: float,
                 node_cap: float, link_delay: float = 3.0) -> NetworkSpec:
    caps = [float(node_cap)] * n
    types = ["Ingress" if i < num_ingress else "Normal" for i in range(n)]
    edges = [(u, v, link_cap, link_delay) for u, v in edge_list]
    return NetworkSpec(node_caps=caps, node_types=types, edges=edges)


def claranet(num_ingress: int = 4, link_cap: float = 1000.0,
             node_cap: float = 1.0) -> NetworkSpec:
    """Claranet (Topology Zoo): 15 nodes / 18 edges, the reference's
    Claranet-in4-cap1 scenario shape."""
    return _zoo_network(15, _CLARANET_EDGES, num_ingress, link_cap, node_cap)


def compuserve(num_ingress: int = 4, link_cap: float = 1000.0,
               node_cap: float = 1.0) -> NetworkSpec:
    """Compuserve (Topology Zoo): 14 nodes / 17 edges, the reference's
    Compuserve-in4-cap1 scenario shape."""
    return _zoo_network(14, _COMPUSERVE_EDGES, num_ingress, link_cap,
                        node_cap)


# (label, lat, long) — public Internet Topology Zoo "Tinet" (ex-Tiscali)
# node list: 53 nodes / 89 edges, the reference's mid-size real scenario
# (configs/networks/tinet/, in2..in17 rand-cap0-2 variants).  Unnamed /
# unlocated PoPs keep None coordinates → links touching them use the
# reader's 3 ms default delay (reader.py:212).
_TINET_CITIES = [
    ("New York", 40.71427, -74.00597), ("PoP1", None, None),
    ("Montreal", 45.50884, -73.58781), ("Boston", 42.35843, -71.05977),
    ("London", 51.50853, -0.12574), ("Amsterdam", 52.37403, 4.88969),
    ("Dublin", 53.34399, -6.26719), ("Manchester", 53.48095, -2.23743),
    ("Dusseldorf", 51.22172, 6.77616), ("Antwerp", 51.21667, 4.41667),
    ("PoP10", None, None), ("PoP11", None, None), ("PoP12", None, None),
    ("Athens", 37.97945, 23.71622), ("Bucharest", 44.43225, 26.10626),
    ("Vienna", 48.20849, 16.37208), ("Bratislava", 48.14816, 17.10674),
    ("Prague", 50.08804, 14.42076), ("Warsaw", 52.22977, 21.01178),
    ("Cagliari", 39.20738, 9.13462), ("Rome", 41.89474, 12.4839),
    ("Berlin", 52.52437, 13.41053), ("Catania", 37.50213, 15.08719),
    ("Madrid", 40.4165, -3.70256), ("Singapore", 1.28967, 103.85007),
    ("Hamburg", 53.55, 10.0), ("Sofia", 42.69751, 23.32415),
    ("Oslo", 59.91273, 10.74609), ("Copenhagen", 55.67594, 12.56553),
    ("Palo Alto", 37.44188, -122.14302), ("Stockholm", 59.33258, 18.0649),
    ("Hong Kong", 22.28552, 114.15769), ("PoP32", None, None),
    ("Munich", 48.13743, 11.57549), ("Frankfurt", 50.11667, 8.68333),
    ("Marseille", 43.3, 5.4), ("Barcelona", 41.38879, 2.15899),
    ("Paris", 48.85341, 2.3488), ("Brussels", 50.85045, 4.34878),
    ("Basel", 47.56667, 7.6), ("Zurich", 47.36667, 8.55),
    ("Milan", 45.46427, 9.18951), ("Turin", 45.07049, 7.68682),
    ("Miami", 25.77427, -80.19366), ("Toronto", 43.70011, -79.4163),
    ("Seattle", 47.60621, -122.33207), ("San Jose", 37.33939, -121.89496),
    ("Los Angeles", 34.05223, -118.24368), ("Denver", 39.73915, -104.9847),
    ("Chicago", 41.85003, -87.65005), ("Dallas", 32.78306, -96.80667),
    ("Atlanta", 33.749, -84.38798), ("Washington DC", 38.89511, -77.03637),
]
_TINET_EDGES = [
    (0, 1), (0, 6), (1, 10), (1, 44), (1, 49), (1, 52), (2, 3), (2, 6),
    (4, 5), (4, 6), (4, 7), (4, 8), (4, 37), (4, 38), (5, 7), (5, 8),
    (5, 9), (5, 27), (5, 28), (5, 34), (6, 7), (8, 18), (8, 25), (8, 30),
    (8, 34), (9, 38), (10, 11), (10, 12), (11, 46), (11, 48), (12, 48),
    (12, 49), (13, 22), (14, 15), (14, 34), (15, 16), (15, 32), (15, 33),
    (15, 34), (16, 17), (17, 18), (17, 34), (18, 34), (19, 20), (19, 42),
    (20, 21), (20, 22), (21, 42), (22, 41), (23, 36), (23, 37), (24, 31),
    (24, 35), (24, 46), (25, 28), (26, 32), (27, 28), (27, 30), (28, 30),
    (29, 49), (31, 46), (31, 47), (32, 34), (33, 34), (33, 39), (34, 37),
    (34, 39), (34, 41), (35, 36), (35, 37), (35, 41), (35, 42), (37, 38),
    (37, 39), (37, 42), (39, 40), (40, 41), (41, 42), (43, 51), (43, 52),
    (44, 45), (44, 49), (45, 46), (46, 47), (47, 50), (49, 50), (49, 52),
    (50, 51), (51, 52),
]

# (label, lat, long) — public Internet Topology Zoo "Chinanet" node list:
# 42 nodes / 66 edges (configs/networks/chinanet/, in2..in14 variants).
_CHINANET_CITIES = [
    ("Lhasa", 29.65, 91.1), ("Lanzhou", 36.05639, 103.79222),
    ("Kashi", 39.45472, 75.97972), ("Shiquanhe", 32.51667, 80.06667),
    ("Jinan", 36.66833, 116.99722), ("Qingdao", 36.09861, 120.37194),
    ("Taiyuan", 37.86944, 112.56028), ("Shijiazhuang", 38.04139, 114.47861),
    ("Shanghai", 31.22222, 121.45806), ("Suzhou", 31.31139, 120.61806),
    ("IntlLink1", None, None), ("IntlLink2", None, None),
    ("Nanning", 22.81667, 108.31667), ("Changsha", 28.2, 112.96667),
    ("Guiyang", 26.58333, 106.71667), ("Chongqing", 29.56278, 106.55278),
    ("Chengdu", 30.66667, 104.06667), ("Kunming", 25.03889, 102.71833),
    ("Xi'an", 34.25833, 108.92861), ("Zhengzhou", 34.75778, 113.64861),
    ("IntlLink4", None, None), ("IntlLink3", None, None),
    ("Haikou", 20.04583, 110.34167), ("Hong Kong", 30.13062, 100.51803),
    ("Hangzhou", 30.25528, 120.16889), ("Wuhan", 30.58333, 114.26667),
    ("Hefei", 31.86389, 117.28083), ("Nanjing", 32.06167, 118.77778),
    ("Guangzhou", 23.11667, 113.25), ("Xiamen", 24.47979, 118.08187),
    ("Fuzhou", 26.06139, 119.30611), ("Nanchang", 28.68333, 115.88333),
    ("Xining", 36.61667, 101.76667), ("Urumqi", 43.8, 87.58333),
    ("Harbin", 45.75, 126.65), ("Changchun", 43.88, 125.32278),
    ("Shenyang", 41.79222, 123.43278), ("Dalian", 38.91222, 121.60222),
    ("Tianjin", 39.14222, 117.17667), ("Beijing", 39.9075, 116.39723),
    ("Hohhot", 40.81056, 111.65222), ("Yinchuan", 38.46806, 106.27306),
]
_CHINANET_EDGES = [
    (0, 3), (0, 16), (0, 39), (1, 18), (1, 39), (2, 33), (4, 8), (5, 38),
    (6, 18), (6, 39), (7, 39), (8, 9), (8, 11), (8, 16), (8, 18), (8, 23),
    (8, 24), (8, 25), (8, 26), (8, 27), (8, 28), (8, 31), (8, 38), (8, 39),
    (9, 27), (10, 39), (12, 28), (13, 25), (14, 16), (14, 28), (15, 16),
    (15, 28), (16, 27), (16, 28), (17, 28), (18, 25), (18, 27), (18, 28),
    (18, 32), (18, 33), (18, 39), (18, 40), (18, 41), (19, 39), (20, 23),
    (21, 28), (22, 25), (22, 28), (23, 28), (23, 39), (25, 27), (25, 39),
    (27, 30), (27, 39), (28, 29), (28, 38), (28, 39), (32, 39), (33, 39),
    (34, 39), (35, 39), (36, 39), (37, 38), (38, 39), (39, 40), (39, 41),
]

# (label, lat, long) — public Internet Topology Zoo "Interoute" node list:
# the reference's LARGEST real scenario (configs/networks/interroute/,
# in4..in36 variants).  The Zoo source is a multigraph with parallel links
# and self-loops (110 nodes / 158 raw edges); deduplicated to the simple
# graph (146 edges) — parallel links carry identical caps so the simple
# graph preserves routing semantics.
_INTERROUTE_CITIES = [
    ("Bremen", 53.07516, 8.80777), ("Poznan", 52.41667, 16.96667),
    ("Pisa", 43.71553, 10.39659), ("Florence", 43.76667, 11.25),
    ("Udine", 46.06194, 13.24222), ("Graz", 47.06667, 15.45),
    ("Salzburg", 47.79941, 13.04399), ("Nuremberg", 49.44778, 11.06833),
    ("Leipzig", 51.33962, 12.37129), ("Dresden", 51.05089, 13.73832),
    ("London", 51.50853, -0.12574), ("Brussels", 50.85045, 4.34878),
    ("Stuttgart", 48.78232, 9.17702), ("Amsterdam", 52.37403, 4.88969),
    ("Moscow", 55.75222, 37.61556), ("Helsinki", 60.16952, 24.93545),
    ("Paris", 48.85341, 2.3488), ("Dubai", None, None),
    ("Frankfurt", 50.11667, 8.68333), ("Munich", 48.13743, 11.57549),
    ("Calais", 50.9581, 1.85205), ("Liege", 50.64119, 5.57178),
    ("Dublin", 53.34399, -6.26719), ("Slough", 51.5, -0.58333),
    ("Nancy", 48.68333, 6.2), ("Basle", 47.56667, 7.6),
    ("Karlsruhe", 49.00472, 8.38583), ("Strasbourg", 48.58333, 7.75),
    ("Berne", 46.94809, 7.44744), ("Lausanne", 46.516, 6.63282),
    ("PoP30", None, None), ("PoP31", None, None),
    ("Budapest", 47.49801, 19.03991), ("Vienna", 48.20849, 16.37208),
    ("Dusseldorf", 51.22172, 6.77616), ("Hamburg", 53.55, 10.0),
    ("PoP36", None, None), ("PoP37", None, None),
    ("Milan", 45.46427, 9.18951), ("Berlin", 52.52437, 13.41053),
    ("Sofia", 42.69751, 23.32415), ("Edirne", None, None),
    ("Bucharest", 44.43225, 26.10626), ("Timisoara", 45.74944, 21.22722),
    ("Stockholm", 59.33258, 18.0649), ("Brno", 49.19522, 16.60796),
    ("Cologne", 50.93333, 6.95), ("Bonn", 50.73333, 7.1),
    ("Venice", 45.43861, 12.32667), ("Bologna", 44.49381, 11.33875),
    ("Narbonne", 43.18333, 3.0), ("Bordeaux", 44.83333, -0.56667),
    ("Zurich", 47.36667, 8.55), ("Copenhagen", 55.67594, 12.56553),
    ("Turin", 45.07049, 7.68682), ("Genoa", 44.40632, 8.93386),
    ("Lyon", 45.75, 4.85), ("Marseille", 43.29695, 5.38107),
    ("Bruges", 51.20892, 3.22424), ("Gothenburg", 57.70716, 11.96679),
    ("Oslo", 59.91273, 10.74609), ("Zandvoort", 52.37487, 4.53409),
    ("Istanbul", 52.8557, 44.8332), ("Bari", 41.11773, 16.85118),
    ("Prague", 50.08804, 14.42076), ("Warsaw", 52.22977, 21.01178),
    ("Szolnok", 47.18333, 20.2), ("Krakow", 50.08333, 19.91667),
    ("Ruse", 43.85639, 25.97083), ("Szeged", 46.253, 20.14824),
    ("Pescara", 42.46024, 14.21021), ("Thessalonika", 40.64028, 22.94389),
    ("Lille", 50.63333, 3.06667), ("Luxembourg", 49.61167, 6.13),
    ("Bratislava", 48.14816, 17.10674), ("Hannover", 52.37052, 9.73322),
    ("Madrid", 40.4165, -3.70256), ("Geneva", 46.20222, 6.14569),
    ("Varna", 43.21667, 27.91667), ("Haskovo", 41.94028, 25.56944),
    ("Veliko Turnovo", 43.08124, 25.62904), ("Plovdiv", 42.15, 24.75),
    ("Washington DC", None, None), ("New York", 53.07897, -0.14008),
    ("Naples", 40.83333, 14.25), ("Mazara del Vallo", 37.66414, 12.58804),
    ("Valencia", 39.46975, -0.37739), ("Seville", 37.37722, -5.98694),
    ("Bilbao", 43.26271, -2.92528), ("Poitiers", 46.58333, 0.33333),
    ("Cagliari", 39.20738, 9.13462), ("Olbia", 40.92137, 9.48563),
    ("Nice", 43.70313, 7.26608), ("Toulouse", 43.60426, 1.44367),
    ("PoP95", None, None), ("Barcelona", 41.38879, 2.15899),
    ("East Africa", None, None), ("South Africa", None, None),
    ("Athens", None, None), ("Tunis", None, None),
    ("Malta", None, None), ("Rome", 41.89474, 12.4839),
    ("Essen", 51.45, 7.01667), ("Dortmund", 51.51667, 7.45),
    ("Utrecht", 52.09083, 5.12222), ("Rotterdam", 51.9225, 4.47917),
    ("Antwerp", 51.21667, 4.41667), ("Ghent", 51.05, 3.71667),
    ("Gibraltar", 36.14474, -5.35257), ("PoP109", None, None),
]
_INTERROUTE_EDGES = [
    (0, 35), (0, 103), (1, 39), (1, 65), (2, 3), (2, 55), (2, 101),
    (3, 49), (3, 101), (4, 5), (4, 48), (5, 33), (6, 19), (6, 33), (7, 8),
    (7, 18), (7, 19), (7, 64), (8, 9), (8, 64), (9, 39), (10, 17),
    (10, 22), (10, 31), (10, 37), (10, 82), (10, 83), (11, 21), (11, 72),
    (11, 73), (11, 106), (12, 19), (12, 26), (12, 27), (12, 52), (13, 61),
    (13, 104), (13, 105), (14, 15), (14, 44), (15, 44), (16, 24), (16, 27),
    (16, 56), (16, 72), (16, 89), (17, 23), (18, 26), (18, 27), (18, 47),
    (20, 31), (20, 72), (21, 46), (23, 31), (24, 27), (25, 28), (25, 52),
    (28, 29), (29, 77), (30, 84), (30, 85), (30, 99), (30, 100), (32, 33),
    (32, 43), (32, 66), (32, 74), (33, 45), (34, 46), (34, 102), (34, 104),
    (35, 53), (35, 75), (36, 39), (36, 53), (36, 75), (37, 58), (37, 61),
    (38, 48), (38, 49), (38, 52), (38, 54), (40, 41), (40, 68), (40, 71),
    (40, 80), (40, 81), (41, 62), (41, 68), (41, 71), (42, 43), (42, 68),
    (42, 79), (42, 109), (43, 69), (43, 78), (43, 79), (43, 81), (44, 53),
    (44, 60), (45, 64), (45, 67), (45, 74), (46, 47), (47, 73), (48, 49),
    (49, 70), (50, 51), (50, 57), (50, 93), (50, 95), (51, 88), (51, 89),
    (51, 93), (53, 59), (54, 55), (55, 92), (56, 57), (56, 77), (57, 92),
    (57, 96), (57, 97), (58, 107), (59, 60), (63, 70), (63, 71), (63, 84),
    (63, 98), (65, 67), (66, 109), (69, 109), (76, 87), (76, 88), (78, 80),
    (82, 83), (84, 101), (85, 90), (86, 94), (86, 95), (87, 94), (90, 91),
    (91, 101), (94, 108), (102, 103), (105, 106), (106, 107),
]


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


def tinet(num_ingress: int = 2, link_cap: float = 1000.0,
          node_cap_range: Tuple[int, int] = (0, 3),
          seed: int = 0) -> NetworkSpec:
    """Tinet (Topology Zoo): 53 nodes / 89 edges — the reference's
    tinet-inK-rand-cap0-2 mid-size scenarios (ladder rung 4 entry)."""
    return _geo_zoo_network(_TINET_CITIES, _TINET_EDGES, num_ingress,
                            link_cap, node_cap_range, seed)


def chinanet(num_ingress: int = 2, link_cap: float = 1000.0,
             node_cap_range: Tuple[int, int] = (0, 3),
             seed: int = 0) -> NetworkSpec:
    """Chinanet (Topology Zoo): 42 nodes / 66 edges — the reference's
    chinanet-inK-rand-cap0-2 scenarios."""
    return _geo_zoo_network(_CHINANET_CITIES, _CHINANET_EDGES, num_ingress,
                            link_cap, node_cap_range, seed)


def interroute(num_ingress: int = 4, link_cap: float = 1000.0,
               node_cap_range: Tuple[int, int] = (0, 3),
               seed: int = 0) -> NetworkSpec:
    """Interoute (Topology Zoo): 110 nodes / 146 simple edges — the
    reference's largest real scenario (interroute-inK-rand-cap0-2),
    BASELINE ladder rung 5 scale."""
    return _geo_zoo_network(_INTERROUTE_CITIES, _INTERROUTE_EDGES,
                            num_ingress, link_cap, node_cap_range, seed)


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


def star(n: int = 6, node_cap: float = 10.0, link_cap: float = 100.0,
         link_delay: float = 1.0, num_ingress: int = 1) -> NetworkSpec:
    """Hub-and-spoke: node 0 is the hub, nodes 1..n-1 hang off it — the
    maximal-contention shape (every path crosses the hub)."""
    if n < 2:
        raise ValueError(f"star needs >= 2 nodes, got {n}")
    types = ["Ingress" if i < num_ingress else "Normal" for i in range(n)]
    edges = [(0, i, link_cap, link_delay) for i in range(1, n)]
    return NetworkSpec(node_caps=[node_cap] * n, node_types=types,
                       edges=edges)


def ring(n: int = 6, node_cap: float = 10.0, link_cap: float = 100.0,
         link_delay: float = 1.0, num_ingress: int = 1) -> NetworkSpec:
    """Cycle of n nodes — two disjoint paths between any pair, the
    smallest shape where routing has a real choice."""
    if n < 3:
        raise ValueError(f"ring needs >= 3 nodes, got {n}")
    types = ["Ingress" if i < num_ingress else "Normal" for i in range(n)]
    edges = [(i, (i + 1) % n, link_cap, link_delay) for i in range(n)]
    return NetworkSpec(node_caps=[node_cap] * n, node_types=types,
                       edges=edges)


def two_node(node_caps: Sequence[float] = (5.0, 5.0), link_cap: float = 100.0,
             link_delay: float = 1.0) -> NetworkSpec:
    return NetworkSpec(node_caps=list(node_caps),
                       node_types=["Ingress", "Normal"],
                       edges=[(0, 1, link_cap, link_delay)])


def random_network(n_nodes: int, avg_degree: float = 2.5,
                   node_cap_range: Tuple[int, int] = (1, 4),
                   link_cap: float = 1000.0,
                   delay_range: Tuple[float, float] = (1.0, 10.0),
                   num_ingress: int = 4, seed: int = 0) -> NetworkSpec:
    """Random connected topology, the programmatic analogue of the
    gen_networks.py-mutated training sets (scripts/gen_networks.py +
    BASELINE config 4: 64-128 node randomized topologies)."""
    rng = np.random.default_rng(seed)
    caps = [float(rng.integers(*node_cap_range)) for _ in range(n_nodes)]
    ing = rng.choice(n_nodes, size=min(num_ingress, n_nodes), replace=False)
    types = ["Ingress" if i in ing else "Normal" for i in range(n_nodes)]
    edges: List[Tuple[int, int, float, float]] = []
    seen = set()

    def add(u, v):
        if u != v and (u, v) not in seen and (v, u) not in seen:
            seen.add((u, v))
            edges.append((u, v, link_cap, float(np.around(rng.uniform(*delay_range)))))

    # random spanning tree first (guarantees connectivity)
    perm = rng.permutation(n_nodes)
    for i in range(1, n_nodes):
        add(int(perm[rng.integers(0, i)]), int(perm[i]))
    target_edges = min(int(avg_degree * n_nodes / 2),
                       n_nodes * (n_nodes - 1) // 2)
    while len(edges) < target_edges:
        add(int(rng.integers(n_nodes)), int(rng.integers(n_nodes)))
    return NetworkSpec(node_caps=caps, node_types=types, edges=edges)


def mutate_caps(spec: NetworkSpec, cap_range: Tuple[int, int],
                seed: int = 0) -> NetworkSpec:
    """Rewrite node caps with random values (gen_networks.py:6-21)."""
    rng = np.random.default_rng(seed)
    return NetworkSpec(
        node_caps=[float(rng.integers(*cap_range)) for _ in spec.node_caps],
        node_types=list(spec.node_types), edges=list(spec.edges),
        node_names=list(spec.node_names),
        coords=list(spec.coords) if spec.coords else None)


def set_ingress(spec: NetworkSpec, nodes: Sequence[int]) -> NetworkSpec:
    """Mark the given nodes as Ingress (gen_networks.py:24-38)."""
    types = ["Ingress" if i in set(nodes) else t
             for i, t in enumerate(spec.node_types)]
    return NetworkSpec(node_caps=list(spec.node_caps), node_types=types,
                       edges=list(spec.edges), node_names=list(spec.node_names),
                       coords=list(spec.coords) if spec.coords else None)


# GraphML attribute types of Python values, as networkx writes them
_XML_TYPES = ((bool, "boolean"), (int, "long"), (float, "double"),
              (str, "string"))


def _xml_type(value) -> str:
    for kind, name in _XML_TYPES:
        if isinstance(value, kind):
            return name
    raise TypeError(f"GraphML cannot store {type(value).__name__} "
                    f"{value!r}")


def write_graphml(spec: NetworkSpec, path: str) -> None:
    """Write a NetworkSpec as a GraphML network file with the standard
    library: node attributes NodeCap, NodeType and, where the spec has
    them, label, Latitude and Longitude; edge attributes LinkFwdCap and
    LinkDelay.  What networkx (and so the JAX package) reads back from it
    is what the JAX package's own writer gives: the same attribute names,
    types and values, nodes in order, each node pair's last edge once, in
    the order networkx lists a graph's edges."""
    nodes = []
    for i, cap in enumerate(spec.node_caps):
        attrs = {"NodeCap": cap, "NodeType": spec.node_types[i]}
        if spec.node_names:
            attrs["label"] = spec.node_names[i]
        if spec.coords:
            attrs["Latitude"], attrs["Longitude"] = spec.coords[i]
        nodes.append(attrs)
    # a simple graph: a repeated pair keeps its first position, last values
    adj = {i: {} for i in range(len(nodes))}
    for u, v, cap, delay in spec.edges:
        attrs = {"LinkFwdCap": cap, "LinkDelay": delay}
        adj[u].setdefault(v, {}).update(attrs)
        adj[v][u] = adj[u][v]
    edges, done = [], set()
    for u in adj:
        edges.extend((u, v, a) for v, a in adj[u].items() if v not in done)
        done.add(u)

    keys = {}
    root = ET.Element("graphml", {
        "xmlns": "http://graphml.graphdrawing.org/xmlns",
        "xmlns:xsi": "http://www.w3.org/2001/XMLSchema-instance",
        "xsi:schemaLocation": "http://graphml.graphdrawing.org/xmlns "
        "http://graphml.graphdrawing.org/xmlns/1.0/graphml.xsd"})

    def key_of(name, value, scope):
        kind = _xml_type(value)
        if (name, scope) not in keys:
            kid = f"d{len(keys)}"
            keys[(name, scope)] = (kid, kind)
            ET.SubElement(root, "key", {"id": kid, "for": scope,
                                        "attr.name": name,
                                        "attr.type": kind})
        kid, declared = keys[(name, scope)]
        if declared != kind:
            raise TypeError(f"GraphML attribute {name} mixes {declared} "
                            f"and {kind} values")
        return kid

    def data(parent, attrs, scope):
        for name, value in attrs.items():
            kid = key_of(name, value, scope)
            text = str(value).lower() if isinstance(value, bool) \
                else str(value)
            ET.SubElement(parent, "data", {"key": kid}).text = text

    # keys first, as networkx writes them: declare every attribute before
    # the graph element
    for attrs in nodes:
        for name, value in attrs.items():
            key_of(name, value, "node")
    for _, _, attrs in edges:
        for name, value in attrs.items():
            key_of(name, value, "edge")
    graph = ET.SubElement(root, "graph", {"edgedefault": "undirected"})
    for i, attrs in enumerate(nodes):
        data(ET.SubElement(graph, "node", {"id": str(i)}), attrs, "node")
    for u, v, attrs in edges:
        data(ET.SubElement(graph, "edge", {"source": str(u),
                                           "target": str(v)}), attrs, "edge")
    ET.indent(root)
    ET.ElementTree(root).write(path, encoding="utf-8", xml_declaration=True)
