"""Topologies: the padded dense compiler and the synthetic builders."""
from . import synthetic
from .compiler import (INF_DELAY, NetworkSpec, Topology, compile_topology,
                       edge_weight, geo_delay_ms, stack_topologies)

__all__ = ["INF_DELAY", "NetworkSpec", "Topology", "compile_topology",
           "edge_weight", "geo_delay_ms", "stack_topologies", "synthetic"]
