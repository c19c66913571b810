"""Topologies: the padded dense compiler, the synthetic builders, the
scenario registry and mix plans, and the on-device scenario factory."""
from . import synthetic
from .compiler import (INF_DELAY, NetworkSpec, Topology, TopologyBucket,
                       compile_topology, edge_weight, geo_delay_ms,
                       stack_topologies)
from .scenarios import (DEFAULT_REGISTRY, ScenarioRegistry,
                        build_mix_entries, parse_topo_faults, plan_mix,
                        validate_mix)

__all__ = ["DEFAULT_REGISTRY", "INF_DELAY", "NetworkSpec",
           "ScenarioRegistry", "Topology", "TopologyBucket",
           "build_mix_entries", "compile_topology", "edge_weight",
           "geo_delay_ms", "parse_topo_faults", "plan_mix",
           "stack_topologies", "synthetic", "validate_mix"]
