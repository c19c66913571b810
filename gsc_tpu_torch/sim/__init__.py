"""The flow simulator: state, traffic and the fixed-step engine."""
from .engine import ServiceTables, SimEngine
from .state import (FlowTable, SimMetrics, SimState, TrafficSchedule,
                    init_state)
from .traffic import generate_traffic, traffic_capacity

__all__ = ["FlowTable", "ServiceTables", "SimEngine", "SimMetrics",
           "SimState", "TrafficSchedule", "generate_traffic", "init_state",
           "traffic_capacity"]
