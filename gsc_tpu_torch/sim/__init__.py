"""The flow simulator: state, host and device traffic and the fixed-step
engine."""
from .engine import ServiceTables, SimEngine
from .state import (EdgeCapSchedule, FlowTable, SimMetrics, SimState,
                    TrafficSchedule, init_state)
from .traffic import TraceEvents, generate_traffic, traffic_capacity
from .traffic_device import DeviceTraffic

__all__ = ["DeviceTraffic", "EdgeCapSchedule", "FlowTable",
           "ServiceTables", "SimEngine", "SimMetrics", "SimState",
           "TraceEvents", "TrafficSchedule", "generate_traffic",
           "init_state", "traffic_capacity"]
