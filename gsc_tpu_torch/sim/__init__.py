"""The flow simulator: state, host and device traffic, the fixed-step
engine, per-flow control, traffic prediction and the canned backend."""
from .engine import ServiceTables, SimEngine
from .state import (EdgeCapSchedule, FlowTable, SimMetrics, SimState,
                    TrafficSchedule, init_state)
from .traffic import TraceEvents, generate_traffic, traffic_capacity
from .traffic_device import DeviceTraffic
from .perflow import PendingFlows, PerFlowController
from .dummy import DummyEngine
from .predictor import (RNNTrafficPredictor, interval_traffic_series,
                        predict_ingress_traffic)

__all__ = ["DeviceTraffic", "DummyEngine", "EdgeCapSchedule", "FlowTable",
           "PendingFlows", "PerFlowController", "RNNTrafficPredictor",
           "ServiceTables", "SimEngine", "SimMetrics", "SimState",
           "TraceEvents", "TrafficSchedule", "generate_traffic",
           "init_state", "interval_traffic_series",
           "predict_ingress_traffic", "traffic_capacity"]
