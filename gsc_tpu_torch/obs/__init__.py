"""Run observability: the metrics hub, event sinks, series rings, device
gauges, the pipeline watchdog, the ``/metrics`` endpoint, the learning
signal ledger, learning curves and the run observer.

The port of ``gsc_tpu.obs``, with the device-cost ledger (``perf``:
observed dispatches in place of compiled programs), serving's SLO engine
and request tracer (``slo``) and the Chrome-trace exporter (``trace``).
"""
from .curves import CURVES_SCHEMA_VERSION, extract_curves, write_curves
from .device import device_memory_snapshot, record_device_gauges
from .endpoint import MetricsEndpoint, prometheus_text
from .hub import MetricsHub
from .learning import LearnLedger, LearnLedgerSpec, emit_learn_signal
from .perf import PEAK_ENVELOPES, PERF_SCHEMA_VERSION, CostLedger
from .run import RunObserver
from .series import (BLACKBOX_SCHEMA_VERSION, SERIES_SCHEMA_VERSION,
                     SeriesStore, write_blackbox, write_series)
from .sinks import (JsonlSink, ListSink, TailSink, read_events,
                    rotated_paths, write_atomic_json)
from .slo import (SLO_SCHEMA_VERSION, ServeTracer, SLOEngine, SLOObjectives,
                  parse_slo_spec, write_slo_json)
from .trace import TRACE_TRACKS, build_trace, export_trace, validate_trace
from .watchdog import PipelineWatchdog

__all__ = [
    "MetricsHub", "JsonlSink", "ListSink", "TailSink", "SeriesStore",
    "SERIES_SCHEMA_VERSION", "BLACKBOX_SCHEMA_VERSION", "write_series",
    "write_blackbox", "write_atomic_json", "read_events",
    "rotated_paths", "device_memory_snapshot", "record_device_gauges",
    "PipelineWatchdog", "RunObserver", "LearnLedger", "LearnLedgerSpec",
    "emit_learn_signal", "MetricsEndpoint", "prometheus_text",
    "CURVES_SCHEMA_VERSION", "extract_curves", "write_curves",
    "SLO_SCHEMA_VERSION", "SLOEngine", "SLOObjectives", "ServeTracer",
    "parse_slo_spec", "write_slo_json", "TRACE_TRACKS", "build_trace",
    "export_trace", "validate_trace", "CostLedger", "PEAK_ENVELOPES",
    "PERF_SCHEMA_VERSION",
]
