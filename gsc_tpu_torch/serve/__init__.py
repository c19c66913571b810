"""Serving: the greedy policy or the SPR heuristic behind a micro-batcher,
fleets of workers with a brownout tier, and train-while-serve hot-swap."""
from .batcher import BATCH_MODES, MicroBatcher, ServeError, ServeFuture
from .fallback import SPRFallbackPolicy, spr_schedule_action
from .fleet import (FleetDispatcher, VersionWatcher, WeightPublisher,
                    load_version, params_fingerprint, read_latest)
from .policy import GreedyServePolicy, ObsTemplate
from .run import ServeReport, run_serve, uniform_schedule_action
from .server import PolicyServer

__all__ = ["BATCH_MODES", "FleetDispatcher", "GreedyServePolicy",
           "MicroBatcher", "ObsTemplate", "PolicyServer",
           "SPRFallbackPolicy", "ServeError", "ServeFuture", "ServeReport",
           "VersionWatcher", "WeightPublisher", "load_version",
           "params_fingerprint", "read_latest", "run_serve",
           "spr_schedule_action", "uniform_schedule_action"]
