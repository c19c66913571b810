"""Serving: the greedy policy behind a deadline micro-batcher."""
from .batcher import MicroBatcher, ServeError, ServeFuture
from .policy import GreedyServePolicy, ObsTemplate
from .run import ServeReport, run_serve, uniform_schedule_action
from .server import PolicyServer

__all__ = ["GreedyServePolicy", "MicroBatcher", "ObsTemplate",
           "PolicyServer", "ServeError", "ServeFuture", "ServeReport",
           "run_serve", "uniform_schedule_action"]
