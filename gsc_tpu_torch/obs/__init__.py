"""Observability: the metrics hub the serving path reports into."""
from .hub import MetricsHub

__all__ = ["MetricsHub"]
