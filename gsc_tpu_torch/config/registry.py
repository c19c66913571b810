"""Resource-function registry: load -> demanded node capacity.

The port's copy of ``gsc_tpu.config.registry``'s two built-in functions,
written as elementwise torch functions.  The engine looks each SF's
function up by the ``resource_function_id`` of its ``ServiceFunction``.
Loading user plugins is not ported: ``config.loader.load_service``
maps an unknown id to "default" with a warning, and
``get_resource_function`` raises on one.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

_RESOURCE_FUNCTIONS: Dict[str, Callable] = {}


def register_resource_function(name: str):
    def deco(fn):
        _RESOURCE_FUNCTIONS[name] = fn
        return fn
    return deco


def get_resource_function(name: str) -> Callable:
    try:
        return _RESOURCE_FUNCTIONS[name]
    except KeyError:
        raise KeyError(
            f"Unknown resource function {name!r}; registered: "
            f"{sorted(_RESOURCE_FUNCTIONS)}") from None


def has_resource_function(name: str) -> bool:
    return name in _RESOURCE_FUNCTIONS


@register_resource_function("default")
def _identity(load: torch.Tensor) -> torch.Tensor:
    """Default resource demand = load."""
    return load


@register_resource_function("overhead")
def _overhead(load: torch.Tensor) -> torch.Tensor:
    """Fixed base cost while instantiated plus 20% per-unit overhead; zero
    when the instance carries no load."""
    return torch.where(load > 0, 1.0 + 1.2 * load, torch.zeros_like(load))
