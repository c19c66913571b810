"""Resource-function registry: load -> demanded node capacity.

The port of ``gsc_tpu.config.registry``: the two built-in functions,
written as elementwise torch functions, and user plugins loaded from a
``.py`` file or a directory of them
(``load_resource_function_plugins``, the ``--resource-functions-path``
of ``train``, ``infer``, ``serve`` and ``simulate``).  The engine looks
each SF's function up by the ``resource_function_id`` of its
``ServiceFunction``; ``config.loader.load_service`` maps an unknown id
to "default" with a warning, and ``get_resource_function`` raises on
one.

A plugin is an elementwise function on f32 tensors.  On the CPU the
plain engine calls it as it is; on the card substep kernel #2 runs it
compiled (``ops.resource_codegen``), which takes the operations listed
there and refuses any other by name.  A plugin written with operators
only (``return load * load``) is valid in the JAX package too.
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


def load_resource_function_plugins(path: str) -> list:
    """Import user resource-function modules and register them.

    ``path`` is a ``.py`` file or a directory of them, imported in sorted
    order.  Each module either calls
    ``gsc_tpu_torch.config.registry.register_resource_function`` itself,
    or defines ``resource_function(load)``, which is then registered
    under the file's stem.  Returns the names registered."""
    import importlib.util
    import os

    files = ([os.path.join(path, f) for f in sorted(os.listdir(path))
              if f.endswith(".py")] if os.path.isdir(path) else [path])
    registered = []
    for fp in files:
        stem = os.path.splitext(os.path.basename(fp))[0]
        before = set(_RESOURCE_FUNCTIONS)
        spec = importlib.util.spec_from_file_location(
            f"gsc_tpu_torch_resource_plugin_{stem}", fp)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        registered += sorted(set(_RESOURCE_FUNCTIONS) - before)
        if stem not in _RESOURCE_FUNCTIONS and hasattr(module,
                                                       "resource_function"):
            _RESOURCE_FUNCTIONS[stem] = module.resource_function
            registered.append(stem)
    return registered


@register_resource_function("default")
def _identity(load: torch.Tensor) -> torch.Tensor:
    """Default resource demand = load."""
    return load


@register_resource_function("overhead")
def _overhead(load: torch.Tensor) -> torch.Tensor:
    """Fixed base cost while instantiated plus 20% per-unit overhead; zero
    when the instance carries no load."""
    return torch.where(load > 0, 1.0 + 1.2 * load, torch.zeros_like(load))
