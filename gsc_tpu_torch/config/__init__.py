"""Configuration: frozen dataclasses, the abc catalog and the resource
functions."""
from .catalog import abc_service, init_configs_agent, init_configs_sim
from .registry import get_resource_function, register_resource_function
from .schema import (AgentConfig, EnvLimits, PrecisionPolicy, ServiceConfig,
                     ServiceFunction, SimConfig, replace)

__all__ = [
    "AgentConfig", "EnvLimits", "PrecisionPolicy", "ServiceConfig",
    "ServiceFunction", "SimConfig", "abc_service", "get_resource_function",
    "init_configs_agent", "init_configs_sim",
    "register_resource_function", "replace",
]
