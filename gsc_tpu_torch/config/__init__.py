"""Configuration: frozen dataclasses, the abc and mixed catalogs and the
resource functions."""
from .catalog import (abc_service, init_configs_agent, init_configs_sim,
                      mixed_service)
from .registry import get_resource_function, register_resource_function
from .schema import (PRECISION_POLICIES, AgentConfig, EnvLimits,
                     PrecisionPolicy, SchedulerConfig, ServiceConfig,
                     ServiceFunction, SimConfig, precision_policy, replace)

__all__ = [
    "AgentConfig", "EnvLimits", "PRECISION_POLICIES", "PrecisionPolicy",
    "SchedulerConfig", "ServiceConfig",
    "ServiceFunction", "SimConfig", "abc_service", "get_resource_function",
    "init_configs_agent", "init_configs_sim", "mixed_service",
    "precision_policy", "register_resource_function", "replace",
]
