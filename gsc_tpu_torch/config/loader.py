"""YAML loaders for the agent, simulator and service configs.

The port of the subset of ``gsc_tpu.config.loader`` the serving slice
reads; the same files (``init-configs`` output) load here.  ``yaml`` is
imported only when a file is read, so the package imports without it.
"""
from __future__ import annotations

from typing import Any, Dict

from .registry import has_resource_function
from .schema import AgentConfig, ServiceConfig, ServiceFunction, SimConfig


def _load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def load_service(path: str) -> ServiceConfig:
    """Parse an SFC/SF catalog yaml."""
    data = _load_yaml(path)
    sfc_list = {name: tuple(chain) for name, chain in data["sfc_list"].items()}
    sf_list = {}
    for name, details in data["sf_list"].items():
        details = details or {}
        rf_id = details.get("resource_function_id", "default")
        if not has_resource_function(rf_id):
            raise ValueError(f"SF {name} names unknown resource function "
                             f"{rf_id!r}")
        sf_list[name] = ServiceFunction(
            name=name,
            processing_delay_mean=float(details.get("processing_delay_mean", 1.0)),
            processing_delay_stdev=float(details.get("processing_delay_stdev", 1.0)),
            startup_delay=float(details.get("startup_delay", 0.0)),
            resource_function_id=rf_id,
        )
    return ServiceConfig(sfc_list=sfc_list, sf_list=sf_list)


def load_sim(path: str, **overrides) -> SimConfig:
    """Parse a simulator config yaml (the options the port carries)."""
    cfg = _load_yaml(path)
    kw: Dict[str, Any] = {}
    det = cfg.get("deterministic", None)
    if det is not None:
        kw["deterministic_arrival"] = bool(det)
        kw["deterministic_size"] = bool(det)
    for key in ("deterministic_arrival", "deterministic_size"):
        if key in cfg:
            kw[key] = bool(cfg[key])
    if "deterministic_arrival" not in kw or "deterministic_size" not in kw:
        raise ValueError("'deterministic_arrival' or 'deterministic_size' "
                         "are not set in simulator config.")
    for key in ("inter_arrival_mean", "flow_dr_mean", "flow_dr_stdev",
                "flow_size_shape", "run_duration", "dt"):
        if key in cfg:
            kw[key] = float(cfg[key])
    if "ttl_choices" not in cfg:
        raise ValueError("TTL must be set in config file")
    kw["ttl_choices"] = tuple(float(t) for t in cfg["ttl_choices"])
    for key in ("use_states", "trace_path", "prediction", "force_link_cap",
                "force_node_cap"):
        if cfg.get(key):
            raise ValueError(f"simulator option {key!r} is not ported")
    if cfg.get("substep_impl", "xla") != "xla" or \
            cfg.get("controller", "duration") != "duration" or \
            cfg.get("controller_class", "DurationController") != \
            "DurationController":
        raise ValueError("the port runs the duration controller's plain "
                         "substep only (substep_impl 'xla')")
    for key in ("max_flows", "release_horizon", "admission_iters",
                "wrr_rank_levels"):
        if key in cfg:
            kw[key] = int(cfg[key])
    kw.update(overrides)
    return SimConfig(**kw)


_AGENT_KEYMAP = {
    "GNN_features": "gnn_features",
    "GNN_num_layers": "gnn_num_layers",
    "GNN_num_iter": "gnn_num_iter",
    "GNN_aggr": "gnn_aggr",
}


def load_agent(path: str, **overrides) -> AgentConfig:
    """Parse an agent config yaml (reference key spellings accepted; keys
    the serving slice does not use, such as the critic's and the
    optimiser's, are skipped)."""
    cfg = _load_yaml(path)
    kw: Dict[str, Any] = {}
    fields = AgentConfig.__dataclass_fields__
    for key, val in cfg.items():
        key = _AGENT_KEYMAP.get(key, key)
        if key not in fields:
            continue
        if isinstance(val, list):
            val = tuple(val)
        kw[key] = val
    kw.update(overrides)
    return AgentConfig(**kw)
