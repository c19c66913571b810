"""YAML loaders for the agent, simulator, service and scheduler configs.

The port of the subset of ``gsc_tpu.config.loader`` that serving and
training read; the same files (``init-configs`` output) load here.
``yaml`` is imported only when a file is read, so the package imports
without it.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict

from .registry import has_resource_function, load_resource_function_plugins
from .schema import (AgentConfig, MMPPState, SchedulerConfig,
                     ServiceConfig, ServiceFunction, SimConfig)

log = logging.getLogger("gsc_tpu_torch.config")


def _load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def load_service(path: str,
                 resource_functions_path: str = None) -> ServiceConfig:
    """Parse an SFC/SF catalog yaml.  ``resource_functions_path`` loads
    resource-function plugins first
    (``registry.load_resource_function_plugins``).  An SF naming an
    unknown resource function falls back to "default" with a warning, as
    in the JAX package and the reference."""
    if resource_functions_path:
        load_resource_function_plugins(resource_functions_path)
    data = _load_yaml(path)
    sfc_list = {name: tuple(chain) for name, chain in data["sfc_list"].items()}
    sf_list = {}
    for name, details in data["sf_list"].items():
        details = details or {}
        rf_id = details.get("resource_function_id", "default")
        if not has_resource_function(rf_id):
            log.warning("SF %s names unknown resource function %r (pass "
                        "--resource-functions-path to load plugins); using "
                        "default", name, rf_id)
            rf_id = "default"
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
                "flow_size_shape", "run_duration", "vnf_timeout", "dt"):
        if key in cfg:
            kw[key] = float(cfg[key])
    if "ttl_choices" not in cfg:
        raise ValueError("TTL must be set in config file")
    kw["ttl_choices"] = tuple(float(t) for t in cfg["ttl_choices"])
    # present keys count, whatever their value: force_link_cap 0 applies
    if cfg.get("force_link_cap") is not None:
        kw["force_link_cap"] = float(cfg["force_link_cap"])
    if cfg.get("force_node_cap") is not None:
        kw["force_node_cap"] = tuple(float(c) for c in cfg["force_node_cap"])
    if cfg.get("use_states"):
        kw["use_states"] = True
        kw["init_state"] = cfg["init_state"]
        kw["rand_init_state"] = bool(cfg.get("rand_init_state", False))
        kw["states"] = tuple(
            MMPPState(name=k, inter_arr_mean=float(v["inter_arr_mean"]),
                      switch_p=float(v["switch_p"]))
            for k, v in cfg["states"].items())
    if "trace_path" in cfg:
        kw["trace_path"] = cfg["trace_path"]
    if "prediction" in cfg:
        kw["prediction"] = bool(cfg["prediction"])
    spelled = {key: _CONTROLLERS.get(cfg[key], cfg[key])
               for key in ("controller_class", "controller") if key in cfg}
    if len(set(spelled.values())) > 1:
        raise ValueError(
            f"conflicting controller_class={cfg['controller_class']!r} and "
            f"controller={cfg['controller']!r} in {path}")
    kw["controller"] = next(iter(spelled.values()), "duration")
    kw["substep_impl"] = str(cfg.get("substep_impl", "xla"))
    for key in ("max_flows", "release_horizon", "admission_iters",
                "wrr_rank_levels", "scan_unroll"):
        if key in cfg:
            kw[key] = int(cfg[key])
    kw.update(overrides)
    return SimConfig(**kw)


_CONTROLLERS = {"duration": "duration", "DurationController": "duration",
                "per_flow": "per_flow", "FlowController": "per_flow"}

_AGENT_KEYMAP = {
    "GNN_features": "gnn_features",
    "GNN_num_layers": "gnn_num_layers",
    "GNN_num_iter": "gnn_num_iter",
    "GNN_aggr": "gnn_aggr",
}


def load_agent(path: str, **overrides) -> AgentConfig:
    """Parse an agent config yaml (reference key spellings accepted; keys
    the port does not carry are skipped)."""
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


def _resolve_network_path(p: str, anchor: str) -> str:
    """A scheduler's network path: as written (cwd-relative or absolute)
    when it exists, else joined to the scheduler yaml's directory and then
    to each of its ancestors in turn; unresolvable paths come back as
    written, for the topology loader to raise on."""
    if os.path.isabs(p) or os.path.exists(p):
        return p
    d = os.path.dirname(os.path.abspath(anchor))
    while True:
        cand = os.path.join(d, p)
        if os.path.exists(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return p
        d = parent


def load_scheduler(path: str) -> SchedulerConfig:
    """Parse a scheduler yaml: training networks, inference network and
    switching period (default 10 episodes)."""
    cfg = _load_yaml(path)
    return SchedulerConfig(
        training_network_files=tuple(
            _resolve_network_path(p, path)
            for p in cfg["training_network_files"]),
        inference_network=_resolve_network_path(cfg["inference_network"],
                                                path),
        period=int(cfg.get("period", 10)),
    )
