"""Typed configuration for the serving slice of the PyTorch port.

A copy of the subset of ``gsc_tpu.config.schema`` that the port's serving
path needs: ``SimConfig``, ``AgentConfig``, ``EnvLimits``,
``ServiceConfig``/``ServiceFunction`` and the f32 ``PrecisionPolicy``,
with the same field names, defaults and validation.  Every namespace is a
frozen dataclass of plain Python scalars and tuples, so a config is
hashable and can key caches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, Optional, Tuple


class FrozenMap(Mapping):
    """Immutable, hashable, insertion-ordered mapping."""

    __slots__ = ("_items", "_lookup")

    def __init__(self, data):
        items = tuple(data.items()) if isinstance(data, Mapping) else tuple(data)
        object.__setattr__(self, "_items", items)
        object.__setattr__(self, "_lookup", dict(items))

    def __getitem__(self, key):
        return self._lookup[key]

    def __iter__(self):
        return (k for k, _ in self._items)

    def __len__(self):
        return len(self._items)

    def __hash__(self):
        return hash(self._items)

    def __eq__(self, other):
        if isinstance(other, FrozenMap):
            return self._items == other._items
        if isinstance(other, Mapping):
            return dict(self._items) == dict(other)
        return NotImplemented

    def __repr__(self):
        return f"FrozenMap({dict(self._items)!r})"


SUPPORTED_OBJECTIVES = ("prio-flow", "soft-deadline", "soft-deadline-exp", "weighted")
SUPPORTED_OBSERVATIONS = ("ingress_traffic", "node_load", "node_cap")


@dataclass(frozen=True)
class PrecisionPolicy:
    """Dtype policy.  The port carries the f32 policy only: parameters,
    activations, accumulators and outputs are all float32."""

    name: str = "f32"
    param_dtype: str = "float32"
    gnn_compute: str = "float32"
    mlp_compute: str = "float32"
    accum_dtype: str = "float32"
    output_dtype: str = "float32"
    replay_dtype: str = "float32"

    def __post_init__(self):
        for slot in ("param_dtype", "gnn_compute", "mlp_compute",
                     "accum_dtype", "output_dtype", "replay_dtype"):
            if getattr(self, slot) != "float32":
                raise ValueError(
                    f"{slot} must be float32 (the port runs the f32 policy "
                    f"only), got {getattr(self, slot)!r}")


PRECISION_POLICIES = {"f32": PrecisionPolicy(name="f32")}


@dataclass(frozen=True)
class ServiceFunction:
    """One SF's properties."""

    name: str
    processing_delay_mean: float = 1.0
    processing_delay_stdev: float = 1.0
    startup_delay: float = 0.0
    # registry key of the resource demand function load -> demanded capacity
    resource_function_id: str = "default"


@dataclass(frozen=True)
class ServiceConfig:
    """SFC catalog: chains of SFs."""

    sfc_list: Mapping[str, Tuple[str, ...]]
    sf_list: Mapping[str, ServiceFunction]

    def __post_init__(self):
        object.__setattr__(self, "sfc_list", FrozenMap(self.sfc_list))
        object.__setattr__(self, "sf_list", FrozenMap(self.sf_list))
        for sfc, chain in self.sfc_list.items():
            for sf in chain:
                if sf not in self.sf_list:
                    raise ValueError(f"SFC {sfc!r} references unknown SF {sf!r}")

    @property
    def num_sfcs(self) -> int:
        return len(self.sfc_list)

    @property
    def max_chain_len(self) -> int:
        return max(len(c) for c in self.sfc_list.values())

    @property
    def sf_names(self) -> Tuple[str, ...]:
        return tuple(self.sf_list.keys())

    @property
    def sfc_names(self) -> Tuple[str, ...]:
        return tuple(self.sfc_list.keys())


@dataclass(frozen=True)
class SimConfig:
    """Simulator and traffic configuration.  The port's engine runs the
    duration controller's substep as plain PyTorch (the JAX package's
    ``substep_impl="xla"``) with deterministic or Poisson arrivals; the
    MMPP, trace, capacity-override and per-flow options of the JAX package
    are not carried."""

    inter_arrival_mean: float = 10.0
    deterministic_arrival: bool = True
    flow_dr_mean: float = 1.0
    flow_dr_stdev: float = 0.0
    flow_size_shape: float = 0.001
    deterministic_size: bool = True
    run_duration: float = 100.0
    ttl_choices: Tuple[float, ...] = (100.0,)
    # substep quantum in ms of the fixed-step engine
    dt: float = 1.0
    # flow-table slots per replica
    max_flows: int = 128
    # ring-buffer horizon (in substeps) for delayed capacity release
    release_horizon: int = 256
    # refinement rounds of the greedy same-substep capacity admission
    admission_iters: int = 3
    # rank levels for sequential WRR among same-substep collisions
    wrr_rank_levels: int = 4

    def __post_init__(self):
        if self.run_duration <= 0 or self.dt <= 0:
            raise ValueError("run_duration and dt must be positive")
        if not self.ttl_choices:
            raise ValueError("TTL must be set in config file")

    @property
    def substeps_per_run(self) -> int:
        n = round(self.run_duration / self.dt)
        if abs(n * self.dt - self.run_duration) > 1e-9:
            raise ValueError("run_duration must be a multiple of dt")
        return int(n)


@dataclass(frozen=True)
class AgentConfig:
    """Agent configuration for serving a graph-mode actor with the
    monolithic head: observation, GNN and actor widths, the reward
    objective and the action post-processing threshold.  The critic,
    replay and optimiser settings of the JAX package wait for the
    training slice."""

    observation_space: Tuple[str, ...] = ("ingress_traffic", "node_load", "node_cap")
    graph_mode: bool = True
    episode_steps: int = 200
    gnn_features: int = 22
    gnn_num_layers: int = 2
    gnn_num_iter: int = 2
    gnn_aggr: str = "mean"
    # "dense" (plain masked attention) or "pallas" (the fused attention
    # kernel; ``gsc_tpu_torch.ops.gat_attention`` on the card)
    gnn_impl: str = "dense"
    actor_hidden_layer_nodes: Tuple[int, ...] = (256,)
    # None = automatic (the JAX package factors at action dims >= 16384);
    # the port carries the monolithic head only
    factored_head: Optional[bool] = None
    objective: str = "weighted"
    flow_weight: float = 1.0
    delay_weight: float = 0.0
    node_weight: float = 0.0
    instance_weight: float = 0.0
    target_success: float | str = "auto"
    soft_deadline: float = 10.0
    dropoff: float = 10.0
    schedule_threshold: float = 0.1
    precision: str = "f32"

    def __post_init__(self):
        if not self.graph_mode:
            raise ValueError("the port serves graph-mode actors only")
        if self.gnn_num_layers < 1 or self.gnn_num_iter < 1:
            raise ValueError("gnn_num_layers and gnn_num_iter must be >= 1")
        if self.gnn_impl not in ("dense", "pallas"):
            raise ValueError(f"unknown gnn_impl {self.gnn_impl!r}")
        if self.objective not in SUPPORTED_OBJECTIVES:
            raise ValueError(
                f"Unexpected objective {self.objective}. Must be in {SUPPORTED_OBJECTIVES}."
            )
        for obs in self.observation_space:
            if obs not in SUPPORTED_OBSERVATIONS:
                raise ValueError(f"Unsupported observation component {obs!r}")
        if self.objective == "prio-flow" and self.target_success != "auto":
            if not 0 <= float(self.target_success) <= 1:
                raise ValueError("target_success must be in [0,1] or 'auto'")
        if self.precision not in PRECISION_POLICIES:
            raise ValueError(
                f"unknown precision {self.precision!r} (the port carries "
                f"{tuple(PRECISION_POLICIES)})")

    @property
    def precision_policy(self) -> PrecisionPolicy:
        return PRECISION_POLICIES[self.precision]


@dataclass(frozen=True)
class EnvLimits:
    """Fixed padded dimensions (default 24 nodes / 37 edges)."""

    max_nodes: int = 24
    max_edges: int = 37
    num_sfcs: int = 1
    # max chain length: the schedule tensor's SF-position axis
    max_sfs: int = 3
    # distinct SFs in the catalog: the per-(node, SF id) state axis;
    # None = max_sfs
    num_sfs: Optional[int] = None

    @property
    def sf_pool(self) -> int:
        return self.num_sfs if self.num_sfs is not None else self.max_sfs

    @property
    def scheduling_shape(self) -> Tuple[int, int, int, int]:
        # (src node, sfc, sf position, dst node)
        return (self.max_nodes, self.num_sfcs, self.max_sfs, self.max_nodes)

    @property
    def action_dim(self) -> int:
        n = 1
        for s in self.scheduling_shape:
            n *= s
        return n

    @classmethod
    def for_service(cls, service: ServiceConfig, max_nodes: int = 24,
                    max_edges: int = 37) -> "EnvLimits":
        return cls(max_nodes=max_nodes, max_edges=max_edges,
                   num_sfcs=service.num_sfcs, max_sfs=service.max_chain_len,
                   num_sfs=len(service.sf_list))


def replace(cfg, **kw):
    """``dataclasses.replace`` passthrough."""
    return dataclasses.replace(cfg, **kw)
