"""Typed configuration of the PyTorch port.

A copy of the subset of ``gsc_tpu.config.schema`` that the port's serving
and training paths need: ``SimConfig``, ``AgentConfig``, ``EnvLimits``,
``ServiceConfig``/``ServiceFunction``, ``SchedulerConfig`` and
``PrecisionPolicy`` with its "f32" and "bf16" policies, with the same
field names, defaults and validation.  Every namespace is a
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


# Dtypes a mixed-precision compute or replay slot may take.  float16 is
# absent: bf16 shares f32's exponent range, so the policy needs no loss
# scaling.
_COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclass(frozen=True)
class PrecisionPolicy:
    """End-to-end dtype policy of the training and serving stack.

    - ``param_dtype``: master parameters and optimiser state, always
      float32 (Polyak updates at tau = 1e-4 and Adam's moments do not
      survive bf16's 8-bit mantissa);
    - ``gnn_compute`` / ``mlp_compute``: the activation and matmul dtype
      of the GATv2 embedder and of the actor/critic Linear stacks; every
      contraction accumulates in f32 and the attention softmax runs on
      f32 logits;
    - ``replay_dtype``: storage dtype of the replay's float obs, next_obs
      and action leaves; reward and done stay f32.

    Network outputs (actions, Q-values) are always f32.  A float32 slot
    resolves to None in ``gnn_dtype``/``mlp_dtype``/``replay_cast_dtype``,
    which every consumer reads as "take the f32 code path verbatim", so
    the "f32" policy is bit-identical to a stack without a policy."""

    name: str = "f32"
    param_dtype: str = "float32"
    gnn_compute: str = "float32"
    mlp_compute: str = "float32"
    accum_dtype: str = "float32"
    output_dtype: str = "float32"
    replay_dtype: str = "float32"

    def __post_init__(self):
        for slot in ("param_dtype", "accum_dtype", "output_dtype"):
            if getattr(self, slot) != "float32":
                raise ValueError(
                    f"{slot} must be float32 (f32 master params/accumulators"
                    f"/outputs are the policy contract), got "
                    f"{getattr(self, slot)!r}")
        for slot in ("gnn_compute", "mlp_compute", "replay_dtype"):
            if getattr(self, slot) not in _COMPUTE_DTYPES:
                raise ValueError(
                    f"{slot} must be one of {_COMPUTE_DTYPES}, got "
                    f"{getattr(self, slot)!r}")

    @property
    def gnn_dtype(self) -> Optional[str]:
        return None if self.gnn_compute == "float32" else self.gnn_compute

    @property
    def mlp_dtype(self) -> Optional[str]:
        return None if self.mlp_compute == "float32" else self.mlp_compute

    @property
    def replay_cast_dtype(self) -> Optional[str]:
        return None if self.replay_dtype == "float32" else self.replay_dtype

    @property
    def mixed(self) -> bool:
        return any(getattr(self, s) != "float32"
                   for s in ("gnn_compute", "mlp_compute", "replay_dtype"))


# Named policies (AgentConfig.precision, ``cli train --precision``): "f32"
# is the f32 stack verbatim, "bf16" computes the GNN and the MLP heads and
# stores replay in bfloat16.
PRECISION_POLICIES = {
    "f32": PrecisionPolicy(name="f32"),
    "bf16": PrecisionPolicy(name="bf16", gnn_compute="bfloat16",
                            mlp_compute="bfloat16",
                            replay_dtype="bfloat16"),
}


def precision_policy(name: str) -> PrecisionPolicy:
    """A policy name (AgentConfig.precision) -> its PrecisionPolicy."""
    try:
        return PRECISION_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown precision {name!r} (expected one of "
            f"{tuple(PRECISION_POLICIES)})") from None


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
    duration controller's substep through the substep megakernel (the
    CUDA kernel of ``ops.substep`` on the card, the plain substep on the
    CPU) with deterministic or Poisson arrivals.  ``substep_impl`` is the
    JAX package's key, validated as there so that its yaml files load; it
    does not choose a path in the port.  ``force_link_cap`` and
    ``force_node_cap`` override the capacities of every network read from
    GraphML (``topology.compiler.read_graphml``).  The MMPP and trace
    options of the JAX package are not carried, and per-flow control is
    only named so that it can be refused."""

    inter_arrival_mean: float = 10.0
    deterministic_arrival: bool = True
    flow_dr_mean: float = 1.0
    flow_dr_stdev: float = 0.0
    flow_size_shape: float = 0.001
    deterministic_size: bool = True
    run_duration: float = 100.0
    ttl_choices: Tuple[float, ...] = (100.0,)
    # capacity overrides of GraphML networks: every link's capacity, and
    # (lo, hi) integer node capacities drawn uniformly in [lo, hi)
    force_link_cap: Optional[float] = None
    force_node_cap: Optional[Tuple[float, float]] = None
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
    # "duration" (batch control, the only one the port runs) or "per_flow"
    controller: str = "duration"
    # the JAX package's "xla" or "pallas"; the port runs the megakernel
    # for either
    substep_impl: str = "xla"

    def __post_init__(self):
        if self.run_duration <= 0 or self.dt <= 0:
            raise ValueError("run_duration and dt must be positive")
        if not self.ttl_choices:
            raise ValueError("TTL must be set in config file")
        if self.controller not in ("duration", "per_flow"):
            raise ValueError(f"unknown controller {self.controller!r} "
                             "(expected 'duration' or 'per_flow')")
        if self.substep_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown substep_impl {self.substep_impl!r} "
                             "(expected 'xla' or 'pallas')")
        if self.substep_impl == "pallas" and self.controller == "per_flow":
            raise ValueError(
                "substep_impl='pallas' supports only controller='duration' "
                "(per-flow control runs the XLA substep)")
        if self.controller == "per_flow":
            raise ValueError("per-flow control is not ported (ROADMAP "
                             "Queue 1)")

    @property
    def substeps_per_run(self) -> int:
        n = round(self.run_duration / self.dt)
        if abs(n * self.dt - self.run_duration) > 1e-9:
            raise ValueError("run_duration must be a multiple of dt")
        return int(n)


@dataclass(frozen=True)
class AgentConfig:
    """Agent configuration of a graph-mode DDPG agent: observation, GNN,
    actor and critic widths, the head (monolithic or factored), the reward
    objective, replay, exploration and optimiser settings and the action
    post-processing threshold."""

    observation_space: Tuple[str, ...] = ("ingress_traffic", "node_load", "node_cap")
    graph_mode: bool = True
    # per-step node-permutation augmentation (not ported: must stay off)
    shuffle_nodes: bool = False
    episode_steps: int = 200
    gnn_features: int = 22
    gnn_num_layers: int = 2
    gnn_num_iter: int = 2
    gnn_aggr: str = "mean"
    # "dense" (plain masked attention) or "pallas" (the fused attention
    # kernel; ``gsc_tpu_torch.ops.gat_attention`` on the card)
    gnn_impl: str = "dense"
    actor_hidden_layer_nodes: Tuple[int, ...] = (256,)
    critic_hidden_layer_nodes: Tuple[int, ...] = (64,)
    # the factored (per-node bilinear) actor and critic heads: None =
    # automatic, on in graph mode at action dims >= 16384
    # (models.nets.FACTORED_HEAD_THRESHOLD); key/query width of their
    # bilinear form
    factored_head: Optional[bool] = None
    factored_key_dim: int = 32
    objective: str = "weighted"
    flow_weight: float = 1.0
    delay_weight: float = 0.0
    node_weight: float = 0.0
    instance_weight: float = 0.0
    target_success: float | str = "auto"
    soft_deadline: float = 10.0
    dropoff: float = 10.0
    # replay, exploration and optimisation
    mem_limit: int = 10000
    rand_mu: float = 0.0
    rand_sigma: float = 0.3
    nb_steps_warmup_critic: int = 200
    gamma: float = 0.99
    target_model_update: float = 1e-4
    learning_rate: float = 1e-3
    batch_size: int = 100
    # gradient steps per learn burst; None = episode_steps
    learn_steps: Optional[int] = None
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
        if self.learn_steps is not None and self.learn_steps < 1:
            raise ValueError("learn_steps must be >= 1 (or None)")
        if self.precision not in PRECISION_POLICIES:
            raise ValueError(
                f"unknown precision {self.precision!r} (expected one of "
                f"{tuple(PRECISION_POLICIES)})")

    @property
    def precision_policy(self) -> PrecisionPolicy:
        return PRECISION_POLICIES[self.precision]


@dataclass(frozen=True)
class SchedulerConfig:
    """Topology schedule across training: the training networks, switched
    every ``period`` episodes in turn, and the inference network of test
    mode (GraphML paths)."""

    training_network_files: Tuple[str, ...]
    inference_network: str
    period: int = 10

    def __post_init__(self):
        if not self.training_network_files:
            raise ValueError("training_network_files must not be empty")
        if self.period <= 0:
            raise ValueError("period must be positive")


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
