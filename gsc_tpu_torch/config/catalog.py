"""Canonical service catalogs."""
from __future__ import annotations

from .schema import AgentConfig, ServiceConfig, ServiceFunction, SimConfig


def abc_service() -> ServiceConfig:
    """The abc chain: a->b->c, 5 ms deterministic processing each."""
    sf = lambda n: ServiceFunction(name=n, processing_delay_mean=5.0,
                                   processing_delay_stdev=0.0)
    return ServiceConfig(sfc_list={"sfc_1": ("a", "b", "c")},
                         sf_list={n: sf(n) for n in "abc"})


def mixed_service() -> ServiceConfig:
    """The mixed SFC catalog of bench.py's rung-5 stack: two chains over a
    shared 5-SF pool, abc (3 x 5 ms) and de (8 ms, then 2 ms)."""
    mk = lambda n, d: ServiceFunction(name=n, processing_delay_mean=d,
                                      processing_delay_stdev=0.0)
    return ServiceConfig(
        sfc_list={"sfc_1": ("a", "b", "c"), "sfc_2": ("d", "e")},
        sf_list={"a": mk("a", 5.0), "b": mk("b", 5.0), "c": mk("c", 5.0),
                 "d": mk("d", 8.0), "e": mk("e", 2.0)})


def init_configs_agent(**overrides) -> AgentConfig:
    """The agent of ``gsc_tpu.cli init-configs``' agent.yaml (the flagship
    widths: GATv2 22 features, 2 layers, 2 iterations, mean aggregation,
    actor hidden (256,))."""
    kw = dict(
        observation_space=("ingress_traffic", "node_load", "node_cap"),
        graph_mode=True, episode_steps=200, objective="prio-flow",
        target_success="auto", gnn_features=22, gnn_num_layers=2,
        gnn_num_iter=2, gnn_aggr="mean", actor_hidden_layer_nodes=(256,))
    kw.update(overrides)
    return AgentConfig(**kw)


def init_configs_sim(**overrides) -> SimConfig:
    """The simulator of ``init-configs``' simulator.yaml: deterministic
    arrivals every 10 ms per ingress, dr 1, size 0.001, 100 ms intervals,
    TTL 100."""
    kw = dict(inter_arrival_mean=10.0, deterministic_arrival=True,
              flow_dr_mean=1.0, flow_dr_stdev=0.0, flow_size_shape=0.001,
              deterministic_size=True, run_duration=100.0,
              ttl_choices=(100.0,))
    kw.update(overrides)
    return SimConfig(**kw)
