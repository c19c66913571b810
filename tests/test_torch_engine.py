"""The port's ``SimEngine`` against the JAX package's on the engine
scenarios of tests/test_engine.py and a few harder ones, driven directly
with a schedule and a placement (no env): link-capacity, node-capacity,
TTL and unplaced-SF drops, a WRR split, the ``overhead`` resource function
with a startup delay, and arrival overload (more arrivals per substep than
the budget, fewer slots than flows).

Tolerances as in tests/test_torch_env.py: integer and boolean state
exact; float state rtol 1e-5, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsc_tpu.config.schema import EnvLimits as JLimits
from gsc_tpu.config.schema import ServiceConfig as JService
from gsc_tpu.config.schema import ServiceFunction as JSF
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.sim import SimEngine as JEngine
from gsc_tpu.sim.traffic import generate_traffic as j_traffic
from gsc_tpu.topology.compiler import NetworkSpec as JSpec
from gsc_tpu.topology.compiler import compile_topology as j_compile

from gsc_tpu_torch.config.schema import (EnvLimits, ServiceConfig,
                                         ServiceFunction, SimConfig)
from gsc_tpu_torch.sim.engine import SimEngine
from gsc_tpu_torch.topology.compiler import NetworkSpec, compile_topology
from test_torch_env import _compare, _to_port_traffic
from torch_port_helpers import one_torch_thread  # noqa: F401

N, E = 8, 8


def _service(spec):
    j = JService(sfc_list={"sfc_1": tuple(spec)},
                 sf_list={k: JSF(name=k, **v) for k, v in spec.items()})
    t = ServiceConfig(sfc_list={"sfc_1": tuple(spec)},
                      sf_list={k: ServiceFunction(name=k, **v)
                               for k, v in spec.items()})
    return j, t


ABC = {n: dict(processing_delay_mean=5.0, processing_delay_stdev=0.0)
       for n in "abc"}
OVERHEAD = {"a": dict(processing_delay_mean=2.0, processing_delay_stdev=0.0),
            "b": dict(processing_delay_mean=3.0, processing_delay_stdev=0.0,
                      startup_delay=4.0),
            "c": dict(processing_delay_mean=1.0, processing_delay_stdev=0.0,
                      resource_function_id="overhead")}


def _line(node_cap=10.0, link_cap=100.0, link_delay=3.0):
    kw = dict(node_caps=[node_cap] * 3,
              node_types=["Ingress", "Normal", "Normal"],
              edges=[(0, 1, link_cap, link_delay), (1, 2, link_cap, link_delay)])
    return JSpec(**kw), NetworkSpec(**kw)


def _schedule(dsts):
    """Every (node, sfc, sf) row split evenly over ``dsts``."""
    sched = np.zeros((N, 1, 3, N), np.float32)
    sched[:, :, :, list(dsts)] = 1.0 / len(dsts)
    return sched


def _placement(nodes_sfs):
    p = np.zeros((N, 3), bool)
    for n, s in nodes_sfs:
        p[n, s] = True
    return p


ALL_AT_1 = [(1, 0), (1, 1), (1, 2)]
SPLIT = [(n, s) for n in (1, 2) for s in range(3)]

SCENARIOS = {
    "single_flow": dict(service=ABC, line={}, sim={}, dsts=[1],
                        placed=ALL_AT_1),
    "node_cap_drop": dict(service=ABC, line=dict(node_cap=0.5), sim={},
                          dsts=[1], placed=ALL_AT_1),
    "unplaced_sf_drop": dict(service=ABC, line={}, sim={}, dsts=[1],
                             placed=[(1, 0)]),
    "link_cap_drop": dict(service=ABC, line=dict(link_cap=0.5), sim={},
                          dsts=[1], placed=ALL_AT_1),
    "ttl_drop": dict(service=ABC, line={}, sim=dict(ttl_choices=(8.0,)),
                     dsts=[2], placed=[(2, 0), (2, 1), (2, 2)]),
    "wrr_split": dict(service=ABC, line={}, sim=dict(inter_arrival_mean=1.0),
                      dsts=[1, 2], placed=SPLIT),
    "overhead_startup": dict(service=OVERHEAD, line=dict(node_cap=5.0),
                             sim=dict(inter_arrival_mean=2.0), dsts=[1, 2],
                             placed=SPLIT),
    "arrival_overload": dict(service=ABC, line=dict(node_cap=100.0),
                             sim=dict(inter_arrival_mean=0.1, max_flows=16),
                             dsts=[1, 2], placed=SPLIT),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_jax(name):
    sc = SCENARIOS[name]
    jsvc, tsvc = _service(sc["service"])
    jspec, tspec = _line(**sc["line"])
    jsim, tsim = JSim(**sc["sim"]), SimConfig(**sc["sim"])
    jlim = JLimits(max_nodes=N, max_edges=E, num_sfcs=1, max_sfs=3)
    tlim = EnvLimits(max_nodes=N, max_edges=E, num_sfcs=1, max_sfs=3)
    jeng, teng = JEngine(jsvc, jsim, jlim), SimEngine(tsvc, tsim, tlim)
    jt = j_compile(jspec, max_nodes=N, max_edges=E)
    tt = compile_topology(tspec, max_nodes=N, max_edges=E)
    js = j_traffic(jsim, jsvc, jt, 4, seed=0)
    ts = _to_port_traffic(js)
    sched = _schedule(sc["dsts"])
    placed = _placement(sc["placed"])
    jstate = jeng.init(jax.random.PRNGKey(0), jt)
    tstate = teng.init(1, "cpu")
    for i in range(3):
        jstate, _ = jeng.apply(jstate, jt, js, jnp.asarray(sched),
                               jnp.asarray(placed))
        tstate, _ = teng.apply(tstate, tt, ts, torch.from_numpy(sched)[None],
                               torch.from_numpy(placed)[None])
        _compare(jstate.flows, tstate.flows, f"{name}.{i}.flows")
        _compare(jstate.metrics, tstate.metrics, f"{name}.{i}.metrics")
        for f in ("t", "cursor", "node_load", "sf_available", "edge_used",
                  "rel_node", "rel_edge", "truncated_arrivals"):
            _compare(getattr(jstate, f), getattr(tstate, f), f"{name}.{i}.{f}")
    m = tstate.metrics
    assert int(m.generated[0]) > 0
    if name.endswith("_drop") or name == "overhead_startup":
        assert int(m.dropped[0]) > 0
    if name == "arrival_overload":
        assert int(tstate.truncated_arrivals[0]) > 0


def test_noise_from_a_generator():
    """Stochastic processing delays take their normals from outside: drawn
    from a seeded ``torch.Generator`` they make a reproducible interval;
    without noise the engine refuses; deterministic delays need none."""
    spec = {n: dict(processing_delay_mean=4.0, processing_delay_stdev=1.5)
            for n in "abc"}
    _, tsvc = _service(spec)
    _, tspec = _line()
    lim = EnvLimits(max_nodes=N, max_edges=E, num_sfcs=1, max_sfs=3)
    eng = SimEngine(tsvc, SimConfig(inter_arrival_mean=2.0), lim)
    tt = compile_topology(tspec, max_nodes=N, max_edges=E)
    from gsc_tpu_torch.sim.traffic import generate_traffic
    ts = generate_traffic(eng.cfg, tsvc, tt, 4, seed=0)
    sched = torch.from_numpy(_schedule([1, 2]))[None]
    placed = torch.from_numpy(_placement(SPLIT))[None]
    runs = []
    for _ in range(2):
        z = eng.draw_noise(1, torch.Generator().manual_seed(7), "cpu")
        assert z.shape == (1, eng.substeps, eng.M)
        st, m = eng.apply(eng.init(1, "cpu"), tt, ts, sched, placed, noise=z)
        runs.append((st.flows.e2e.clone(), int(m.processed[0])))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1] > 0
    with pytest.raises(ValueError, match="noise"):
        eng.apply(eng.init(1, "cpu"), tt, ts, sched, placed)
    det = SimEngine(_service(ABC)[1], SimConfig(), lim)
    assert det.draw_noise(1, torch.Generator(), "cpu") is None
