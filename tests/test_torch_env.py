"""The port's env (simulator engine, observations, rewards, placement)
against the JAX package's ``ServiceCoordEnv``.

The same topology, TrafficSchedule arrays and processing-delay noise go
into both envs; Abilene is reset and stepped under the uniform schedule,
then under a non-uniform action that exercises ``derive_placement``.

Tolerances: integer state and counters (generated, processed, dropped,
drop reasons, WRR counts, flow phases, ...) and boolean state must be
EXACT.  Float state, observations and rewards: rtol 1e-5, atol 1e-5 —
f32, where the port's scatter-adds and sums may add in another order than
XLA's one-hot contractions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gsc_tpu.config.catalog import abc_service as j_abc
from gsc_tpu.config.schema import (AgentConfig as JAgent, EnvLimits as JLimits,
                                   ServiceConfig as JService,
                                   ServiceFunction as JSF,
                                   SimConfig as JSim)
from gsc_tpu.env.env import ServiceCoordEnv as JEnv
from gsc_tpu.sim.traffic import generate_traffic as j_traffic
from gsc_tpu.topology import synthetic as jsyn
from gsc_tpu.topology.compiler import compile_topology as j_compile

from gsc_tpu_torch.config.schema import (AgentConfig, EnvLimits,
                                         ServiceConfig, ServiceFunction,
                                         SimConfig)
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.serve.run import uniform_schedule_action
from gsc_tpu_torch.sim.state import TrafficSchedule
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import compile_topology
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-5
AGENT_KW = dict(episode_steps=200, objective="prio-flow", target_success="auto")
SIM_KW = dict(inter_arrival_mean=10.0, deterministic_arrival=True,
              flow_dr_mean=1.0, flow_dr_stdev=0.0, flow_size_shape=0.001,
              deterministic_size=True, run_duration=100.0,
              ttl_choices=(100.0,))


def _to_port_traffic(js) -> TrafficSchedule:
    return TrafficSchedule(**{f.name: torch.from_numpy(np.array(getattr(js, f.name)))
                              for f in dataclasses.fields(TrafficSchedule)})


def _compare(jtree, ttree, path=""):
    """Walk the port's dataclass tree; the JAX leaf of the same name must
    match (the port's leaves carry a leading batch dim of 1)."""
    if dataclasses.is_dataclass(ttree):
        for f in dataclasses.fields(ttree):
            _compare(getattr(jtree, f.name), getattr(ttree, f.name),
                     f"{path}.{f.name}")
        return
    a = np.asarray(jtree)
    b = ttree.detach().cpu().numpy()[0]
    assert a.shape == b.shape, f"{path}: {a.shape} vs {b.shape}"
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(b, a, err_msg=path)
    else:
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=path)


def _noise_stream(key, n_substeps, m):
    """The JAX engine's processing-delay normals: one split of the carried
    key per substep, normals of the second half."""
    def body(k, _):
        k, kp = jax.random.split(k)
        return k, jax.random.normal(kp, (m,))
    _, z = jax.lax.scan(body, key, None, length=n_substeps)
    return np.asarray(z)


def _envs(service_j, service_t, sim_kw, max_flows=128):
    jsim = JSim(**sim_kw, max_flows=max_flows)
    tsim = SimConfig(**sim_kw, max_flows=max_flows)
    jagent = JAgent(**AGENT_KW)
    tagent = AgentConfig(**AGENT_KW)
    jl = JLimits.for_service(service_j)
    tl = EnvLimits.for_service(service_t)
    return (JEnv(service_j, jsim, jagent, jl),
            ServiceCoordEnv(service_t, tsim, tagent, tl))


def _run(jenv, tenv, actions, seed=0, noisy=False):
    jt = j_compile(jsyn.abilene())
    tt = compile_topology(synthetic.abilene())
    js = j_traffic(jenv.sim_cfg, jenv.service, jt, 200, seed=seed)
    ts = _to_port_traffic(js)
    key = jax.random.PRNGKey(seed)
    jstate, jobs = jenv.reset(key, jt, js)
    tstate, tobs = tenv.reset(tt, ts, batch=1)
    _compare(jobs, tobs, "obs0")
    steps = tenv.engine.substeps
    noise = (_noise_stream(key, steps * len(actions), tenv.engine.M)
             if noisy else None)
    for i, act in enumerate(actions):
        jstate, jobs, jr, jd, jinfo = jenv.step(jstate, jt, js,
                                                jnp.asarray(act))
        z = (None if noise is None else
             torch.from_numpy(noise[i * steps:(i + 1) * steps])[None])
        tstate, tobs, tr, td, tinfo = tenv.step(
            tstate, tt, ts, torch.from_numpy(act)[None], noise=z)
        _compare(jstate.sim.flows, tstate.sim.flows, f"step{i}.flows")
        _compare(jstate.sim.metrics, tstate.sim.metrics, f"step{i}.metrics")
        for name in ("t", "run_idx", "cursor", "node_load", "sf_available",
                     "sf_startup", "sf_last_active", "placed", "schedule",
                     "edge_used", "rel_node", "rel_edge",
                     "truncated_arrivals"):
            _compare(getattr(jstate.sim, name), getattr(tstate.sim, name),
                     f"step{i}.{name}")
        _compare(jobs, tobs, f"step{i}.obs")
        _compare(jr, tr, f"step{i}.reward")
        _compare(jstate.ewma_flows, tstate.ewma_flows, f"step{i}.ewma")
        assert bool(jd) == bool(td[0])
        for k in ("placement", "succ_ratio", "run_processed", "run_dropped"):
            _compare(jinfo[k], tinfo[k], f"step{i}.info.{k}")
    return jstate, tstate


def _nonuniform_action(env, rng):
    """A random action that the agent-side post-processing thresholds into
    sparse rows, so only some nodes host SFs."""
    raw = rng.uniform(size=env.limits.action_dim).astype(np.float32) ** 4
    return np.array(env.process_action(jnp.asarray(raw)))


def test_env_abilene_uniform_then_nonuniform():
    """Reset + 8 uniform-schedule steps + 1 non-uniform step on Abilene
    with the abc chain (the flagship env, deterministic delays)."""
    jenv, tenv = _envs(j_abc(), _port_abc(), SIM_KW)
    jt = j_compile(jsyn.abilene())
    uni = uniform_schedule_action(tenv.limits, np.asarray(jt.node_mask))
    act = _nonuniform_action(jenv, np.random.default_rng(0))
    jstate, tstate = _run(jenv, tenv, [uni] * 8 + [act])
    m = tstate.sim.metrics
    assert int(m.generated[0]) > 0 and int(m.processed[0]) > 0
    # the non-uniform step placed SFs on fewer nodes than the uniform ones
    assert int(tstate.sim.placed[0].sum()) < 3 * 11


def test_env_stochastic_delays_with_injected_noise():
    """Processing delays |N(mean, stdev)|: the JAX engine's own normals are
    handed to the port as ``noise``; overload (tight node caps, heavy
    arrivals) exercises the admission, TTL and drop paths."""
    sf = lambda n, m, s: dict(name=n, processing_delay_mean=m,
                              processing_delay_stdev=s)
    spec = {"a": sf("a", 5.0, 2.0), "b": sf("b", 3.0, 1.0),
            "c": sf("c", 4.0, 1.5)}
    jsvc = JService(sfc_list={"sfc_1": ("a", "b", "c")},
                    sf_list={k: JSF(**v) for k, v in spec.items()})
    tsvc = ServiceConfig(sfc_list={"sfc_1": ("a", "b", "c")},
                         sf_list={k: ServiceFunction(**v)
                                  for k, v in spec.items()})
    kw = dict(SIM_KW, inter_arrival_mean=2.0, ttl_choices=(30.0,))
    jenv, tenv = _envs(jsvc, tsvc, kw, max_flows=64)
    jt = j_compile(jsyn.abilene())
    uni = uniform_schedule_action(tenv.limits, np.asarray(jt.node_mask))
    act = _nonuniform_action(jenv, np.random.default_rng(1))
    jstate, tstate = _run(jenv, tenv, [uni, act, uni], seed=3, noisy=True)
    reasons = tstate.sim.metrics.drop_reasons[0]
    assert int(reasons.sum()) > 0


def test_env_batched_replicas_match_single():
    """Two replicas in one batch (different topologies' node caps) give the
    same states as two single-replica runs."""
    from gsc_tpu_torch.topology.compiler import stack_topologies

    tenv = _envs(j_abc(), _port_abc(), SIM_KW)[1]
    topos = [compile_topology(synthetic.abilene(seed=s)) for s in (0, 4)]
    ts = _traffic_port(tenv, topos[0])
    uni = torch.from_numpy(uniform_schedule_action(
        tenv.limits, topos[0].node_mask.numpy()))
    singles = []
    for tt in topos:
        st, _ = tenv.reset(tt, ts, batch=1)
        for _ in range(3):
            st, ob, r, _, _ = tenv.step(st, tt, ts, uni[None])
        singles.append((st, ob, r))
    both = stack_topologies(topos)
    st, _ = tenv.reset(both, ts, batch=2)
    for _ in range(3):
        st, ob, r, _, _ = tenv.step(st, both, ts, uni.expand(2, -1))
    for b, (s1, o1, r1) in enumerate(singles):
        torch.testing.assert_close(r[b:b + 1], r1, rtol=0, atol=0)
        torch.testing.assert_close(ob.nodes[b:b + 1], o1.nodes, rtol=0, atol=0)
        assert torch.equal(st.sim.metrics.drop_reasons[b:b + 1],
                           s1.sim.metrics.drop_reasons)
        assert torch.equal(st.sim.flows.phase[b:b + 1], s1.sim.flows.phase)


def _port_abc():
    from gsc_tpu_torch.config import abc_service
    return abc_service()


def _traffic_port(tenv, topo):
    from gsc_tpu_torch.sim.traffic import generate_traffic
    return generate_traffic(tenv.sim_cfg, tenv.service, topo, 200, seed=0)
