"""The port's canned backend (``DummyEngine``) against the JAX package's.

Through ``ServiceCoordEnv(engine=...)``: the reset and stepped
observations, rewards and info of both envs on the same action (success
ratio 0.8, delay 20 ms, ingress traffic visible, the same reward on a new
episode), the canned counters; then the port's DDPG over the canned
backend: one rollout and a short learn burst with finite losses
(tests/test_dummy_backend.py).

Tolerances: counters exact; observations, rewards and info rtol 1e-5,
atol 1e-5, the bar of tests/test_torch_env.py.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsc_tpu.config.schema import AgentConfig as JAgent
from gsc_tpu.config.schema import EnvLimits as JLimits
from gsc_tpu.config.schema import ServiceConfig as JService
from gsc_tpu.config.schema import ServiceFunction as JSF
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.env import ServiceCoordEnv as JEnv
from gsc_tpu.sim import DummyEngine as JDummy
from gsc_tpu.sim import generate_traffic as j_traffic
from gsc_tpu.topology.compiler import NetworkSpec as JSpec
from gsc_tpu.topology.compiler import compile_topology as j_compile

from gsc_tpu_torch.config.schema import (AgentConfig, EnvLimits,
                                         ServiceConfig, ServiceFunction,
                                         SimConfig)
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.sim import DummyEngine
from gsc_tpu_torch.topology.compiler import NetworkSpec, compile_topology
from test_torch_env import _to_port_traffic
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-5
N, E = 8, 8
SPEC = dict(node_caps=[10.0] * 3, node_types=["Ingress", "Normal", "Normal"],
            edges=[(0, 1, 100.0, 3.0), (1, 2, 100.0, 3.0)])
AGENT = dict(episode_steps=3, objective="prio-flow")


def _build():
    sf = lambda F, n: F(name=n, processing_delay_mean=5.0,
                        processing_delay_stdev=0.0)
    chains = {"sfc_1": ("a", "b", "c")}
    jsvc = JService(sfc_list=chains, sf_list={n: sf(JSF, n) for n in "abc"})
    tsvc = ServiceConfig(sfc_list=chains,
                         sf_list={n: sf(ServiceFunction, n) for n in "abc"})
    lim = dict(max_nodes=N, max_edges=E, num_sfcs=1, max_sfs=3)
    jcfg, tcfg = JSim(ttl_choices=(100.0,)), SimConfig(ttl_choices=(100.0,))
    jenv = JEnv(jsvc, jcfg, JAgent(graph_mode=True, **AGENT),
                JLimits(**lim), engine=JDummy(jsvc, jcfg, JLimits(**lim)))
    tenv = ServiceCoordEnv(tsvc, tcfg, AgentConfig(**AGENT),
                           EnvLimits(**lim),
                           engine=DummyEngine(tsvc, tcfg, EnvLimits(**lim)))
    jtopo = j_compile(JSpec(**SPEC), max_nodes=N, max_edges=E)
    ttopo = compile_topology(NetworkSpec(**SPEC), max_nodes=N, max_edges=E)
    jt = j_traffic(jcfg, jsvc, jtopo, 3, seed=0)
    return jenv, tenv, jtopo, ttopo, jt, _to_port_traffic(jt)


def _close(got, want):
    np.testing.assert_allclose(got.detach().cpu().numpy()[0],
                               np.asarray(want), rtol=RTOL, atol=ATOL)


def test_env_over_dummy_backend_matches_jax():
    jenv, tenv, jtopo, ttopo, jt, tt = _build()
    js, jo = jenv.reset(jax.random.PRNGKey(0), jtopo, jt)
    ts, to = tenv.reset(ttopo, tt, batch=1)
    _close(to.nodes, jo.nodes)
    assert to.nodes.shape == (1, N, 3)
    sched = np.zeros(tenv.limits.scheduling_shape, np.float32)
    sched[:, :, :, 1] = 1.0
    rewards = []
    for _ in range(2):
        js, jo, jr, _, jinfo = jenv.step(js, jtopo, jt,
                                         jnp.asarray(sched.reshape(-1)))
        ts, to, tr, _, tinfo = tenv.step(
            ts, ttopo, tt, torch.from_numpy(sched.reshape(1, -1)))
        _close(to.nodes, jo.nodes)
        _close(tr, jr)
        for k in ("succ_ratio", "avg_e2e_delay"):
            _close(tinfo[k], jinfo[k])
        rewards.append(float(tr[0]))
    assert float(tinfo["succ_ratio"][0]) == pytest.approx(0.8)
    assert float(tinfo["avg_e2e_delay"][0]) == pytest.approx(20.0)
    assert float(to.nodes[0, 0, 0]) > 0.5
    m = ts.sim.metrics
    assert (int(m.generated[0]), int(m.processed[0]), int(m.dropped[0])) \
        == (20, 16, 4)
    assert m.drop_reasons[0].tolist() == [0, 0, 0, 4]
    # a new episode over the canned backend gives the same reward
    ts2, _ = tenv.reset(ttopo, tt, batch=1)
    _, _, tr2, _, _ = tenv.step(ts2, ttopo, tt,
                                torch.from_numpy(sched.reshape(1, -1)))
    assert float(tr2[0]) == pytest.approx(rewards[0])


def test_agent_learns_over_dummy_backend():
    from gsc_tpu_torch.agents.buffer import buffer_sample
    from gsc_tpu_torch.agents.ddpg import DDPG, Draws

    _, tenv, _, ttopo, _, tt = _build()
    agent = dataclasses.replace(tenv.agent, nb_steps_warmup_critic=3,
                                mem_limit=32, batch_size=4, gnn_features=8,
                                actor_hidden_layer_nodes=(16,),
                                critic_hidden_layer_nodes=(16,),
                                gnn_impl="dense")
    tenv.agent = agent
    ddpg = DDPG(tenv, agent, device="cpu")
    draws = Draws(0, "cpu")
    es, obs = tenv.reset(ttopo, tt, batch=1)
    state = ddpg.init_state(torch.Generator().manual_seed(1))
    buf = ddpg.init_buffer(obs.map(lambda x: x[0]))
    state, buf, es, obs, stats = ddpg.rollout_episode(
        state, buf, es, obs, ttopo, tt, 0, draws)
    assert math.isfinite(float(stats["episodic_return"]))
    state, metrics = ddpg.learn_burst(
        state, lambda: buffer_sample(buf, draws, agent.batch_size), steps=3)
    assert math.isfinite(float(metrics["critic_loss"]))
    assert bool(metrics["state_finite"])
