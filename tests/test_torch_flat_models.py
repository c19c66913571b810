"""Flat mode (``graph_mode: false``): the port's flat observation, its
``shuffle_nodes`` ops and its MLP actor and critic against the JAX
package's, on the CPU.

Inputs are numpy-seeded or taken from the JAX env's simulator state on
Abilene (24 nodes padded, the abc chain: observation 24 x 3 = 72 floats,
action 24 x 1 x 3 x 24 = 1,728) at the flagship widths (actor hidden
(256,), critic hidden (64,)) and at a small one.  The flax parameters are
carried across by ``utils.convert``.

Tolerances, with their reasons:

- ``flat_obs`` and ``obs_dim`` on the same simulator state: byte-equal
  (the same f32 operations on the same values); the flat observation
  the port's env makes while it steps with the JAX env: rtol 1e-5,
  atol 1e-5 (the engine's tolerance, tests/test_torch_env.py);
- ``permute_obs``, ``step_mask`` and ``env_action``, shuffling on and
  off: exact (the ops move values);
- f32 outputs: rtol 1e-5, atol 1e-6 (f32 in another summation order,
  as tests/test_torch_models.py); f32 parameter gradients: within rtol
  1e-5 of the tensor's largest entry plus atol 1e-6.  A gradient entry
  of the first layer sums 1,728 output cotangents through the layers
  above, terms of the size of the tensor's largest entries, so an entry
  that cancels to near zero carries their rounding (measured: 6.3e-6 on
  an entry of 4.8e-3 whose tensor reaches 4.5; chip_smoke.py and
  tests/test_torch_gat_backward.py hold gradients the same way);
- bf16 outputs and parameter gradients: ``2^-5`` of the largest entry
  (of each tensor for gradients), the tolerance
  tests/test_torch_precision.py holds the bf16 heads to: both sides
  round activations to bf16 between layers and sum products in f32 in
  other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsc_tpu.config.catalog import abc_service as j_abc
from gsc_tpu.config.schema import AgentConfig as JAgent
from gsc_tpu.config.schema import EnvLimits as JLimits
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.env.actions import action_mask as j_action_mask
from gsc_tpu.env.env import ServiceCoordEnv as JEnv
from gsc_tpu.env.observations import flat_obs as j_flat_obs
from gsc_tpu.env.permutation import ShuffleOps as JShuffle
from gsc_tpu.models.nets import Actor as JActor
from gsc_tpu.models.nets import QNetwork as JQ
from gsc_tpu.sim.traffic import generate_traffic as j_traffic
from gsc_tpu.topology import synthetic as jsyn
from gsc_tpu.topology.compiler import compile_topology as j_compile

from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import AgentConfig, EnvLimits, SimConfig
from gsc_tpu_torch.env.actions import action_mask
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.env.observations import flat_obs, obs_map
from gsc_tpu_torch.env.permutation import ShuffleOps
from gsc_tpu_torch.models.nets import Actor, QNetwork
from gsc_tpu_torch.sim.state import SimMetrics, TrafficSchedule
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import compile_topology
from gsc_tpu_torch.utils.convert import params_from_jax
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
ENV_RTOL = ENV_ATOL = 1e-5
NET_REL = 2.0 ** -5
N, OBS, A_DIM = 24, 72, 1728
SIM_KW = dict(inter_arrival_mean=10.0, deterministic_arrival=True,
              flow_dr_mean=1.0, flow_dr_stdev=0.0, flow_size_shape=0.001,
              deterministic_size=True, run_duration=100.0,
              ttl_choices=(100.0,))
WIDTHS = {"small": dict(actor_hidden_layer_nodes=(16,),
                        critic_hidden_layer_nodes=(8,)),
          "flagship": dict(actor_hidden_layer_nodes=(256,),
                           critic_hidden_layer_nodes=(64,))}
AGENT_KW = dict(graph_mode=False, episode_steps=200, objective="prio-flow",
                target_success="auto")


def _envs(**kw):
    agent = dict(AGENT_KW, **kw)
    jenv = JEnv(j_abc(), JSim(**SIM_KW), JAgent(**agent),
                JLimits.for_service(j_abc()))
    tenv = ServiceCoordEnv(abc_service(), SimConfig(**SIM_KW),
                           AgentConfig(**agent),
                           EnvLimits.for_service(abc_service()))
    return jenv, tenv


def _port_metrics(jm) -> SimMetrics:
    return SimMetrics(**{f.name: torch.from_numpy(np.array(getattr(
        jm, f.name))) for f in dataclasses.fields(SimMetrics)})


def _states(jenv, steps=3):
    """The JAX env's simulator states over ``steps`` env steps of a
    seeded non-uniform action on Abilene, with each interval's
    capacities."""
    jt = j_compile(jsyn.abilene())
    js = j_traffic(jenv.sim_cfg, jenv.service, jt, 200, seed=3)
    state, _ = jenv.reset(jax.random.PRNGKey(0), jt, js)
    rng = np.random.default_rng(7)
    out = []
    for _ in range(steps + 1):
        idx = int(np.clip(np.asarray(state.sim.run_idx), 0,
                          js.node_cap.shape[0] - 1))
        out.append((state.sim.metrics, js.node_cap[idx]))
        raw = rng.uniform(size=jenv.limits.action_dim).astype(np.float32)
        act = jenv.process_action(jnp.asarray(raw ** 4))
        state, *_ = jenv.step(state, jt, js, act)
    return jt, js, out


@pytest.mark.parametrize("override", [False, True],
                         ids=["observed", "ingress_override"])
def test_flat_obs_and_obs_dim_byte_equal(override):
    jenv, tenv = _envs()
    jt, _, states = _states(jenv)
    tt = compile_topology(synthetic.abilene())
    space = tenv.agent.observation_space
    chain_sf = tenv.tables.chain_sf
    assert tenv.obs_dim() == jenv.obs_dim() == OBS
    ing = (np.random.default_rng(1).uniform(size=N).astype(np.float32)
           if override else None)
    for k, (jm, cap) in enumerate(states):
        want = np.asarray(j_flat_obs(
            jm, jt, cap, jenv.tables.chain_sf, space,
            ingress_override=None if ing is None else jnp.asarray(ing)))
        got = flat_obs(_port_metrics(jm), tt, torch.from_numpy(
            np.array(cap)), chain_sf, space,
            ingress_override=None if ing is None else torch.from_numpy(ing))
        assert got.shape == (OBS,) and got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), f"state {k}"
        # with a leading batch dim: the same rows
        batched = flat_obs(_port_metrics(jm).map(lambda x: x[None]),
                           tt.expand(1), torch.from_numpy(np.array(cap))[None],
                           chain_sf, space, ingress_override=None if ing is None
                           else torch.from_numpy(ing)[None])
        assert batched.shape == (1, OBS)
        assert batched[0].numpy().tobytes() == want.tobytes()


def test_env_flat_obs_follows_the_jax_env():
    """reset and step of both envs in flat mode on the same traffic and
    actions: the observations agree within the engine's tolerance."""
    jenv, tenv = _envs()
    jt = j_compile(jsyn.abilene())
    tt = compile_topology(synthetic.abilene())
    js = j_traffic(jenv.sim_cfg, jenv.service, jt, 200, seed=3)
    ts = TrafficSchedule(**{f.name: torch.from_numpy(np.array(
        getattr(js, f.name))) for f in dataclasses.fields(TrafficSchedule)})
    jstate, jobs = jenv.reset(jax.random.PRNGKey(0), jt, js)
    tstate, tobs = tenv.reset(tt, ts, batch=1)
    rng = np.random.default_rng(7)
    for i in range(4):
        assert tuple(tobs.shape) == (1, OBS) and np.asarray(jobs).shape == \
            (OBS,)
        np.testing.assert_allclose(tobs[0].numpy(), np.asarray(jobs),
                                   rtol=ENV_RTOL, atol=ENV_ATOL,
                                   err_msg=f"step {i}")
        raw = rng.uniform(size=jenv.limits.action_dim).astype(np.float32)
        act = np.array(jenv.process_action(jnp.asarray(raw ** 4)))
        jstate, jobs, *_ = jenv.step(jstate, jt, js, jnp.asarray(act))
        tstate, tobs, *_ = tenv.step(tstate, tt, ts,
                                     torch.from_numpy(act)[None])


@pytest.mark.parametrize("shuffle", [False, True], ids=["off", "on"])
def test_shuffle_ops_flat_match_jax(shuffle):
    """permute_obs, step_mask and env_action on flat observations, one
    permutation per replica, against the JAX ops replica by replica."""
    b = 3
    kw = dict(AGENT_KW, shuffle_nodes=shuffle)
    limits = EnvLimits.for_service(abc_service())
    jops = JShuffle(JAgent(**kw), JLimits.for_service(j_abc()))
    tops = ShuffleOps(AgentConfig(**kw), limits)
    rng = np.random.default_rng(11)
    perm = np.stack([rng.permutation(N) for _ in range(b)])
    if not shuffle:
        perm = np.broadcast_to(np.arange(N), (b, N)).copy()
    obs = rng.uniform(size=(b, OBS)).astype(np.float32)
    node_mask = np.zeros((b, N), bool)
    node_mask[:, :11] = True
    node_mask[1, 11:14] = True
    mask = np.stack([np.asarray(j_action_mask(jnp.asarray(m), 1, 3))
                     for m in node_mask])
    act = rng.uniform(size=(b, A_DIM)).astype(np.float32)
    t_perm = torch.from_numpy(perm)
    got_obs = tops.permute_obs(torch.from_numpy(obs), t_perm)
    got_mask = tops.step_mask(got_obs, action_mask(
        torch.from_numpy(node_mask), 1, 3), t_perm)
    got_act = tops.env_action(torch.from_numpy(act), t_perm)
    for r in range(b):
        p = jnp.asarray(perm[r])
        want_obs = np.asarray(jops.permute_obs(jnp.asarray(obs[r]), p))
        np.testing.assert_array_equal(got_obs[r].numpy(), want_obs)
        np.testing.assert_array_equal(got_mask[r].numpy(), np.asarray(
            jops.step_mask(jnp.asarray(want_obs), jnp.asarray(mask[r]), p)))
        np.testing.assert_array_equal(got_act[r].numpy(), np.asarray(
            jops.env_action(jnp.asarray(act[r]), p)))
    if shuffle:
        assert not np.array_equal(got_obs.numpy(), obs)


def _nets(width, precision):
    kw = dict(AGENT_KW, **WIDTHS[width], precision=precision)
    jagent, tagent = JAgent(**kw), AgentConfig(**kw)
    rng = np.random.default_rng(2)
    obs = jnp.asarray(rng.uniform(size=(2, OBS)).astype(np.float32))
    act = jnp.asarray(rng.uniform(size=(2, A_DIM)).astype(np.float32))
    jactor = JActor(agent=jagent, action_dim=A_DIM)
    jq = JQ(agent=jagent, action_dim=A_DIM)
    aparams = jax.device_get(jactor.init(jax.random.PRNGKey(1), obs))
    qparams = jax.device_get(jq.init(jax.random.PRNGKey(2), obs, act))
    tactor = Actor(tagent, A_DIM, obs_dim=OBS)
    tq = QNetwork(tagent, A_DIM, obs_dim=OBS)
    tactor.load_state_dict(params_from_jax(aparams, tactor))
    tq.load_state_dict(params_from_jax(qparams, tq))
    return jactor, aparams, tactor, jq, qparams, tq


def _inputs(batch=5, seed=5):
    rng = np.random.default_rng(seed)
    obs = rng.uniform(size=(batch, OBS)).astype(np.float32)
    act = rng.uniform(size=(batch, A_DIM)).astype(np.float32)
    w_a = rng.normal(size=(batch, A_DIM)).astype(np.float32)
    w_q = rng.normal(size=(batch, 1)).astype(np.float32)
    return obs, act, w_a, w_q


def _close(got, want, precision, what, per_tensor=False):
    assert got.shape == want.shape, what
    if precision == "f32" and per_tensor:
        err = float(np.abs(got - want).max())
        assert err <= RTOL * float(np.abs(want).max()) + ATOL, (what, err)
    elif precision == "f32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    else:
        err = float(np.abs(got - want).max())
        assert err <= NET_REL * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("width", ["small", "flagship"])
def test_flat_actor_and_critic_match_flax(width, precision):
    jactor, aparams, tactor, jq, qparams, tq = _nets(width, precision)
    obs, act, _, _ = _inputs()
    with torch.no_grad():
        out = tactor(torch.from_numpy(obs))
        q = tq(torch.from_numpy(obs), torch.from_numpy(act))
    assert out.dtype == q.dtype == torch.float32
    assert out.shape == (5, A_DIM) and q.shape == (5, 1)
    _close(out.numpy(), np.asarray(jactor.apply(aparams, jnp.asarray(obs))),
           precision, "actor")
    _close(q.numpy(), np.asarray(jq.apply(qparams, jnp.asarray(obs),
                                          jnp.asarray(act))),
           precision, "critic")
    # no mask multiply in flat mode, no embedder, f32 masters
    assert {k.split(".")[0] for k in tactor.state_dict()} == {"mlp"}
    assert {k.split(".")[0] for k in tq.state_dict()} == {"mlp"}
    assert len(tactor.mlp.layers) == len(WIDTHS[width][
        "actor_hidden_layer_nodes"]) + 1
    for net in (tactor, tq):
        assert all(p.dtype == torch.float32 for p in net.parameters())


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("width", ["small", "flagship"])
def test_flat_parameter_gradients_match_flax(width, precision):
    jactor, aparams, tactor, jq, qparams, tq = _nets(width, precision)
    obs, act, w_a, w_q = _inputs()
    jo, ja = jnp.asarray(obs), jnp.asarray(act)
    ga = jax.grad(lambda p: jnp.sum(jactor.apply(p, jo) * w_a))(aparams)
    gq = jax.grad(lambda p: jnp.sum(jq.apply(p, jo, ja) * w_q))(qparams)
    (tactor(torch.from_numpy(obs)) * torch.from_numpy(w_a)).sum().backward()
    (tq(torch.from_numpy(obs), torch.from_numpy(act))
     * torch.from_numpy(w_q)).sum().backward()
    for net, jgrads, what in ((tactor, ga, "actor"), (tq, gq, "critic")):
        want = params_from_jax(jax.device_get(jgrads), net)
        for name, p in net.named_parameters():
            _close(p.grad.numpy(), want[name].numpy(), precision,
                   f"{what} d{name}", per_tensor=True)


def test_bf16_critic_takes_a_bf16_replayed_observation():
    """A replayed bf16 observation makes the critic cast the action to
    bf16 before the join, as the JAX critic does."""
    jactor, aparams, tactor, jq, qparams, tq = _nets("small", "bf16")
    obs, act, _, _ = _inputs()
    ob16 = torch.from_numpy(obs).bfloat16()
    with torch.no_grad():
        q = tq(ob16, torch.from_numpy(act))
    want = np.asarray(jq.apply(qparams, jnp.asarray(obs, jnp.bfloat16),
                               jnp.asarray(act)))
    assert q.dtype == torch.float32
    _close(q.numpy(), want, "bf16", "critic on bf16 obs")


def test_flat_mode_networks():
    """tests/test_models.py's flat-mode shapes: an actor over [4, 24]
    observations gives [4, 10], the critic [4, 1]."""
    agent = AgentConfig(graph_mode=False)
    obs = torch.ones((4, 24))
    actor = Actor(agent, 10, obs_dim=24)
    actor.reset_parameters(torch.Generator().manual_seed(0))
    assert actor(obs).shape == (4, 10)
    q = QNetwork(agent, 10, obs_dim=24)
    q.reset_parameters(torch.Generator().manual_seed(0))
    assert q(obs, torch.ones((4, 10))).shape == (4, 1)
    with pytest.raises(ValueError, match="needs obs_dim"):
        Actor(agent, 10)


def test_obs_map_either_mode():
    jenv, tenv = _envs()
    tt = compile_topology(synthetic.abilene())
    jt = j_compile(jsyn.abilene())
    js = j_traffic(jenv.sim_cfg, jenv.service, jt, 200, seed=3)
    ts = TrafficSchedule(**{f.name: torch.from_numpy(np.array(
        getattr(js, f.name))) for f in dataclasses.fields(TrafficSchedule)})
    _, flat = tenv.reset(tt, ts, batch=2)
    assert obs_map(flat, lambda x: x[0]).shape == (OBS,)
    _, genv = _envs(graph_mode=True)
    _, graph = genv.reset(tt, ts, batch=2)
    one = obs_map(graph, lambda x: x[0])
    assert one.nodes.shape == (N, 3) and one.mask.shape == (A_DIM,)
