"""The port's factored actor and critic heads against the JAX package's,
on the CPU, and the factored learner end to end (training, checkpoints).

Inputs are numpy-seeded graph observations on a small network of the
port's ``random_network`` (12 nodes padded to 16, 2 chains of up to 3
SFs: the mixed catalog's schedule shape, action dim 16 x 2 x 3 x 16 =
1536), GATv2 6 features x 2 layers x 2 iterations, ``factored_key_dim``
4, heads forced on (``factored_head=True``: the automatic switch sits at
16384).  Both sides run ``gnn_impl="pallas"``: the JAX networks reach the
Pallas kernel in interpret mode (its custom VJP for the gradients), the
port's (CPU tensors) the kernel's plain version under autograd.  The flax
parameters are carried across by ``utils.convert``.

Tolerances, with their reasons:

- f32 outputs and parameter gradients: rtol 1e-5, atol 1e-6, as
  tests/test_torch_models.py (f32 with other summation orders);
- bf16 outputs: ``2^-5`` of the largest output, the tolerance
  tests/test_torch_precision.py holds the monolithic bf16 heads to (the
  heads round activations to bf16 between layers; the bilinear products
  take bf16 operands and accumulate in f32 on both sides);
- bf16 parameter gradients of the heads' own layers (``query``, ``key``,
  ``src``, the MLP): ``2^-5`` of each tensor's largest entry, the same
  bound; the embedder's gradients go through the attention gradient,
  where the JAX bf16 VJP rounds its cotangents to bf16 and the port does
  not (tests/test_torch_precision.py), so they are held to ``2^-3`` of
  each tensor's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsc_tpu.config.schema import AgentConfig as JAgent
from gsc_tpu.env.actions import action_mask as j_action_mask
from gsc_tpu.env.observations import GraphObs as JObs
from gsc_tpu.models.nets import Actor as JActor
from gsc_tpu.models.nets import QNetwork as JQ
from gsc_tpu.models.nets import use_factored_head as j_use_factored_head
from gsc_tpu.topology import synthetic as jsyn
from gsc_tpu.topology.compiler import compile_topology as j_compile

from gsc_tpu_torch.agents.ddpg import DDPG
from gsc_tpu_torch.agents.trainer import Trainer
from gsc_tpu_torch.config import mixed_service
from gsc_tpu_torch.config.schema import AgentConfig, EnvLimits, SimConfig
from gsc_tpu_torch.env.driver import EpisodeDriver
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.env.observations import GraphObs
from gsc_tpu_torch.models.nets import (FACTORED_HEAD_THRESHOLD, Actor,
                                       QNetwork, use_factored_head)
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import compile_topology
from gsc_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from gsc_tpu_torch.utils.convert import params_from_jax
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
NET_REL = 2.0 ** -5
EMBEDDER_GRAD_REL = 2.0 ** -3
N, E, C, S = 16, 32, 2, 3
SCHED = (N, C, S, N)
A_DIM = N * C * S * N
KW = dict(gnn_features=6, gnn_num_layers=2, gnn_num_iter=2,
          actor_hidden_layer_nodes=(8,), critic_hidden_layer_nodes=(8,),
          factored_head=True, factored_key_dim=4, gnn_impl="pallas")


def make_obs(batch, seed=0):
    """Numpy-seeded observations on ``random_network(12)`` padded to 16
    nodes / 32 edges: random node features on real nodes, the directed
    edge list and the action mask of 2 chains x 3 positions."""
    topo = j_compile(jsyn.random_network(12, num_ingress=3, seed=4),
                     max_nodes=N, max_edges=E)
    ei, em = topo.directed_edge_index()
    nm = np.asarray(topo.node_mask)
    mask = np.asarray(j_action_mask(topo.node_mask, C, S))
    rng = np.random.default_rng(seed)
    nodes = rng.uniform(size=(batch, N, 3)).astype(np.float32) * nm[:, None]
    rep = lambda x: np.broadcast_to(np.asarray(x),
                                    (batch,) + np.shape(x)).copy()
    return dict(nodes=nodes, node_mask=rep(nm), edge_index=rep(ei),
                edge_mask=rep(em), mask=rep(mask))


def _jobs(o):
    return JObs(**o)


def _tobs(o):
    return GraphObs(**{k: torch.from_numpy(v) for k, v in o.items()})


def _nets(precision):
    """JAX and port actor and critic with the same (converted) params."""
    kw = dict(KW, precision=precision)
    jagent, tagent = JAgent(**kw), AgentConfig(**kw)
    obs = _jobs(make_obs(2))
    act = jnp.asarray(np.random.default_rng(9).uniform(
        size=(2, A_DIM)).astype(np.float32))
    jactor = JActor(agent=jagent, action_dim=A_DIM, gnn_impl="pallas",
                    sched_shape=SCHED)
    jq = JQ(agent=jagent, gnn_impl="pallas", action_dim=A_DIM,
            sched_shape=SCHED)
    aparams = jax.device_get(jactor.init(jax.random.PRNGKey(1), obs))
    qparams = jax.device_get(jq.init(jax.random.PRNGKey(2), obs, act))
    tactor = Actor(tagent, A_DIM, gnn_impl="pallas", sched_shape=SCHED)
    tq = QNetwork(tagent, A_DIM, gnn_impl="pallas", sched_shape=SCHED)
    tactor.load_state_dict(params_from_jax(aparams, tactor))
    tq.load_state_dict(params_from_jax(qparams, tq))
    return jactor, aparams, tactor, jq, qparams, tq


def _inputs(batch=3, seed=5):
    obs = make_obs(batch, seed=seed)
    rng = np.random.default_rng(seed + 1)
    act = rng.uniform(size=(batch, A_DIM)).astype(np.float32)
    # cotangents of the outputs, so that every parameter gets a gradient
    w_a = rng.normal(size=(batch, A_DIM)).astype(np.float32)
    w_q = rng.normal(size=(batch, 1)).astype(np.float32)
    return obs, act, w_a, w_q


def _close(got, want, precision, what, rel=NET_REL):
    assert got.shape == want.shape, what
    if precision == "f32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    else:
        err = float(np.abs(got - want).max())
        assert err <= rel * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_factored_actor_and_critic_match_flax(precision):
    jactor, aparams, tactor, jq, qparams, tq = _nets(precision)
    assert tactor.factored and tq.factored
    obs, act, _, _ = _inputs()
    with torch.no_grad():
        out = tactor(_tobs(obs))
        q = tq(_tobs(obs), torch.from_numpy(act))
    assert out.dtype == q.dtype == torch.float32
    _close(out.numpy(), np.asarray(jactor.apply(aparams, _jobs(obs))),
           precision, "actor")
    _close(q.numpy(), np.asarray(jq.apply(qparams, _jobs(obs),
                                          jnp.asarray(act))),
           precision, "critic")
    # padded (src, dst) entries are exactly zero
    assert not out.numpy()[obs["mask"] == 0].any()
    # the heads' parameters, named as in flax
    names = {k.split(".")[0] for k in tactor.state_dict()}
    assert names == {"embedder", "mlp", "query", "key"}
    assert {k.split(".")[0] for k in tq.state_dict()} == \
        {"embedder", "key", "src", "mlp"}
    for net in (tactor, tq):
        assert all(p.dtype == torch.float32 for p in net.parameters())


def _grads_match(net, jgrads, precision, what):
    want = params_from_jax(jgrads, net)
    for name, p in net.named_parameters():
        got, ref = p.grad.numpy(), want[name].numpy()
        rel = (EMBEDDER_GRAD_REL if name.startswith("embedder.")
               else NET_REL)
        _close(got, ref, precision, f"{what} d{name}", rel=rel)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_factored_parameter_gradients_match_flax(precision):
    jactor, aparams, tactor, jq, qparams, tq = _nets(precision)
    obs, act, w_a, w_q = _inputs()
    jobs = _jobs(obs)
    ga = jax.grad(lambda p: jnp.sum(jactor.apply(p, jobs) * w_a))(aparams)
    gq = jax.grad(lambda p: jnp.sum(
        jq.apply(p, jobs, jnp.asarray(act)) * w_q))(qparams)
    (tactor(_tobs(obs)) * torch.from_numpy(w_a)).sum().backward()
    (tq(_tobs(obs), torch.from_numpy(act))
     * torch.from_numpy(w_q)).sum().backward()
    _grads_match(tactor, jax.device_get(ga), precision, "actor")
    _grads_match(tq, jax.device_get(gq), precision, "critic")


@pytest.mark.parametrize("factored,graph_mode,dim", [
    (None, True, FACTORED_HEAD_THRESHOLD - 1),
    (None, True, FACTORED_HEAD_THRESHOLD),
    (True, True, 8), (False, True, 10 ** 6), (None, False, 10 ** 6)])
def test_use_factored_head_matches_jax(factored, graph_mode, dim):
    want = j_use_factored_head(JAgent(factored_head=factored,
                                      graph_mode=graph_mode), dim)
    # the port's AgentConfig refuses flat mode; the rule still reads it
    agent = AgentConfig(factored_head=factored)
    object.__setattr__(agent, "graph_mode", graph_mode)
    assert use_factored_head(agent, dim) == want


def test_factored_head_needs_a_schedule_shape():
    agent = AgentConfig(**KW)
    with pytest.raises(ValueError, match="sched_shape"):
        Actor(agent, A_DIM)
    with pytest.raises(ValueError, match="does not factor"):
        QNetwork(agent, A_DIM, sched_shape=(N, C, S, N - 1))
    # interroute's action dim (128 x 1 x 3 x 128) switches by default
    auto = AgentConfig(gnn_features=6)
    assert use_factored_head(auto, 128 * 1 * 3 * 128)
    assert Actor(auto, 128 * 3 * 128,
                 sched_shape=(128, 1, 3, 128)).factored


def _stack(agent_kw, seed=0):
    """A tiny single-env trainer on ``random_network(6)`` padded to 8 nodes
    under the mixed catalog, heads forced factored."""
    service = mixed_service()
    agent = AgentConfig(**{**KW, **agent_kw})
    sim = SimConfig(inter_arrival_mean=2.0, run_duration=10.0,
                    ttl_choices=(100.0,), max_flows=32)
    limits = EnvLimits.for_service(service, max_nodes=8, max_edges=12)
    env = ServiceCoordEnv(service, sim, agent, limits)
    topo = compile_topology(synthetic.random_network(6, num_ingress=2,
                                                     seed=1),
                            max_nodes=8, max_edges=12)
    driver = EpisodeDriver.single(topo, sim, service, agent.episode_steps,
                                  "random6", base_seed=seed)
    return env, agent, driver


def test_factored_trainer_smoke(tmp_path):
    """End-to-end rollout + learn with the factored heads (the interroute
    and rung-5 path, forced on at toy size), as tests/test_agent.py's
    test_trainer_smoke_factored_head does for the JAX package."""
    env, agent, driver = _stack(dict(
        episode_steps=4, batch_size=4, mem_limit=8,
        nb_steps_warmup_critic=2, gnn_num_layers=1, gnn_num_iter=1,
        objective="prio-flow"))
    trainer = Trainer(env, driver, agent, seed=0, result_dir=str(tmp_path),
                      device="cpu")
    assert trainer.ddpg.actor.factored and trainer.ddpg.critic.factored
    state, _ = trainer.train(episodes=2)
    assert len(trainer.history) == 2
    assert np.isfinite(trainer.history[-1]["critic_loss"])
    result = trainer.evaluate(state, episodes=1)
    assert np.isfinite(result["mean_return"])


def test_factored_checkpoint_round_trips(tmp_path):
    """A factored learner state (query, key, src and the per-node stacks)
    saves and restores bit for bit."""
    env, agent, _ = _stack(dict(episode_steps=2))
    ddpg = DDPG(env, agent, device="cpu")
    state = ddpg.init_state(torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path / "ck"), state)
    fresh = DDPG(env, agent, device="cpu").init_state(
        torch.Generator().manual_seed(1))
    assert not torch.equal(fresh.actor.query.weight, state.actor.query.weight)
    load_checkpoint(path, fresh)
    for net in ("actor", "critic", "target_actor", "target_critic"):
        got = getattr(fresh, net).state_dict()
        want = getattr(state, net).state_dict()
        assert set(got) == set(want)
        assert {k.split(".")[0] for k in got} >= {"key"}
        for k in want:
            assert torch.equal(got[k], want[k]), (net, k)
