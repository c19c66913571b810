"""The port's training path against the JAX package's, at a small size.

A triangle padded to 8 nodes / 8 edges, the abc chain, 10 ms intervals
(10 substeps), GATv2 4 features x 1 layer x 1 iteration, actor and critic
hidden (8,), B = 2 replicas, 4-step episodes in chunks of 2, batch 4,
replay 6 (3 slots per replica, so the rings wrap), 2 warm-up steps.
Parameters start equal on both sides: the port loads the JAX learner
state through ``gsc_tpu_torch.utils.convert``.  Random draws come from
the JAX side: the test replays the keys the JAX functions split and feeds
the numbers they draw (warm-up uniforms, exploration normals, replay
indices) to the port through its ``Draws`` interface.

Tolerances:
- Q values, losses and gradients rtol 1e-5, atol 1e-6 (f32 in another
  summation order);
- replay contents: integers and booleans exact, floats rtol 1e-5, atol
  1e-5 (the engine's tolerance, tests/test_torch_env.py);
- learner state after Adam steps and Polyak averaging rtol 1e-4, atol
  1e-6: Adam divides by sqrt(v) + eps, and in the first steps v is of
  the order of g^2, so f32 rounding differences of the gradients (1e-7
  relative) come out of the division enlarged by up to ~1e2.
- after the episode's 4-step learn burst on replayed env transitions,
  rtol 1e-4, atol 8e-5.  There some gradient entries are exactly zero in
  exact arithmetic (a float64 run of the port gives 2e-19) and come out
  of f32 as rounding residues r of up to ~1e-10 that differ between the
  frameworks; Adam turns each into a step of lr * r / (r + eps), up to
  ~1e-2 lr = 1e-5 per step on each side, so 4 steps may part the two
  sides by 8e-5.  Measured: 2.3e-5 on one entry of the critic's encoder,
  where the port's float64 run lies 3.2e-5 from JAX's f32 and closer to
  the port's f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsc_tpu.agents.buffer import buffer_add as j_buffer_add
from gsc_tpu.agents.buffer import buffer_init as j_buffer_init
from gsc_tpu.agents.ddpg import DDPG as JDDPG
from gsc_tpu.config.catalog import abc_service as j_abc
from gsc_tpu.config.schema import AgentConfig as JAgent
from gsc_tpu.config.schema import EnvLimits as JLimits
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.env.env import ServiceCoordEnv as JEnv
from gsc_tpu.env.observations import GraphObs as JObs
from gsc_tpu.models.nets import QNetwork as JQ
from gsc_tpu.parallel.dp import ParallelDDPG as JParallel
from gsc_tpu.sim.traffic import generate_traffic as j_traffic
from gsc_tpu.topology import synthetic as jsyn
from gsc_tpu.topology.compiler import compile_topology as j_compile

from gsc_tpu_torch.agents.buffer import buffer_add, buffer_init
from gsc_tpu_torch.agents.ddpg import DDPG, Draws
from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import AgentConfig, EnvLimits, SimConfig
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.env.observations import GraphObs
from gsc_tpu_torch.models.nets import QNetwork
from gsc_tpu_torch.parallel.dp import ParallelDDPG
from gsc_tpu_torch.sim.state import TrafficSchedule
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import compile_topology
from gsc_tpu_torch.utils.convert import (learner_state_from_jax,
                                         params_from_jax)
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
REPLAY_RTOL = REPLAY_ATOL = 1e-5
STATE_RTOL, STATE_ATOL = 1e-4, 1e-6
BURST_ATOL = 8e-5
N, E, B = 8, 8, 2
AGENT_KW = dict(episode_steps=4, gnn_features=4, gnn_num_layers=1,
                gnn_num_iter=1, actor_hidden_layer_nodes=(8,),
                critic_hidden_layer_nodes=(8,), batch_size=4, mem_limit=6,
                nb_steps_warmup_critic=2, objective="prio-flow",
                target_success="auto")
SIM_KW = dict(inter_arrival_mean=2.0, run_duration=10.0,
              ttl_choices=(100.0,))
CHUNK = 2


def _envs(gnn_impl="pallas"):
    jagent = JAgent(**AGENT_KW, gnn_impl=gnn_impl)
    tagent = AgentConfig(**AGENT_KW, gnn_impl=gnn_impl)
    jlim = JLimits.for_service(j_abc(), max_nodes=N, max_edges=E)
    tlim = EnvLimits.for_service(abc_service(), max_nodes=N, max_edges=E)
    jenv = JEnv(j_abc(), JSim(**SIM_KW), jagent, jlim)
    tenv = ServiceCoordEnv(abc_service(), SimConfig(**SIM_KW), tagent, tlim)
    return jenv, tenv


def _topos():
    kw = dict(node_caps=(2.0, 3.0, 2.0), num_ingress=2)
    return (j_compile(jsyn.triangle(**kw), max_nodes=N, max_edges=E),
            compile_topology(synthetic.triangle(**kw), max_nodes=N,
                             max_edges=E))


def _obs(batch, seed):
    """Numpy-seeded observations on the triangle's padded graph."""
    jtopo, _ = _topos()
    ei, em = jtopo.directed_edge_index()
    nm = np.asarray(jtopo.node_mask)
    from gsc_tpu.env.actions import action_mask
    mask = np.asarray(action_mask(jtopo.node_mask, 1, 3))
    rng = np.random.default_rng(seed)
    nodes = rng.uniform(size=(batch, N, 3)).astype(np.float32) * nm[:, None]
    rep = lambda x: np.broadcast_to(np.asarray(x),
                                    (batch,) + np.shape(x)).copy()
    return dict(nodes=nodes, node_mask=rep(nm), edge_index=rep(ei),
                edge_mask=rep(em), mask=rep(mask))


def _tobs(o):
    return GraphObs(**{k: torch.from_numpy(np.asarray(v)) for k, v in o.items()})


def _jobs(o):
    return JObs(**{k: jnp.asarray(v) for k, v in o.items()})


def _batch(seed, size=4):
    rng = np.random.default_rng(seed)
    a_dim = N * 3 * N
    return {"obs": _obs(size, seed), "next_obs": _obs(size, seed + 1),
            "action": rng.uniform(size=(size, a_dim)).astype(np.float32),
            "reward": rng.normal(size=size).astype(np.float32),
            "done": (rng.uniform(size=size) < 0.3).astype(np.float32)}


def _jbatch(b):
    return {k: (_jobs(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in b.items()}


def _tbatch(b):
    return {k: (_tobs(v) if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in b.items()}


def _state_tree(s):
    """A JAX DDPGState as numpy dicts for ``learner_state_from_jax``."""
    g = jax.device_get
    adam = lambda o: {"count": g(o[0].count), "mu": g(o[0].mu),
                      "nu": g(o[0].nu)}
    return {"actor_params": g(s.actor_params),
            "critic_params": g(s.critic_params),
            "target_actor_params": g(s.target_actor_params),
            "target_critic_params": g(s.target_critic_params),
            "actor_opt": adam(s.actor_opt), "critic_opt": adam(s.critic_opt)}


def _learners(gnn_impl="pallas"):
    jenv, tenv = _envs(gnn_impl)
    jd = JDDPG(jenv, jenv.agent)
    td = DDPG(tenv, tenv.agent, device="cpu")
    one = {k: v[0] for k, v in _obs(1, 0).items()}
    jstate = jd.init(jax.random.PRNGKey(3), _jobs(one))
    tstate = td.init_state(torch.Generator().manual_seed(0))
    learner_state_from_jax(_state_tree(jstate), tstate)
    return jd, td, jstate, tstate


def _assert_state(jstate, tstate, rtol, atol, what=""):
    tree = _state_tree(jstate)
    for key, net in (("actor_params", tstate.actor),
                     ("critic_params", tstate.critic),
                     ("target_actor_params", tstate.target_actor),
                     ("target_critic_params", tstate.target_critic)):
        want = params_from_jax(tree[key], net)
        for name, v in net.state_dict().items():
            np.testing.assert_allclose(v.double().numpy(),
                                       want[name].double().numpy(),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{what}{key}.{name}")


def _assert_grads(jgrads, net, tgrads, what):
    want = params_from_jax(jax.device_get(jgrads), net)
    for (name, _), g in zip(net.named_parameters(), tgrads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what}.{name}")


def test_qnetwork_matches_jax():
    jagent = JAgent(**AGENT_KW, gnn_impl="pallas")
    tagent = AgentConfig(**AGENT_KW, gnn_impl="pallas")
    a_dim = N * 3 * N
    o = _obs(3, 5)
    act = np.random.default_rng(1).uniform(size=(3, a_dim)).astype(np.float32)
    jq = JQ(agent=jagent, gnn_impl="pallas", action_dim=a_dim)
    params = jq.init(jax.random.PRNGKey(2), _jobs(o), jnp.asarray(act))
    tq = QNetwork(tagent, a_dim, gnn_impl="pallas")
    tq.load_state_dict(params_from_jax(jax.device_get(params), tq))
    want = np.asarray(jq.apply(params, _jobs(o), jnp.asarray(act)))
    with torch.no_grad():
        got = tq(_tobs(o), torch.from_numpy(act)).numpy()
    assert got.shape == (3, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_losses_and_gradients_match_jax():
    """Critic and actor losses and their parameter gradients against
    ``jax.value_and_grad`` of the JAX package's losses (Pallas attention
    in interpret mode with its dense-VJP backward)."""
    jd, td, jstate, tstate = _learners()
    b = _batch(11)
    jb, tb = _jbatch(b), _tbatch(b)
    (jcl, jq), jcg = jax.value_and_grad(jd._critic_loss, has_aux=True)(
        jstate.critic_params, jstate, jb)
    tcl, tq = td.critic_loss(tstate, tb)
    tcg = torch.autograd.grad(tcl, list(tstate.critic.parameters()))
    np.testing.assert_allclose(float(tcl.detach()), float(jcl), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq),
                               rtol=RTOL, atol=ATOL)
    _assert_grads(jcg, tstate.critic, tcg, "critic")
    jal, jag = jax.value_and_grad(jd._actor_loss)(
        jstate.actor_params, jstate.critic_params, jb)
    tal = td.actor_loss(tstate, tb)
    tag = torch.autograd.grad(tal, list(tstate.actor.parameters()))
    np.testing.assert_allclose(float(tal), float(jal), rtol=RTOL, atol=ATOL)
    _assert_grads(jag, tstate.actor, tag, "actor")
    # the GATv2 parameters do get gradients
    assert float(tag[0].abs().sum()) > 0


def test_gradient_step_and_learn_burst_match_jax():
    """One ``gradient_step_on_batch`` (Adam + Polyak), then a 4-step
    ``_learn_burst`` whose ``sample_fn`` draws batch indices from the
    key; the port gets the same batches."""
    jd, td, jstate, tstate = _learners()
    b = _batch(21)
    jstate, jm = jd.gradient_step_on_batch(jstate, _jbatch(b))
    tstate, tm = td.gradient_step_on_batch(tstate, _tbatch(b))
    for k in ("critic_loss", "actor_loss", "q_values"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    _assert_state(jstate, tstate, STATE_RTOL, STATE_ATOL, "step: ")
    pool = _batch(31, size=16)
    jpool = _jbatch(pool)
    tpool = _tbatch(pool)
    bs = 4
    sample = lambda k: jax.tree_util.tree_map(
        lambda x: x[jax.random.randint(k, (bs,), 0, 16)], jpool)
    _, sub = jax.random.split(jstate.rng)
    idx = [np.asarray(jax.random.randint(jax.random.fold_in(sub, i), (bs,),
                                         0, 16)) for i in range(4)]
    jstate, jm = jax.jit(lambda s: jd._learn_burst(s, sample, steps=4))(
        jstate)
    it = iter(idx)

    def tsample():
        i = torch.from_numpy(np.array(next(it))).long()
        return {k: (GraphObs(**{f: getattr(v, f)[i]
                                for f in vars(v)})
                    if isinstance(v, GraphObs) else v[i])
                for k, v in tpool.items()}

    tstate, tm = td.learn_burst(tstate, tsample, steps=4)
    np.testing.assert_allclose(float(tm["critic_loss"]),
                               float(jm["critic_loss"]), rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    _assert_state(jstate, tstate, STATE_RTOL, STATE_ATOL, "burst: ")


class _Draws(Draws):
    """Feeds the port the JAX side's numbers: one (uniforms, normals)
    pair per rollout step, one (replica, slot) index pair per batch."""

    def __init__(self, steps, batches):
        self.steps = list(steps)
        self.batches = list(batches)

    def uniform(self, shape):
        u, _ = self.steps.pop(0)
        return torch.from_numpy(u)

    def normal(self, shape):
        _, z = self.steps.pop(0)
        return torch.from_numpy(z)

    def replay(self, batch, replicas, sizes):
        b, s = self.batches.pop(0)
        return (torch.from_numpy(np.array(b)).long(),
                torch.from_numpy(np.array(s)).long())

    def sim_noise(self, engine, batch):
        return None


def test_choose_action_both_branches_match_jax():
    jd, td, jstate, tstate = _learners()
    o = _obs(1, 7)
    jo = {k: jnp.asarray(v[0]) for k, v in o.items()}
    mask = jnp.asarray(o["mask"][0])
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    u = np.asarray(jax.random.uniform(k1, (jd.action_dim,)))[None]
    z = np.asarray(jax.random.normal(k2, (jd.action_dim,)))[None]
    for step in (0, 5):          # warm-up (< 2) and acting
        want = np.asarray(jd.choose_action(jstate.actor_params, JObs(**jo),
                                           mask, step, key))
        got = td.choose_action(tstate.actor, _tobs(o),
                               torch.from_numpy(o["mask"]), step,
                               _Draws([(u, z)], []))
        np.testing.assert_allclose(got[0].numpy(), want, rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {step}")


def test_ring_wraps_like_jax():
    example = {"x": jnp.zeros((2, 3)), "r": jnp.zeros(())}
    jbuf = j_buffer_init(example, 3)
    tbuf = buffer_init({"x": torch.zeros(2, 3), "r": torch.zeros(())}, 3,
                       lead=(B,))
    for i in range(5):
        x = np.full((2, 3), i, np.float32)
        jbuf = j_buffer_add(jbuf, {"x": jnp.asarray(x), "r": jnp.float32(i)})
        buffer_add(tbuf, {"x": torch.from_numpy(np.stack([x, x + 10])),
                          "r": torch.tensor([i, i + 10.0])})
    assert int(tbuf.pos[0]) == int(jbuf.pos) == 2
    assert int(tbuf.size[0]) == int(jbuf.size) == 3
    np.testing.assert_array_equal(tbuf.data["x"][0].numpy(),
                                  np.asarray(jbuf.data["x"]))
    np.testing.assert_array_equal(tbuf.data["r"][1].numpy(),
                                  np.asarray(jbuf.data["r"]) + 10)


def test_episode_matches_jax():
    """One episode of the port's ``ParallelDDPG`` (two rollout chunks,
    the final one carrying the learn burst) against the JAX package's
    ``rollout_episodes`` twice and ``learn_burst``, on the same traffic
    and the same draws."""
    jenv, tenv = _envs("dense")
    jtopo, ttopo = _topos()
    jp = JParallel(jenv, jenv.agent, num_replicas=B)
    tp = ParallelDDPG(tenv, tenv.agent, B, device="cpu")
    seeds = [1000 + r for r in range(B)]
    jtr = [j_traffic(jenv.sim_cfg, jenv.service, jtopo, 4, seed=s)
           for s in seeds]
    jtraffic = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jtr)
    ttraffic = TrafficSchedule(**{
        f.name: torch.from_numpy(np.array(getattr(jtraffic, f.name)))
        for f in dataclasses.fields(TrafficSchedule)})
    one = {k: v[0] for k, v in _obs(1, 0).items()}
    jstate = jp.init(jax.random.PRNGKey(4), _jobs(one))
    jbuf = jp.init_buffers(_jobs(one))
    es, obs = jp.reset_all(jax.random.PRNGKey(5), jtopo, jtraffic)

    # the JAX side's draws, from the keys its functions split
    a_dim = jp.ddpg.action_dim
    steps = []
    rng = jstate.rng
    for c in range(2):
        rng, sub = jax.random.split(rng)
        sub, _ = jax.random.split(sub)
        for i in range(CHUNK):
            keys = jax.random.split(jax.random.fold_in(sub, i), B)
            pairs = [jax.random.split(k) for k in keys]
            steps.append((
                np.stack([np.asarray(jax.random.uniform(p[0], (a_dim,)))
                          for p in pairs]),
                np.stack([np.asarray(jax.random.normal(p[1], (a_dim,)))
                          for p in pairs])))
    for c in range(2):
        jstate, jbuf, es, obs, _ = jp.rollout_episodes(
            jstate, jbuf, es, obs, jtopo, jtraffic, jnp.int32(c * CHUNK),
            CHUNK)
    _, sub = jax.random.split(jstate.rng)
    batches = []
    for i in range(4):
        kb, ks = jax.random.split(jax.random.fold_in(sub, i))
        bidx = jax.random.randint(kb, (4,), 0, B)
        sidx = jax.random.randint(ks, (4,), 0,
                                  jnp.maximum(jbuf.size[bidx], 1))
        batches.append((np.asarray(bidx), np.asarray(sidx)))
    jlearn_in = jstate
    jstate, jm = jp.learn_burst(jstate, jbuf)

    tp.draws = _Draws(steps, batches)
    tstate = tp.ddpg.init_state(torch.Generator().manual_seed(0))
    learner_state_from_jax(_state_tree(jlearn_in), tstate)
    tbuf = tp.init_buffers(GraphObs(**{k: torch.from_numpy(np.asarray(v))
                                       for k, v in one.items()}))
    tes, tobs = tp.reset_all(ttopo, ttraffic)
    metrics = None
    for c in range(2):
        tstate, tbuf, tes, tobs, stats, metrics = tp.chunk_step(
            tstate, tbuf, tes, tobs, ttopo, ttraffic, c * CHUNK, CHUNK,
            learn=(c == 1))
    assert not tp.draws.steps and not tp.draws.batches

    np.testing.assert_array_equal(tbuf.pos.numpy(), np.asarray(jbuf.pos))
    np.testing.assert_array_equal(tbuf.size.numpy(), np.asarray(jbuf.size))
    jleaves = dict(zip(
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(jbuf.data)[0]],
        jax.tree_util.tree_leaves(jbuf.data)))
    assert len(jleaves) == len(tbuf.data)
    for name, t in tbuf.data.items():
        path = "".join(f"['{p}']" if i == 0 else f".{p}"
                       for i, p in enumerate(name.split(".")))
        want = np.asarray(jleaves[path])
        got = t.numpy()
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=REPLAY_RTOL,
                                       atol=REPLAY_ATOL, err_msg=name)
    np.testing.assert_allclose(float(metrics["critic_loss"]),
                               float(jm["critic_loss"]), rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    _assert_state(jstate, tstate, STATE_RTOL, BURST_ATOL, "episode: ")


def test_shuffle_nodes_is_refused():
    jenv, tenv = _envs("dense")
    agent = AgentConfig(**AGENT_KW, shuffle_nodes=True)
    with pytest.raises(NotImplementedError, match="shuffle_nodes"):
        ParallelDDPG(tenv, agent, B, device="cpu")


def test_cli_train_on_cpu(tmp_path):
    """``python -m gsc_tpu_torch.cli train --device cpu`` end to end at a
    tiny size from yaml files: one row per episode in rewards.csv, finite
    losses, and no kernel launch on the CPU."""
    from gsc_tpu_torch import cli
    from gsc_tpu_torch.ops.gat_attention import gat_attention
    from gsc_tpu_torch.ops.substep import substep_megakernel

    (tmp_path / "agent.yaml").write_text(
        "GNN_features: 4\nGNN_num_layers: 1\nGNN_num_iter: 1\n"
        "episode_steps: 2\nactor_hidden_layer_nodes: [8]\n"
        "critic_hidden_layer_nodes: [8]\nbatch_size: 4\nmem_limit: 8\n"
        "nb_steps_warmup_critic: 2\ngnn_impl: pallas\n")
    (tmp_path / "sim.yaml").write_text(
        "inter_arrival_mean: 10.0\ndeterministic_arrival: true\n"
        "deterministic_size: true\nflow_dr_mean: 1.0\nflow_dr_stdev: 0.0\n"
        "flow_size_shape: 0.001\nrun_duration: 10\nttl_choices: [100]\n"
        "substep_impl: pallas\n")
    before = (gat_attention.launches, substep_megakernel.launches)
    out = cli.run_train([
        "--device", "cpu", "--replicas", "2", "--chunk", "1",
        "--episodes", "2", "--network", "abilene",
        "--agent-config", str(tmp_path / "agent.yaml"),
        "--simulator-config", str(tmp_path / "sim.yaml"),
        "--result-dir", str(tmp_path / "out")])
    rows = (tmp_path / "out" / "rewards.csv").read_text().split()
    assert rows[0] == "r" and len(rows) == 3
    hist = out["trainer"].history
    assert len(hist) == 2
    assert all(np.isfinite([h["critic_loss"], h["actor_loss"],
                            h["episodic_return"]]).all() for h in hist)
    assert out["trainer"].env.sim_cfg.substep_impl == "pallas"
    assert (gat_attention.launches, substep_megakernel.launches) == before
    assert out["buffers"].size.tolist() == [4, 4]
