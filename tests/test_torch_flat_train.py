"""Flat mode (``graph_mode: false``) through training, evaluation,
checkpoints, ``infer`` and serving, against the JAX package on the CPU.

Sizes are tests/test_torch_single_env.py's and tests/test_torch_train.py's
(a triangle padded to 8 nodes / 8 edges, the abc chain, 10 ms
intervals, actor and critic hidden (8,), 4-step episodes, batch 4, 2
warm-up steps) with ``graph_mode: false``: observation 8 x 3 = 24
floats, action 8 x 1 x 3 x 8 = 192.  The port loads the JAX learner state
through ``utils.convert`` and takes the JAX side's random draws through
``Draws``.

Tolerances are those of the graph-mode tests, for the same reasons
(stated in tests/test_torch_train.py and tests/test_torch_single_env.py):

- one single-env episode with its burst on the triangle: replay integers
  and booleans exact, floats rtol 1e-5, atol 1e-5; episode stats rtol
  1e-5, atol 1e-5; the learner state after the burst rtol 1e-4, atol
  8e-5;
- two replica episodes (B = 2, chunks of 2) with their bursts: the same;
- ``evaluate`` and its test-mode CSVs (the ``rl_state`` column is the flat
  observation): returns rtol 1e-5, atol 1e-5, integer and text cells
  exact, float cells rtol 1e-5, atol 1e-5;
- exact resume, ``infer`` against the run's own evaluation, and a served
  request against ``greedy_action`` on the same observation: bit for
  bit.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from gsc_tpu_torch import cli
from gsc_tpu_torch.agents.trainer import Trainer
from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import (AgentConfig, EnvLimits,
                                         SchedulerConfig, SimConfig)
from gsc_tpu_torch.env.driver import EpisodeDriver
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.obs.hub import MetricsHub
from gsc_tpu_torch.parallel.dp import ParallelDDPG
from gsc_tpu_torch.serve.policy import GreedyServePolicy, ObsTemplate
from gsc_tpu_torch.serve.server import PolicyServer
from gsc_tpu_torch.sim.state import TrafficSchedule
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import compile_topology
from gsc_tpu_torch.utils.checkpoint import (load_full_or_partial,
                                            read_checkpoint_meta,
                                            save_checkpoint)
from test_torch_single_env import (AGENT_KW, SIM_KW, TINY_AGENT, TINY_SIM,
                                   TRI, _cells_match, _csv_rows, _Draws,
                                   _tensors, _traffic)
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-5
STATE_RTOL, STATE_ATOL, BURST_ATOL = 1e-4, 1e-6, 8e-5
N = E = 8
FLAT_KW = dict(AGENT_KW, graph_mode=False)
FLAT_AGENT = TINY_AGENT + "graph_mode: false\n"


def _port_stack(seed=3, agent_kw=FLAT_KW):
    agent = AgentConfig(**agent_kw)
    sim = SimConfig(**SIM_KW)
    env = ServiceCoordEnv(abc_service(), sim, agent,
                          EnvLimits.for_service(abc_service(), max_nodes=N,
                                                max_edges=E))
    topos = [compile_topology(synthetic.triangle(**TRI), max_nodes=N,
                              max_edges=E),
             compile_topology(synthetic.line(4), max_nodes=N, max_edges=E)]
    driver = EpisodeDriver(SchedulerConfig(("tri", "line"), "line", 1), sim,
                           abc_service(), agent.episode_steps, max_nodes=N,
                           max_edges=E, base_seed=seed, topologies=topos,
                           inference_topology=topos[1])
    return Trainer(env, driver, agent, seed=seed, device="cpu")


def _jax_stack(seed=3, result_dir=None):
    from gsc_tpu.agents.trainer import Trainer as JTrainer
    from gsc_tpu.config.catalog import abc_service as j_abc
    from gsc_tpu.config.schema import AgentConfig as JAgent
    from gsc_tpu.config.schema import EnvLimits as JLimits
    from gsc_tpu.config.schema import SchedulerConfig as JSched
    from gsc_tpu.config.schema import SimConfig as JSim
    from gsc_tpu.env.driver import EpisodeDriver as JDriver
    from gsc_tpu.env.env import ServiceCoordEnv as JEnv
    from gsc_tpu.topology import synthetic as jsyn
    from gsc_tpu.topology.compiler import compile_topology as j_compile

    agent = JAgent(**FLAT_KW)
    sim = JSim(**SIM_KW)
    env = JEnv(j_abc(), sim, agent, JLimits.for_service(
        j_abc(), max_nodes=N, max_edges=E))
    topos = [j_compile(jsyn.triangle(**TRI), max_nodes=N, max_edges=E),
             j_compile(jsyn.line(4), max_nodes=N, max_edges=E)]
    driver = JDriver(JSched(("tri", "line"), "line", 1), sim, j_abc(),
                     agent.episode_steps, max_nodes=N, max_edges=E,
                     base_seed=seed, topologies=topos,
                     inference_topology=topos[1])
    return JTrainer(env, driver, agent, seed=seed, result_dir=result_dir)


def _replay_matches(tbuf, jbuf):
    import jax

    jleaves = dict(zip(
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(jbuf.data)[0]],
        jax.tree_util.tree_leaves(jbuf.data)))
    assert len(jleaves) == len(tbuf.data)
    for name, t in tbuf.data.items():
        path = "".join(f"['{p}']" if i == 0 else f".{p}"
                       for i, p in enumerate(name.split(".")))
        want, got = np.asarray(jleaves[path]), t.numpy()
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def test_single_env_episode_with_burst_matches_jax():
    """One flat single-env episode on the triangle (2 warm-up steps, 2
    acting steps, the env's mask as the warm-up mask) and its 4-step
    learn burst, against the JAX package's ``DDPG.episode_step`` on the
    same traffic and draws."""
    import jax
    import jax.numpy as jnp
    from test_torch_train import _assert_state, _state_tree

    from gsc_tpu_torch.utils.convert import learner_state_from_jax

    jt, tt = _jax_stack(), _port_stack()
    jtopo, jtraffic = jt.driver.episode(0)
    ttopo, _ = tt.driver.episode(0)
    jes, jobs = jt.env.reset(jax.random.PRNGKey(0), jtopo, jtraffic)
    assert np.asarray(jobs).shape == (24,)
    jd = jt.ddpg
    jstate = jd.init(jax.random.PRNGKey(4), jobs)
    jbuf = jd.init_buffer(jobs)
    a_dim = jd.action_dim
    rng, sub = jax.random.split(jstate.rng)
    sub, _ = jax.random.split(sub)
    steps = []
    for i in range(FLAT_KW["episode_steps"]):
        k1, k2 = jax.random.split(jax.random.fold_in(sub, i))
        steps.append((np.asarray(jax.random.uniform(k1, (a_dim,)))[None],
                      np.asarray(jax.random.normal(k2, (a_dim,)))[None]))
    state_in = _state_tree(jstate)
    jstate, jbuf, _, _, jstats, jm = jd.episode_step(
        jstate, jbuf, jes, jobs, jtopo, jtraffic, jnp.int32(0), None, True)
    _, bsub = jax.random.split(rng)
    batches = [np.asarray(jax.random.randint(
        jax.random.fold_in(bsub, i), (FLAT_KW["batch_size"],), 0,
        jnp.maximum(jbuf.size, 1))) for i in range(FLAT_KW["episode_steps"])]

    draws = _Draws(steps, batches)
    tstate = tt.init_state()
    learner_state_from_jax(state_in, tstate)
    tes, tobs = tt.env.reset(ttopo, _traffic(jtraffic), batch=1)
    assert tuple(tobs.shape) == (1, 24)
    tbuf = tt.ddpg.init_buffer(tobs[0])
    tstate, tbuf, _, _, stats, tm = tt.ddpg.episode_step(
        tstate, tbuf, tes, tobs, ttopo, _traffic(jtraffic), 0, draws,
        learn=True)
    assert not draws.steps and not draws.batches
    for k in ("episodic_return", "mean_succ_ratio", "mean_e2e_delay",
              "final_succ_ratio"):
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert int(tbuf.pos) == int(jbuf.pos) and int(tbuf.size) == \
        int(jbuf.size) == 4
    assert set(tbuf.data) == {"obs", "next_obs", "action", "reward", "done",
                              "topo_idx"}
    _replay_matches(tbuf, jbuf)
    np.testing.assert_allclose(float(tm["critic_loss"]),
                               float(jm["critic_loss"]), rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    _assert_state(jstate, tstate, STATE_RTOL, BURST_ATOL, "episode: ")


def test_two_replica_episodes_match_jax():
    """``ParallelDDPG`` on 2 replicas for two flat episodes (each two
    rollout chunks of 2 steps, the last carrying the 4-step learn
    burst), against the JAX package's ``rollout_episodes`` and
    ``learn_burst`` on the same traffic and draws."""
    import jax
    import jax.numpy as jnp
    from gsc_tpu.parallel.dp import ParallelDDPG as JParallel
    from gsc_tpu.sim.traffic import generate_traffic as j_traffic
    from test_torch_train import _Draws as _ReplicaDraws
    from test_torch_train import _assert_state, _state_tree

    from gsc_tpu_torch.utils.convert import learner_state_from_jax

    b, chunk = 2, 2
    jt, tt = _jax_stack(), _port_stack()
    jtopo, _ = jt.driver.episode(0)
    ttopo, _ = tt.driver.episode(0)
    jp = JParallel(jt.env, jt.env.agent, num_replicas=b)
    tp = ParallelDDPG(tt.env, tt.env.agent, b, device="cpu")
    one = np.zeros(24, np.float32)
    jstate = jp.init(jax.random.PRNGKey(4), jnp.asarray(one))
    jbuf = jp.init_buffers(jnp.asarray(one))
    tstate = tp.ddpg.init_state(torch.Generator().manual_seed(0))
    learner_state_from_jax(_state_tree(jstate), tstate)
    tbuf = tp.init_buffers(torch.from_numpy(one))
    a_dim = jp.ddpg.action_dim
    for ep in range(2):
        steps, batches = [], []
        jtr = [j_traffic(jt.env.sim_cfg, jt.env.service, jtopo, 4,
                         seed=1000 * ep + r) for r in range(b)]
        jtraffic = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jtr)
        ttraffic = TrafficSchedule(**{
            f.name: torch.from_numpy(np.array(getattr(jtraffic, f.name)))
            for f in dataclasses.fields(TrafficSchedule)})
        es, obs = jp.reset_all(jax.random.PRNGKey(5), jtopo, jtraffic)
        for c in range(2):
            _, sub = jax.random.split(jstate.rng)
            sub, _ = jax.random.split(sub)
            for i in range(chunk):
                keys = jax.random.split(jax.random.fold_in(sub, i), b)
                pairs = [jax.random.split(k) for k in keys]
                steps.append((
                    np.stack([np.asarray(jax.random.uniform(p[0], (a_dim,)))
                              for p in pairs]),
                    np.stack([np.asarray(jax.random.normal(p[1], (a_dim,)))
                              for p in pairs])))
            start = ep * 4 + c * chunk
            jstate, jbuf, es, obs, _ = jp.rollout_episodes(
                jstate, jbuf, es, obs, jtopo, jtraffic, jnp.int32(start),
                chunk)
        _, sub = jax.random.split(jstate.rng)
        for i in range(4):
            kb, ks = jax.random.split(jax.random.fold_in(sub, i))
            bidx = jax.random.randint(kb, (4,), 0, b)
            sidx = jax.random.randint(ks, (4,), 0,
                                      jnp.maximum(jbuf.size[bidx], 1))
            batches.append((np.asarray(bidx), np.asarray(sidx)))
        jstate, jm = jp.learn_burst(jstate, jbuf)

        tp.draws = _ReplicaDraws(steps, batches)
        tes, tobs = tp.reset_all(ttopo, ttraffic)
        assert tuple(tobs.shape) == (b, 24)
        for c in range(2):
            tstate, tbuf, tes, tobs, stats, tm = tp.chunk_step(
                tstate, tbuf, tes, tobs, ttopo, ttraffic, ep * 4 + c * chunk,
                chunk, learn=(c == 1))
        assert not tp.draws.steps and not tp.draws.batches
        np.testing.assert_array_equal(tbuf.pos.numpy(),
                                      np.asarray(jbuf.pos))
        np.testing.assert_array_equal(tbuf.size.numpy(),
                                      np.asarray(jbuf.size))
        _replay_matches(tbuf, jbuf)
        np.testing.assert_allclose(float(tm["critic_loss"]),
                                   float(jm["critic_loss"]),
                                   rtol=STATE_RTOL, atol=STATE_ATOL)
        _assert_state(jstate, tstate, STATE_RTOL, BURST_ATOL,
                      f"episode {ep}: ")


def test_evaluate_writes_the_jax_test_csvs(tmp_path):
    """Greedy flat episodes on the inference network with the JAX
    parameters converted: the same returns and the same test-mode CSV
    files, whose ``rl_state`` is the flat observation."""
    import jax
    from test_torch_train import _state_tree

    from gsc_tpu_torch.utils.convert import learner_state_from_jax

    jt = _jax_stack(result_dir=str(tmp_path / "jax"))
    tt = _port_stack()
    tt.result_dir = str(tmp_path / "port")
    _, jobs = jt.env.reset(jax.random.PRNGKey(0), *jt.driver.episode(0))
    jstate = jt.ddpg.init(jax.random.PRNGKey(8), jobs)
    tstate = tt.init_state()
    learner_state_from_jax(_state_tree(jstate), tstate)
    kw = dict(episodes=2, test_mode=True, telemetry=True,
              write_schedule=True)
    want, got = jt.evaluate(jstate, **kw), tt.evaluate(tstate, **kw)
    for k in ("mean_return", "final_succ_ratio"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    jdir, tdir = tmp_path / "jax" / "test", tmp_path / "port" / "test"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in sorted(os.listdir(jdir)):
        want_rows, got_rows = _csv_rows(jdir / name), _csv_rows(tdir / name)
        assert len(got_rows) == len(want_rows) > 0, name
        for i, (g, w) in enumerate(zip(got_rows, want_rows)):
            if name == "runtimes.csv" and i > 0:
                assert g[0] == w[0]
                continue
            _cells_match(g, w, f"{name} row {i}")


def test_trainer_smoke(tmp_path):
    """tests/test_agent.py's flat trainer smoke: 3 episodes of 4 steps,
    one rewards.csv row each, a finite evaluation."""
    trainer = _port_stack()
    trainer.result_dir = str(tmp_path)
    state, buffer = trainer.train(3)
    assert len(trainer.history) == 3
    rows = (tmp_path / "rewards.csv").read_text().strip().splitlines()
    assert rows[0] == "r" and len(rows) == 4
    assert np.isfinite(trainer.evaluate(state, episodes=1)["mean_return"])
    assert tuple(buffer.data["obs"].shape) == (FLAT_KW["mem_limit"], 24)


@pytest.mark.parametrize("replicas", [1, 2])
def test_exact_resume(tmp_path, replicas):
    """4 straight flat episodes against 2, a checkpoint and 2 more: every
    tensor equal (``torch.equal``)."""
    def train(trainer, episodes, **kw):
        if replicas > 1:
            if "init_buffer" in kw:
                kw["init_buffers"] = kw.pop("init_buffer")
            return trainer.train_parallel(episodes, replicas, chunk=2, **kw)
        return trainer.train(episodes, **kw)

    straight = _port_stack()
    state_a, buf_a = train(straight, 4)
    first = _port_stack()
    state_m, buf_m = train(first, 2)
    ck = save_checkpoint(str(tmp_path / "ck"), state_m, buffer=buf_m,
                         draws=first.draws, extra={"episode": 2})
    resumed = _port_stack()
    state_t, buf_t = resumed.template(replicas)
    restored, full = load_full_or_partial(ck, state_t, buffer=buf_t,
                                          draws=resumed.draws)
    assert full and restored["extra"] == {"episode": 2}
    state_b, buf_b = train(resumed, 4, init_state=state_t,
                           init_buffer=buf_t, start_episode=2)
    want = _tensors(state_a, buf_a, straight.draws)
    got = _tensors(state_b, buf_b, resumed.draws)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _cli_files(tmp_path, agent=FLAT_AGENT):
    (tmp_path / "agent.yaml").write_text(agent)
    (tmp_path / "sim.yaml").write_text(TINY_SIM)
    return ["--device", "cpu", "--agent-config", str(tmp_path / "agent.yaml"),
            "--simulator-config", str(tmp_path / "sim.yaml"), "--network",
            "abilene", "--no-perf"]


@pytest.mark.parametrize("replicas", [1, 2])
def test_cli_train_resume_infer_and_serve(tmp_path, capsys, replicas):
    """``cli train`` of a flat agent yaml (single env or 2 replicas),
    ``--resume`` of its checkpoint equal to a straight run, ``infer``
    equal to the run's own evaluation, and ``serve`` of the checkpoint;
    the sidecar records ``graph_mode`` false."""
    base = _cli_files(tmp_path)
    if replicas > 1:
        base += ["--replicas", str(replicas), "--chunk", "3"]
    straight = cli.run_train(base + ["--episodes", "3", "--result-dir",
                                     str(tmp_path / "straight")])
    out1 = cli.run_train(base + ["--episodes", "2", "--result-dir",
                                 str(tmp_path / "r1")])
    ck = out1["summary"]["checkpoint"]
    meta = read_checkpoint_meta(ck)
    assert meta["graph_mode"] is False and meta["precision"] == "f32"
    out2 = cli.run_train(base + ["--episodes", "3", "--resume", ck,
                                 "--result-dir", str(tmp_path / "r2")])
    want = _tensors(straight["state"], straight["buffers"],
                    straight["trainer"].draws)
    got = _tensors(out2["state"], out2["buffers"], out2["trainer"].draws)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    inf = cli.run_infer(base[:8] + ["--checkpoint", ck])
    assert inf["eval"]["mean_return"] == out1["summary"]["mean_return"]
    assert inf["eval"]["final_succ_ratio"] == \
        out1["summary"]["final_succ_ratio"]
    capsys.readouterr()
    rc = cli.main(["serve", *base[:8], "--checkpoint", ck, "--requests",
                   "12", "--concurrency", "2", "--pool-steps", "2",
                   "--no-obs"])
    served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and served["tier"] == "learned" and \
        served["completed"] == 12 and served["errors"] == 0


def test_checkpoint_of_the_other_mode_is_refused(tmp_path):
    """A flat checkpoint with a graph agent yaml (and the reverse) is
    refused by name by resume, infer and serve."""
    flat = _cli_files(tmp_path)
    out = cli.run_train(flat + ["--episodes", "1", "--result-dir",
                                str(tmp_path / "f")])
    ck = out["summary"]["checkpoint"]
    (tmp_path / "graph.yaml").write_text(TINY_AGENT)
    graph = list(flat)
    graph[graph.index("--agent-config") + 1] = str(tmp_path / "graph.yaml")
    msg = "holds a graph_mode false agent, the agent config has graph_mode " \
        "true"
    with pytest.raises(SystemExit, match=msg):
        cli.run_train(graph + ["--episodes", "2", "--resume", ck])
    with pytest.raises(SystemExit, match=msg):
        cli.run_infer(graph[:8] + ["--checkpoint", ck])
    with pytest.raises(SystemExit, match=msg):
        cli.main(["serve", *graph[:8], "--checkpoint", ck, "--no-obs"])
    gout = cli.run_train(graph + ["--episodes", "1", "--result-dir",
                                  str(tmp_path / "g")])
    with pytest.raises(SystemExit, match="holds a graph_mode true agent"):
        cli.run_infer(flat[:8] + ["--checkpoint",
                                  gout["summary"]["checkpoint"]])


@pytest.mark.parametrize("flags,message", [
    (["--replicas", "2", "--chunk", "3", "--async"], "--async with a flat"),
    (["--replicas", "2", "--chunk", "3", "--mesh", "2x1"],
     "--mesh with a flat"),
    (["--hot-swap-dir", "HOT"], "--hot-swap-dir with a flat")],
    ids=["async", "mesh", "hot_swap"])
def test_paths_not_ported_for_flat_agents_are_refused(tmp_path, flags,
                                                      message):
    flags = [str(tmp_path / f) if f == "HOT" else f for f in flags]
    with pytest.raises(SystemExit, match=message):
        cli.run_train(_cli_files(tmp_path) + ["--episodes", "1", *flags])


def test_library_refusals_name_the_path():
    from gsc_tpu_torch.serve import run_serve

    trainer = _port_stack()
    with pytest.raises(ValueError, match=r"--async\) of a flat agent"):
        trainer.train_async(1, 2, chunk=2)
    with pytest.raises(ValueError, match="hot-swap publishing of a flat"):
        trainer.train(1, publisher=object(), publish_interval=1)
    with pytest.raises(ValueError, match="per-flow control"):
        ServiceCoordEnv(abc_service(), SimConfig(**SIM_KW,
                                                 controller="per_flow"),
                        AgentConfig(**FLAT_KW), EnvLimits.for_service(
                            abc_service(), max_nodes=N, max_edges=E))
    with pytest.raises(ValueError, match="hot-swap serving of a flat"):
        run_serve(AgentConfig(**FLAT_KW), device="cpu", hot_swap_dir="x",
                  requests=1)


def test_policy_server_answers_equal_greedy_action():
    """Flat requests through ``PolicyServer`` (bucket 1: each request its
    own call) equal ``greedy_action`` on the same observation, bit for
    bit; the template refuses a graph observation and a wrong shape."""
    trainer = _port_stack()
    trainer.init_state()
    ddpg = trainer.ddpg
    topo, traffic = trainer._episode(0)
    es, obs = trainer.env.reset(topo, traffic, batch=1)
    pool = []
    for _ in range(3):
        pool.append(obs[0].numpy().copy())
        act = ddpg.greedy_action(obs)
        es, obs, *_ = trainer.env.step(es, topo, traffic, act)
    policy = GreedyServePolicy(ddpg, pool[0])
    assert not policy.template.graph
    srv = PolicyServer(policy, buckets=(1,), deadline_ms=1.0,
                       hub=MetricsHub(), graph_mode=False).start()
    try:
        answers = [srv.submit_sync(o, timeout=60) for o in pool]
    finally:
        srv.close()
    for o, got in zip(pool, answers):
        want = ddpg.greedy_action(torch.from_numpy(o)[None])[0].numpy()
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="wants a flat array"):
        policy.template.flatten(_graph_obs())
    with pytest.raises(ValueError, match="template wants"):
        policy.template.flatten(np.zeros(23, np.float32))
    with pytest.raises(ValueError, match="graph_mode true server"):
        PolicyServer(policy, buckets=(1,), graph_mode=True)


def _graph_obs():
    """A graph observation of the same network, as host arrays."""
    graph = _port_stack(agent_kw=AGENT_KW)
    topo, traffic = graph._episode(0)
    _, obs = graph.env.reset(topo, traffic, batch=1)
    return obs.map(lambda x: x[0].numpy())


def test_obs_template_pads_flat_requests():
    t = ObsTemplate(np.zeros(24, np.float32))
    reqs = [t.flatten(np.full(24, k, np.float32)) for k in range(3)]
    out = t.stack_pad(reqs, 4)
    assert len(out) == 1 and out[0].shape == (4, 24)
    assert out[0][:, 0].tolist() == [0.0, 1.0, 2.0, 2.0]
