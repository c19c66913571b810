"""Flat agents (``graph_mode: false``) under per-flow control and under
the hot-swap fleet, against the JAX package on the CPU.

Sizes are tests/test_torch_flat_train.py's (a triangle padded to 8 nodes
/ 8 edges, the abc chain, 10 ms intervals, actor and critic hidden (8,),
4-step episodes), with ``controller: per_flow`` and a 15 ms
``vnf_timeout``, so that idle instances expire within an episode.

- the flat env under per-flow control against the JAX
  ``ServiceCoordEnv`` over two episodes, both acting through the same
  flax actor (the port's converted by ``utils.convert``): the greedy
  actions rtol 1e-5 / atol 1e-6 (the actor's f32 matmuls may sum in
  another order), then both envs step on the JAX side's action, so that
  they stay in lockstep: observations and rewards rtol/atol 1e-5 (the
  engine's bar, tests/test_torch_substep.py), the integer counters, the
  placement and the SFs' availability exact;
- a flat ``cli train`` under per-flow control on one env and on
  ``--replicas 2``, with its evaluation, and ``infer`` of its checkpoint
  equal to that evaluation;
- ``train --hot-swap-dir`` of a flat agent publishes versions that the
  JAX package's ``load_version`` reads to the same leaves, and a version
  the JAX package publishes reads back in the port to its leaves;
- a flat server swapping a version mid-serve answers as a fresh server on
  those weights, bit for bit; a graph-mode version is refused by a flat
  server (by its leaves) and the reverse;
- a flat agent under per-flow control trains under ``--async`` and on a
  ``--mesh 2x1`` with ``--hot-swap-dir``, and each run publishes (under
  the mesh, rank 0 alone writes the directory); resuming a graph-mode
  checkpoint stays refused on both paths.
"""
import logging

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
from gsc_tpu_torch.serve import (GreedyServePolicy, PolicyServer,
                                 WeightPublisher, load_version, read_latest)
from gsc_tpu_torch.serve.fleet import host_leaves
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import compile_topology
from test_torch_flat_train import FLAT_AGENT, FLAT_KW
from test_torch_single_env import SIM_KW, TINY_SIM, TRI, _traffic
from torch_port_helpers import one_torch_thread  # noqa: F401

N = E = 8
RTOL = ATOL = 1e-5
PERFLOW_KW = dict(SIM_KW, controller="per_flow", vnf_timeout=15.0)
PERFLOW_SIM = TINY_SIM + "controller: per_flow\nvnf_timeout: 15.0\n"


def _port_stack(seed=3, sim_kw=PERFLOW_KW, agent_kw=FLAT_KW):
    agent = AgentConfig(**agent_kw)
    sim = SimConfig(**sim_kw)
    env = ServiceCoordEnv(abc_service(), sim, agent,
                          EnvLimits.for_service(abc_service(), max_nodes=N,
                                                max_edges=E))
    topos = [compile_topology(synthetic.triangle(**TRI), max_nodes=N,
                              max_edges=E)]
    driver = EpisodeDriver(SchedulerConfig(("tri",), "tri", 1), sim,
                           abc_service(), agent.episode_steps, max_nodes=N,
                           max_edges=E, base_seed=seed, topologies=topos,
                           inference_topology=topos[0])
    return Trainer(env, driver, agent, seed=seed, device="cpu")


def _jax_env_and_agent():
    from gsc_tpu.agents.ddpg import DDPG as JDDPG
    from gsc_tpu.config.catalog import abc_service as j_abc
    from gsc_tpu.config.schema import AgentConfig as JAgent
    from gsc_tpu.config.schema import EnvLimits as JLimits
    from gsc_tpu.config.schema import SimConfig as JSim
    from gsc_tpu.env.env import ServiceCoordEnv as JEnv
    from gsc_tpu.topology import synthetic as jsyn
    from gsc_tpu.topology.compiler import compile_topology as j_compile

    agent = JAgent(**FLAT_KW)
    env = JEnv(j_abc(), JSim(**PERFLOW_KW), agent,
               JLimits.for_service(j_abc(), max_nodes=N, max_edges=E))
    topo = j_compile(jsyn.triangle(**TRI), max_nodes=N, max_edges=E)
    return env, JDDPG(env, agent), topo


def _counters(sim):
    """The integer state compared exactly: counters, placement, SFs."""
    m = sim.metrics
    return {"generated": m.generated, "processed": m.processed,
            "dropped": m.dropped, "drop_reasons": m.drop_reasons,
            "run_flow_counts": m.run_flow_counts, "placed": sim.placed,
            "sf_available": sim.sf_available}


def test_flat_env_under_per_flow_control_matches_jax():
    import jax
    import jax.numpy as jnp
    from gsc_tpu.sim.traffic import generate_traffic as j_traffic

    from gsc_tpu_torch.utils.convert import params_from_jax

    jenv, jd, jtopo = _jax_env_and_agent()
    tt = _port_stack()
    tenv, ddpg = tt.env, tt.ddpg
    # the same actions under the duration controller: where its placement
    # differs, the idle-instance expiry removed an instance
    denv = _port_stack(sim_kw=dict(PERFLOW_KW, controller="duration")).env
    ttopo = compile_topology(synthetic.triangle(**TRI), max_nodes=N,
                             max_edges=E)
    steps = FLAT_KW["episode_steps"]
    jparams = None
    expired = 0
    for ep in range(2):
        jtraffic = j_traffic(jenv.sim_cfg, jenv.service, jtopo, steps,
                             seed=11 + ep)
        ttraffic = _traffic(jtraffic)
        jes, jobs = jenv.reset(jax.random.PRNGKey(ep), jtopo, jtraffic)
        if jparams is None:
            jparams = jd.init(jax.random.PRNGKey(4), jobs).actor_params
            ddpg.actor.load_state_dict(params_from_jax(
                jax.device_get(jparams), ddpg.actor))
        tes, tobs = tenv.reset(ttopo, ttraffic, batch=1)
        des, _ = denv.reset(ttopo, ttraffic, batch=1)
        for k in range(steps):
            what = f"episode {ep} step {k}"
            np.testing.assert_allclose(tobs[0].numpy(), np.asarray(jobs),
                                       rtol=RTOL, atol=ATOL, err_msg=what)
            jact = np.array(jd.greedy_action(jparams, jobs))
            with torch.no_grad():
                tact = ddpg.greedy_action(tobs)[0].numpy()
            np.testing.assert_allclose(tact, jact, rtol=1e-5, atol=1e-6,
                                       err_msg=what)
            jes, jobs, jr, jdone, _ = jenv.step(jes, jtopo, jtraffic,
                                                jnp.asarray(jact))
            tes, tobs, tr, tdone, _ = tenv.step(
                tes, ttopo, ttraffic, torch.from_numpy(jact)[None])
            des, *_ = denv.step(des, ttopo, ttraffic,
                                torch.from_numpy(jact)[None])
            np.testing.assert_allclose(tr.numpy()[0], float(jr), rtol=RTOL,
                                       atol=ATOL, err_msg=what)
            assert bool(tdone[0]) == bool(jdone), what
            jc, tc = _counters(jes.sim), _counters(tes.sim)
            for name, want in jc.items():
                np.testing.assert_array_equal(
                    tc[name][0].numpy(), np.asarray(want).astype(
                        tc[name].numpy().dtype), err_msg=f"{what} {name}")
            expired += int((des.sim.placed & ~tes.sim.placed).sum())
        assert int(tes.sim.metrics.generated[0]) > 0
    # the idle-instance expiry ran (kernel #2's gc switch on the card)
    assert expired > 0


def _cli_files(tmp_path, agent=FLAT_AGENT, sim=PERFLOW_SIM):
    (tmp_path / "agent.yaml").write_text(agent)
    (tmp_path / "sim.yaml").write_text(sim)
    return ["--device", "cpu", "--agent-config", str(tmp_path / "agent.yaml"),
            "--simulator-config", str(tmp_path / "sim.yaml"), "--network",
            "abilene", "--no-perf"]


@pytest.mark.parametrize("replicas", [1, 2])
def test_flat_training_under_per_flow_control(tmp_path, replicas):
    base = _cli_files(tmp_path)
    if replicas > 1:
        base += ["--replicas", str(replicas), "--chunk", "3"]
    out = cli.run_train(base + ["--episodes", "2", "--result-dir",
                                str(tmp_path / "r")])
    trainer = out["trainer"]
    assert trainer.env.sim_cfg.controller == "per_flow"
    assert not trainer.agent_cfg.graph_mode
    assert len(trainer.history) == 2 and all(
        np.isfinite(h["episodic_return"]) for h in trainer.history)
    summary = out["summary"]
    assert np.isfinite(summary["mean_return"])
    inf = cli.run_infer(base[:8] + ["--checkpoint", summary["checkpoint"]])
    assert inf["eval"]["mean_return"] == summary["mean_return"]
    assert inf["eval"]["final_succ_ratio"] == summary["final_succ_ratio"]


# ------------------------------------------------------------- hot-swap
def test_flat_train_publishes_across_packages(tmp_path):
    import jax
    from gsc_tpu.serve.fleet import WeightPublisher as JaxPublisher
    from gsc_tpu.serve.fleet import load_version as jload
    from gsc_tpu.serve.fleet import read_latest as jlatest

    hot = tmp_path / "hot"
    base = _cli_files(tmp_path, sim=TINY_SIM)
    out = cli.run_train(base + ["--episodes", "2", "--hot-swap-dir",
                                str(hot), "--publish-interval", "1"])
    rec = jlatest(str(hot))
    assert rec["version"] == 2 and rec["meta"] == {"episode": 2}
    leaves = jload(str(hot), rec)
    want = host_leaves(out["state"].actor)
    assert len(leaves) == len(want) == 4
    for got, w in zip(leaves, want):
        np.testing.assert_array_equal(got, w)
        assert got.dtype == w.dtype
    # the reverse: a flat flax actor published by the JAX package
    jenv, jd, _ = _jax_env_and_agent()
    params = jd.init(jax.random.PRNGKey(1),
                     np.zeros(jenv.obs_dim(), np.float32)).actor_params
    jdir = tmp_path / "jax"
    JaxPublisher(str(jdir)).publish(params, meta={"episode": 1})
    rec = read_latest(str(jdir))
    got = load_version(str(jdir), rec)
    want = [np.asarray(l) for l in jax.tree_util.tree_leaves(params)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _flat_pool(trainer, n=3):
    topo, traffic = trainer._episode(0)
    es, obs = trainer.env.reset(topo, traffic, batch=1)
    pool = []
    for _ in range(n):
        pool.append(obs[0].numpy().copy())
        es, obs, *_ = trainer.env.step(es, topo, traffic,
                                       trainer.ddpg.greedy_action(obs))
    return pool


def test_flat_server_swaps_mid_serve_as_a_fresh_server(tmp_path):
    trainer = _port_stack(sim_kw=SIM_KW)
    trainer.init_state()
    ddpg = trainer.ddpg
    pool = _flat_pool(trainer)
    policy = GreedyServePolicy(ddpg, pool[0])
    v1 = [l + np.float32(1e-2) for l in policy.leaves()]
    srv = PolicyServer(policy, buckets=(1, 2), deadline_ms=1.0,
                       mode="continuous", hot_swap_dir=str(tmp_path),
                       swap_poll_s=60.0, hub=MetricsHub(),
                       graph_mode=False).start()
    try:
        a0 = [srv.submit_sync(o, timeout=60) for o in pool]
        WeightPublisher(str(tmp_path)).publish(v1, meta={"episode": 5})
        assert srv.watcher.poll_once() is True and srv.policy_version == 1
        a1 = [srv.submit_sync(o, timeout=60) for o in pool]
    finally:
        srv.close()
    # a fresh server on v1's weights
    fresh_ddpg = _port_stack(sim_kw=SIM_KW).ddpg
    fresh_ddpg.actor.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in
         zip(ddpg.actor.state_dict(), v1)})
    fresh = PolicyServer(GreedyServePolicy(fresh_ddpg, pool[0]),
                         buckets=(1, 2), deadline_ms=1.0,
                         hub=MetricsHub(), graph_mode=False).start()
    try:
        want1 = [fresh.submit_sync(o, timeout=60) for o in pool]
    finally:
        fresh.close()
    for o, got0, got1, w1 in zip(pool, a0, a1, want1):
        np.testing.assert_array_equal(
            got0, ddpg.greedy_action(torch.from_numpy(o)[None])[0].numpy())
        np.testing.assert_array_equal(got1, w1)
    assert not np.array_equal(a0[0], a1[0]), "the swap test is vacuous"


def test_versions_of_the_other_mode_are_refused(tmp_path, caplog):
    """A graph-mode actor's version is refused by a flat server, by its
    leaves (the refusal names the served mode), and a flat version by a
    graph-mode server likewise; a version of the served mode is then
    taken."""
    from gsc_tpu_torch.config import init_configs_agent
    from gsc_tpu_torch.serve import run_serve

    trainer = _port_stack(sim_kw=SIM_KW)
    trainer.init_state()
    pool = _flat_pool(trainer, n=1)
    flat_policy = GreedyServePolicy(trainer.ddpg, pool[0])
    graph = run_serve(agent=init_configs_agent(
        gnn_features=4, gnn_num_layers=1, gnn_num_iter=1,
        actor_hidden_layer_nodes=(8,), critic_hidden_layer_nodes=(8,)),
        device="cpu", pool_steps=1, requests=1, concurrency=1,
        seeded_actor=True)
    graph_policy = GreedyServePolicy(graph.ddpg, graph.pool[0])
    for policy, other, mode in ((flat_policy, graph_policy, False),
                                (graph_policy, flat_policy, True)):
        d = tmp_path / f"served_{mode}"
        srv = PolicyServer(policy, buckets=(1,), deadline_ms=1.0,
                           hot_swap_dir=str(d), swap_poll_s=60.0,
                           hub=MetricsHub(), graph_mode=mode).start()
        try:
            pub = WeightPublisher(str(d))
            pub.publish(other.leaves())
            with caplog.at_level(logging.WARNING):
                assert srv.watcher.poll_once() is False
            assert f"served actor (graph_mode {str(mode).lower()})" \
                in caplog.text
            assert srv.policy_version == 0
            pub.publish(policy.leaves())
            assert srv.watcher.poll_once() is True
            assert srv.policy_version == 2
        finally:
            srv.close()


def test_run_serve_flat_fleet_fires_swaps(tmp_path):
    """``run_serve`` with a flat agent and ``hot_swap_dir``: a 2-worker
    fleet swaps the fired versions mid-serve and answers every request."""
    from gsc_tpu_torch.serve import run_serve

    report = run_serve(agent=AgentConfig(**dict(FLAT_KW, episode_steps=8)),
                       device="cpu", pool_steps=2, requests=24,
                       concurrency=2, workers=2, seeded_actor=True,
                       hot_swap_dir=str(tmp_path), swap_poll_s=0.01,
                       fire_swaps=2)
    assert not report.errors and len(report.answers) == 24
    assert report.published_versions == 2 and report.swaps == 4
    assert "fired_at" in read_latest(str(tmp_path))["meta"]


@pytest.mark.parametrize("flags", [
    ["--replicas", "2", "--chunk", "3", "--async"],
    ["--replicas", "2", "--chunk", "3", "--mesh", "2x1"]],
    ids=["async", "mesh"])
def test_async_and_mesh_stay_refused_for_flat_agents(tmp_path, flags):
    """What stays refused for a flat agent on ``--async`` and ``--mesh``:
    resuming a checkpoint of the other observation mode (its sidecar says
    graph_mode true), by name, before anything is built or spawned."""
    ck = tmp_path / "graph_ckpt"
    ck.mkdir()
    (tmp_path / "graph_ckpt.meta.json").write_text(
        '{"precision": "f32", "graph_mode": true}')
    with pytest.raises(SystemExit, match="holds a graph_mode true agent"):
        cli.run_train(_cli_files(tmp_path) + [
            "--episodes", "2", *flags, "--resume", str(ck),
            "--hot-swap-dir", str(tmp_path / "hot")])


@pytest.mark.parametrize("flags,summary_key", [
    (["--replicas", "2", "--chunk", "3", "--async"], "drain"),
    (["--replicas", "2", "--chunk", "3", "--mesh", "2x1"], "mesh")],
    ids=["async", "mesh"])
def test_flat_agent_trains_under_async_and_mesh_and_publishes(
        tmp_path, flags, summary_key):
    """A flat agent under per-flow control trains under ``--async`` and
    on ``--mesh 2x1``, publishing to the hot-swap directory (under the
    mesh, rank 0 alone writes it)."""
    out = cli.run_train(_cli_files(tmp_path) + ["--episodes", "1", *flags,
                                                "--hot-swap-dir",
                                                str(tmp_path / "hot")])
    assert summary_key in out["summary"]
    assert len(out["trainer"].history if "trainer" in out
               else out["runs"][0]["history"]) == 1
    assert read_latest(str(tmp_path / "hot"))["version"] >= 1
