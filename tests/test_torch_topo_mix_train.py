"""Generalization training on the port: ``cli train --replicas B`` under a
registry ``--topo-mix`` and a ``factory:`` mix with the TD curriculum,
the CLI's refusals (the JAX CLI's, gsc_tpu/cli.py:622-650), the default
on-device traffic of the replica path, and one mixed-batch rollout
against the JAX package's ``ParallelDDPG`` (what its ``train_parallel``
runs per chunk) on the same host mix traffic with converted parameters.

Tolerances: the rollout's rewards and the replay's float rows rtol 1e-5
/ atol 1e-5 (the engine's, tests/test_torch_env.py: f32 sums in another
order), integers and booleans exact; the curriculum's weights sum to 1
within 1e-9 and stay at or above floor / K."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsc_tpu.config.catalog import abc_service as j_abc
from gsc_tpu.config.schema import AgentConfig as JAgent
from gsc_tpu.config.schema import EnvLimits as JLimits
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.env.env import ServiceCoordEnv as JEnv
from gsc_tpu.parallel.dp import ParallelDDPG as JParallel
from gsc_tpu.topology import DEFAULT_REGISTRY as J_REGISTRY
from gsc_tpu.topology import TopologyBucket as JBucket
from gsc_tpu.topology import build_mix_entries as j_build
from gsc_tpu.topology import plan_mix as j_plan
from gsc_tpu.topology.scenarios import mix_traffic_host as j_mix_traffic

from gsc_tpu_torch import cli
from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import AgentConfig, EnvLimits, SimConfig
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.parallel.dp import ParallelDDPG
from gsc_tpu_torch.topology.compiler import TopologyBucket
from gsc_tpu_torch.topology.scenarios import (DEFAULT_REGISTRY,
                                              build_mix_entries,
                                              mix_traffic_host, plan_mix)
from gsc_tpu_torch.utils.convert import learner_state_from_jax
from test_torch_train import _state_tree
from torch_port_helpers import numpy_traffic_path
from torch_port_helpers import one_torch_thread  # noqa: F401

REGISTRY_MIX = "schedule,abilene+bursty,star12~link@1.0,random12:7"
FACTORY_MIX = "factory:all+shapes~faults"
AGENT_YAML = ("GNN_features: 8\nGNN_num_layers: 2\nGNN_num_iter: 1\n"
              "episode_steps: 4\nactor_hidden_layer_nodes: [32]\n"
              "critic_hidden_layer_nodes: [32]\nbatch_size: 4\n"
              "mem_limit: 32\nnb_steps_warmup_critic: 2\ngnn_impl: pallas\n")
SIM_YAML = ("inter_arrival_mean: 10.0\ndeterministic_arrival: true\n"
            "deterministic_size: true\nflow_dr_mean: 1.0\n"
            "flow_dr_stdev: 0.0\nflow_size_shape: 0.001\nrun_duration: 10\n"
            "ttl_choices: [100]\n")
RTOL = ATOL = 1e-5


@pytest.fixture
def cfg(tmp_path):
    (tmp_path / "agent.yaml").write_text(AGENT_YAML)
    (tmp_path / "sim.yaml").write_text(SIM_YAML)
    return ["--device", "cpu", "--agent-config", str(tmp_path / "agent.yaml"),
            "--simulator-config", str(tmp_path / "sim.yaml")]


def _train(cfg, *extra):
    return cli.run_train(cfg + ["--replicas", "4", "--chunk", "2",
                                "--episodes", "2", *extra])


def test_cli_train_registry_mix(cfg, capsys):
    """Two episodes over the schedule, a shaped Abilene, a star with a
    dead link and a seeded random network: per-replica networks in the
    replay, per-entry returns in the episode events, per-entry |TD| in
    the learn signal, finite losses."""
    out = _train(cfg, "--topo-mix", REGISTRY_MIX)
    capsys.readouterr()
    trainer = out["trainer"]
    names = ["abilene", "abilene+bursty", "star12~link@1.0", "random12:7"]
    assert trainer.driver.topo_id_names == names
    assert out["buffers"].data["topo_idx"][:, 0].tolist() == [0, 1, 2, 3]
    assert all(np.isfinite(h["episodic_return"]) and
               np.isfinite(h["critic_loss"]) for h in trainer.history)
    events = trainer.obs.events
    ep = events.of_kind("episode")[-1]
    assert set(ep["per_topology_return"]) == set(names)
    assert ep["topology"] == names
    sig = events.of_kind("learn_signal")
    assert len(sig) == 2 and set(sig[-1]["per_topology_td"]) <= set(names)
    assert events.of_kind("run_start")[0]["topo_mix"] == REGISTRY_MIX
    assert "scenario_regen" in trainer.phase_timer.summary()


def test_cli_train_factory_mix_with_curriculum(cfg, capsys):
    """Two factory episodes: one curriculum event per episode whose
    weights sum to 1 with every family at or above floor / K, the
    ``curriculum_weight`` gauges, per-family |TD| attribution, and the
    replay's topo_idx naming sampled families."""
    out = _train(cfg, "--topo-mix", FACTORY_MIX,
                 "--curriculum-floor", "0.4",
                 "--curriculum-temperature", "0.5")
    capsys.readouterr()
    trainer = out["trainer"]
    fams = ["star", "ring", "line", "random"]
    cur = trainer.obs.events.of_kind("curriculum")
    assert [c["episode"] for c in cur] == [0, 1]
    w = cur[-1]["weights"]
    assert list(w) == fams
    assert abs(sum(w.values()) - 1.0) < 1e-5
    assert min(w.values()) >= 0.4 / 4 - 1e-6
    assert trainer.curriculum.updates == 2
    assert trainer.curriculum.weights().sum() == pytest.approx(1.0,
                                                               abs=1e-9)
    snap = trainer.obs.hub.snapshot()
    assert all(any("curriculum_weight" in k and f'family="{f}"' in k
                   for k in snap) for f in fams)
    sig = trainer.obs.events.of_kind("learn_signal")[-1]
    assert sig["per_topology_td"] and set(sig["per_topology_td"]) <= set(fams)
    idx = out["buffers"].data["topo_idx"]
    assert ((idx >= 0) & (idx < 4)).all()
    start = trainer.obs.events.of_kind("run_start")[0]
    assert start["curriculum"] == {"temperature": 0.5, "floor": 0.4}
    assert all(np.isfinite(h["episodic_return"]) for h in trainer.history)


@pytest.mark.parametrize("argv, message", [
    (["--topo-mix", "abilene,ring5"], "requires the replica-parallel"),
    (["--replicas", "4", "--topo-mix", "abilene+warp"],
     "--topo-mix: unknown traffic shape"),
    (["--replicas", "4", "--topo-mix", "factory:star,abilene"],
     "--topo-mix: a factory mix fills"),
    (["--replicas", "4", "--curriculum-floor", "0.5"],
     "--curriculum-\\* steers"),
    (["--replicas", "4", "--topo-mix", "factory:all",
      "--curriculum-floor", "1.5"], "floor must be in"),
    (["--replicas", "4", "--topo-mix", "factory:all",
      "--curriculum-temperature", "0"], "temperature must be > 0"),
    (["--replicas", "4", "--topo-mix", "star40"], "does not fit bucket"),
])
def test_cli_refuses_as_jax(cfg, argv, message):
    with pytest.raises(SystemExit, match=message):
        cli.run_train(cfg + ["--episodes", "1"] + argv)


def test_trainer_refusals(cfg, capsys):
    out = _train(cfg, "--topo-mix", FACTORY_MIX, "--episodes", "1")
    capsys.readouterr()
    trainer = out["trainer"]
    with pytest.raises(ValueError, match="on-device"):
        trainer.train_parallel(1, 4, chunk=2, device_traffic=False)
    with pytest.raises(ValueError, match="replica-parallel"):
        trainer.train(1)


def test_replica_run_samples_traffic_on_the_device(cfg, capsys,
                                                   monkeypatch):
    """The default ``--replicas B`` run draws every episode's traffic
    with ``DeviceTraffic`` (the JAX CLI's default,
    ``train_parallel(device_traffic=True)``); ``device_traffic=False``
    takes the host traffic and no device sampler."""
    from gsc_tpu_torch.sim.traffic_device import DeviceTraffic

    calls = []
    real = DeviceTraffic.sample_batch
    monkeypatch.setattr(DeviceTraffic, "sample_batch",
                        lambda self, g, b: calls.append(b) or real(self, g,
                                                                   b))
    out = _train(cfg, "--network", "abilene")
    capsys.readouterr()
    assert calls == [4, 4]
    calls.clear()
    host = out["trainer"]
    host.train_parallel(1, 4, chunk=2, device_traffic=False)
    assert calls == []


def test_mixed_rollout_matches_jax(monkeypatch):
    """One mixed-batch rollout (4 replicas over a triangle, a line with a
    dead link from interval 1 and a ring) through the port's
    ``ParallelDDPG`` and the JAX package's, on the same host mix traffic
    and converted parameters, past the warm-up with no exploration noise:
    per-replica rewards and every replay row agree."""
    numpy_traffic_path(monkeypatch)
    mix, b, steps, n = "triangle,line3~link@1.0,ring5", 4, 3, 8
    kw = dict(episode_steps=steps, gnn_features=8, gnn_num_layers=2,
              gnn_num_iter=1, actor_hidden_layer_nodes=(32,),
              critic_hidden_layer_nodes=(32,), batch_size=4, mem_limit=16,
              nb_steps_warmup_critic=2, objective="prio-flow",
              rand_sigma=0.0, rand_mu=0.0, gnn_impl="dense")
    sim = dict(ttl_choices=(100.0,), max_flows=32, inter_arrival_mean=4.0,
               run_duration=20.0)
    jenv = JEnv(j_abc(), JSim(**sim), JAgent(**kw),
                JLimits.for_service(j_abc(), max_nodes=n, max_edges=n))
    tenv = ServiceCoordEnv(abc_service(), SimConfig(**sim), AgentConfig(**kw),
                           EnvLimits.for_service(abc_service(), max_nodes=n,
                                                 max_edges=n))
    jb, tb = JBucket(n, n), TopologyBucket(n, n)
    jplan = j_plan(j_build(mix, J_REGISTRY, jb), b, jb, jenv.sim_cfg, steps)
    tplan = plan_mix(build_mix_entries(mix, DEFAULT_REGISTRY, tb), b, tb,
                     tenv.sim_cfg, steps)
    jtr = j_mix_traffic(jplan, jenv.sim_cfg, jenv.service, steps,
                        seed_for=lambda r: 50 + r)
    ttr = mix_traffic_host(tplan, tenv.sim_cfg, tenv.service, steps,
                           seed_for=lambda r: 50 + r)

    jp = JParallel(jenv, jenv.agent, num_replicas=b,
                   per_replica_topology=True)
    es, jobs = jp.reset_all(jax.random.PRNGKey(0), jplan.topo, jtr)
    one = jax.tree_util.tree_map(lambda x: x[0], jobs)
    jstate = jp.init(jax.random.PRNGKey(1), one)
    jbuf = jp.init_buffers(one)
    jstate, jbuf, es, jobs, jstats = jp.rollout_episodes(
        jstate, jbuf, es, jobs, jplan.topo, jtr, jnp.int32(10 ** 6))

    tp = ParallelDDPG(tenv, tenv.agent, b, device="cpu")
    tstate = tp.init(torch.Generator().manual_seed(0))
    learner_state_from_jax(_state_tree(jstate), tstate)
    tes, tobs = tp.reset_all(tplan.topo, ttr)
    tbuf = tp.init_buffers(tobs.map(lambda x: x[0]))
    tstate, tbuf, tes, tobs, tstats = tp.rollout_episodes(
        tstate, tbuf, tes, tobs, tplan.topo, ttr, 10 ** 6, steps)

    np.testing.assert_allclose(tstats["per_replica_return"].numpy(),
                               np.asarray(jstats["per_replica_return"]),
                               rtol=RTOL, atol=ATOL)
    jleaves = {"/".join(str(getattr(p, "key", getattr(p, "name", p)))
                        for p in path): leaf
               for path, leaf in
               jax.tree_util.tree_flatten_with_path(jbuf.data)[0]}
    assert len(jleaves) == len(tbuf.data)
    for name, got in tbuf.data.items():
        want = np.asarray(jleaves[name.replace(".", "/")])[:, :steps]
        got = got[:, :steps].numpy()
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    assert tbuf.data["topo_idx"][:, 0].tolist() == [0, 1, 2, 0]
