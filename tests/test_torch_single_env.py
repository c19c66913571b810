"""The port's single-env training path: ``DDPG.episode_step``,
``Trainer.train`` with exact resume, ``Trainer.evaluate`` and its
test-mode CSVs, the checkpoint manager, and the CLI round trip
``init-configs`` -> ``train --scheduler`` -> ``train --resume`` ->
``infer``.

Sizes: a triangle (and a line of 4 as the inference network) padded to 8
nodes / 8 edges, the abc chain, 10 ms intervals, GATv2 4 features x 1
layer x 1 iteration, actor and critic hidden (8,), 4-step episodes,
batch 4, 2 warm-up steps.  Against the JAX package (imported inside the
tests that use it: this file also runs on the card, where JAX is absent,
``python -m pytest --noconftest tests/test_torch_single_env.py -m cuda``),
with the JAX side's parameters converted and its random draws fed through
``Draws``:

- ``episode_step``: replay integers and booleans exact, floats rtol 1e-5,
  atol 1e-5 (the engine's tolerance); episode stats rtol 1e-5, atol
  1e-5; the learner state after the 4-step learn burst rtol 1e-4, atol
  8e-5 (the reasons are stated in tests/test_torch_train.py, and in the
  test for the network where it holds the rollout alone);
- ``evaluate``: ``mean_return`` and ``final_succ_ratio`` rtol 1e-5, atol
  1e-5; the test-mode CSVs: the same files, headers and rows, integer
  and text cells exact, float cells rtol 1e-5, atol 1e-5, except the
  wall-clock runtimes, whose rows are counted;
- ``init-configs``: the yaml files and the trace byte-equal to the JAX
  package's, the GraphML networks equal once read by the JAX package.

Exact resume (2 episodes, a checkpoint, 2 more against 4 straight, on one
env and on 2 replicas) and the CLI's resume are held bit for bit:
``torch.equal`` on every tensor.
"""
import csv
import json
import math
import os

import numpy as np
import pytest
import torch

from gsc_tpu_torch import cli
from gsc_tpu_torch.agents.ddpg import Draws
from gsc_tpu_torch.agents.trainer import Trainer
from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import (AgentConfig, EnvLimits,
                                         SchedulerConfig, SimConfig)
from gsc_tpu_torch.env.driver import EpisodeDriver
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.resilience import ckpt as ckpt_mod
from gsc_tpu_torch.resilience.ckpt import CheckpointManager, find_resumable
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import compile_topology
from gsc_tpu_torch.utils.checkpoint import (load_full_or_partial,
                                            read_checkpoint_meta,
                                            save_checkpoint,
                                            verify_checkpoint)
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-5
STATE_RTOL, STATE_ATOL, BURST_ATOL = 1e-4, 1e-6, 8e-5
N = E = 8
AGENT_KW = dict(episode_steps=4, gnn_features=4, gnn_num_layers=1,
                gnn_num_iter=1, actor_hidden_layer_nodes=(8,),
                critic_hidden_layer_nodes=(8,), batch_size=4, mem_limit=6,
                nb_steps_warmup_critic=2, objective="prio-flow",
                target_success="auto")
SIM_KW = dict(inter_arrival_mean=2.0, run_duration=10.0,
              ttl_choices=(100.0,))
TRI = dict(node_caps=(2.0, 3.0, 2.0), num_ingress=2)
TINY_AGENT = ("GNN_features: 4\nGNN_num_layers: 1\nGNN_num_iter: 1\n"
              "episode_steps: 3\nactor_hidden_layer_nodes: [8]\n"
              "critic_hidden_layer_nodes: [8]\nbatch_size: 4\nmem_limit: 8\n"
              "nb_steps_warmup_critic: 2\ngnn_impl: pallas\n")
TINY_SIM = ("inter_arrival_mean: 10.0\ndeterministic_arrival: true\n"
            "deterministic_size: true\nflow_dr_mean: 1.0\n"
            "flow_dr_stdev: 0.0\nflow_size_shape: 0.001\nrun_duration: 10\n"
            "ttl_choices: [100]\n")


class _Draws(Draws):
    """Feeds the port the JAX side's numbers: a (uniforms, normals) pair
    per rollout step, a slot-index vector per batch."""

    def __init__(self, steps, batches):
        self.steps, self.batches = list(steps), list(batches)

    def uniform(self, shape):
        return torch.from_numpy(np.array(self.steps.pop(0)[0]))

    def normal(self, shape):
        return torch.from_numpy(np.array(self.steps.pop(0)[1]))

    def slots(self, batch, size):
        return torch.from_numpy(np.array(self.batches.pop(0))).long()

    def sim_noise(self, engine, batch):
        return None


def _port_stack(device="cpu", gnn_impl="pallas", seed=3, replicas=None):
    """A port Trainer over a schedule of the triangle and a line of 4
    (period 1), inferring on the line."""
    agent = AgentConfig(**AGENT_KW, gnn_impl=gnn_impl)
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
    return Trainer(env, driver, agent, seed=seed, device=device)


def _jax_stack(seed=3, gnn_impl="dense", result_dir=None):
    import jax.numpy as jnp  # noqa: F401 - JAX only where a test needs it
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

    agent = JAgent(**AGENT_KW, gnn_impl=gnn_impl)
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


def _traffic(jtraffic):
    from gsc_tpu_torch.sim.state import TrafficSchedule
    return TrafficSchedule(**{f: torch.from_numpy(np.array(getattr(
        jtraffic, f))) for f in TrafficSchedule._RANKS})


@pytest.mark.parametrize("episode", [0, 1])
def test_episode_step_matches_jax(episode):
    """One single-env episode (2 warm-up steps, 2 acting steps) against
    the JAX package's ``DDPG.episode_step`` on the same traffic and draws,
    on the schedule's first network (the triangle) with its learn burst,
    and on its second (the line) without: there two entries of the
    critic encoder's lin_r bias get gradients that are rounding residues
    (1.8e-12 in the port's first step; a bias shift that no logit sees
    once a feature's pre-activation keeps one sign over the graph), which
    Adam (eps 1e-8) turns into steps that depend on the residue, and JAX's
    residues are larger: after the burst those entries part by 1.4e-4."""
    learn = episode == 0
    import jax
    import jax.numpy as jnp
    from test_torch_train import _assert_state, _state_tree

    from gsc_tpu_torch.utils.convert import learner_state_from_jax

    jt, tt = _jax_stack(), _port_stack(gnn_impl="dense")
    jtopo, jtraffic = jt.driver.episode(episode)
    ttopo, ttraffic = tt.driver.episode(episode)
    jes, jobs = jt.env.reset(jax.random.PRNGKey(0), jtopo, jtraffic)
    jd = jt.ddpg
    jstate = jd.init(jax.random.PRNGKey(4), jobs)
    jbuf = jd.init_buffer(jobs)
    a_dim = jd.action_dim
    rng, sub = jax.random.split(jstate.rng)
    sub, _ = jax.random.split(sub)
    steps = []
    for i in range(AGENT_KW["episode_steps"]):
        k1, k2 = jax.random.split(jax.random.fold_in(sub, i))
        steps.append((np.asarray(jax.random.uniform(k1, (a_dim,)))[None],
                      np.asarray(jax.random.normal(k2, (a_dim,)))[None]))
    state_in = _state_tree(jstate)
    jstate, jbuf, _, _, jstats, jm = jd.episode_step(
        jstate, jbuf, jes, jobs, jtopo, jtraffic, jnp.int32(0), None, learn)
    # the burst splits the post-rollout key (the first split's rng)
    _, bsub = jax.random.split(rng)
    batches = [np.asarray(jax.random.randint(
        jax.random.fold_in(bsub, i), (AGENT_KW["batch_size"],), 0,
        jnp.maximum(jbuf.size, 1))) for i in range(AGENT_KW["episode_steps"])
        if learn]

    draws = _Draws(steps, batches)
    tstate = tt.init_state()
    learner_state_from_jax(state_in, tstate)
    tes, tobs = tt.env.reset(ttopo, _traffic(jtraffic), batch=1)
    assert all(torch.equal(getattr(ttraffic, f), getattr(_traffic(jtraffic),
                                                         f))
               for f in ("arr_time", "arr_ingress", "ingress_active"))
    tbuf = tt.ddpg.init_buffer(tobs.map(lambda x: x[0]))
    tstate, tbuf, _, _, stats, tm = tt.ddpg.episode_step(
        tstate, tbuf, tes, tobs, ttopo, _traffic(jtraffic), 0, draws,
        learn=learn)
    assert not draws.steps and not draws.batches
    for k in ("episodic_return", "mean_succ_ratio", "mean_e2e_delay",
              "final_succ_ratio"):
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert int(tbuf.pos) == int(jbuf.pos) and int(tbuf.size) == \
        int(jbuf.size) == 4
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
    assert set(tbuf.data["topo_idx"][:4].tolist()) == {episode}
    if not learn:
        assert tm is None and jm is None
        _assert_state(jstate, tstate, 0, 0, "rollout: ")
        return
    np.testing.assert_allclose(float(tm["critic_loss"]),
                               float(jm["critic_loss"]), rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    _assert_state(jstate, tstate, STATE_RTOL, BURST_ATOL, "episode: ")


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _cells_match(got, want, what):
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        try:
            fa, fb = float(a), float(b)
        except ValueError:
            assert a == b, what
            continue
        if a.lstrip("-").isdigit() and b.lstrip("-").isdigit():
            assert a == b, what
        else:
            assert math.isclose(fa, fb, rel_tol=RTOL, abs_tol=ATOL), \
                (what, a, b)


@pytest.mark.parametrize("telemetry", [False, True])
def test_evaluate_matches_jax(tmp_path, telemetry):
    """Greedy episodes on the inference network with the JAX package's
    parameters converted: the same returns and final success ratios and,
    with telemetry, the same test-mode CSV files."""
    import jax
    from test_torch_train import _state_tree

    from gsc_tpu_torch.utils.convert import learner_state_from_jax

    jt = _jax_stack(result_dir=str(tmp_path / "jax"))
    tt = _port_stack(gnn_impl="dense")
    tt.result_dir = str(tmp_path / "port")
    _, jobs = jt.env.reset(jax.random.PRNGKey(0), *jt.driver.episode(0))
    jstate = jt.ddpg.init(jax.random.PRNGKey(8), jobs)
    tstate = tt.init_state()
    learner_state_from_jax(_state_tree(jstate), tstate)
    kw = dict(episodes=2, test_mode=True, telemetry=telemetry,
              write_schedule=telemetry)
    want, got = jt.evaluate(jstate, **kw), tt.evaluate(tstate, **kw)
    for k in ("mean_return", "final_succ_ratio"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert set(got) == set(want)
    if not telemetry:
        return
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


def _tensors(state, buffer, draws):
    out = {}
    for net in ("actor", "critic", "target_actor", "target_critic"):
        for k, v in getattr(state, net).state_dict().items():
            out[f"{net}.{k}"] = v
    for opt in ("actor_opt", "critic_opt"):
        for i, st in getattr(state, opt).state_dict()["state"].items():
            for k, v in st.items():
                out[f"{opt}.{i}.{k}"] = v
    for k, v in buffer.data.items():
        out[f"replay.{k}"] = v
    out["replay.pos"], out["replay.size"] = buffer.pos, buffer.size
    out["draws"] = draws.generator.get_state()
    return out


def _train(trainer, replicas, episodes, **kw):
    if replicas > 1:
        if "init_buffer" in kw:
            kw["init_buffers"] = kw.pop("init_buffer")
        return trainer.train_parallel(episodes, replicas, chunk=2, **kw)
    return trainer.train(episodes, **kw)


def exact_resume(tmp_path, device, replicas):
    """4 straight episodes against 2, a checkpoint, and 2 more; returns
    the straight trainer."""
    straight = _port_stack(device)
    state_a, buf_a = _train(straight, replicas, 4)
    first = _port_stack(device)
    state_m, buf_m = _train(first, replicas, 2)
    ck = save_checkpoint(str(tmp_path / "ck"), state_m, buffer=buf_m,
                         draws=first.draws, extra={"episode": 2})
    resumed = _port_stack(device)
    state_t, buf_t = resumed.template(replicas)
    restored, full = load_full_or_partial(ck, state_t, buffer=buf_t,
                                          draws=resumed.draws)
    assert full and restored["extra"] == {"episode": 2}
    state_b, buf_b = _train(resumed, replicas, 4, init_state=state_t,
                            init_buffer=buf_t, start_episode=2)
    want = _tensors(state_a, buf_a, straight.draws)
    got = _tensors(state_b, buf_b, resumed.draws)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert [r["episodic_return"] for r in resumed.history] == \
        [r["episodic_return"] for r in straight.history[2:]]
    assert resumed.completed_episodes == 4
    return straight


@pytest.mark.parametrize("replicas", [1, 2])
def test_exact_resume_on_cpu(tmp_path, replicas):
    straight = exact_resume(tmp_path, "cpu", replicas)
    # the schedule switched networks every episode: one ring of 6 holds
    # transitions of both, shards of 3 only the second episode's
    topo_idx = _tensors(*_train(_port_stack(), replicas, 2),
                        straight.draws)["replay.topo_idx"]
    assert set(topo_idx.flatten().tolist()) == \
        ({0, 1} if replicas == 1 else {1})


@pytest.mark.cuda
def test_exact_resume_on_card(tmp_path):
    """On the card, through both kernels: the resumed run equals the
    straight one bit for bit (``torch.equal``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    from gsc_tpu_torch.ops.gat_attention import (gat_attention,
                                                 gat_attention_backward)
    from gsc_tpu_torch.ops.substep import substep_megakernel

    ops = (gat_attention, gat_attention_backward, substep_megakernel)
    before = [op.launches for op in ops]
    exact_resume(tmp_path, "cuda", 1)
    assert all(op.launches > n for op, n in zip(ops, before))


def corrupt_checkpoint(path):
    """Truncate a checkpoint's largest file to half (what a writer killed
    mid-save leaves behind); returns that file's path."""
    files = [os.path.join(r, n) for r, _, ns in os.walk(path) for n in ns]
    target = max(files, key=os.path.getsize)
    with open(target, "r+b") as f:
        f.truncate(max(os.path.getsize(target) // 2, 1))
    return target


def test_checkpoint_manager_rotates_and_resume_auto_falls_back(
        tmp_path, monkeypatch):
    trainer = _port_stack()
    state, buf = trainer.train(1)
    mgr = CheckpointManager(str(tmp_path / "ckpts"), retain=2,
                            meta={"precision": "f32"})
    paths = [mgr.save(state, buf, episode=e, draws=trainer.draws)
             for e in (1, 2, 3)]
    assert sorted(os.listdir(mgr.root)) == [
        "ep00000002", "ep00000002.meta.json", "ep00000003",
        "ep00000003.meta.json", "last_good.json"]
    with open(mgr.pointer_path) as f:
        pointer = json.load(f)
    assert pointer["path"] == paths[2] and pointer["episode"] == 3
    assert read_checkpoint_meta(paths[2]) == {
        "precision": "f32", "episode": 3,
        "checksum": pointer["checksum"], "checksum_algo": "sha256-tree"}
    assert find_resumable(str(tmp_path)) == paths[2] == \
        find_resumable(mgr.root)
    # a damaged newest checkpoint falls back to the one before
    assert corrupt_checkpoint(paths[2]).endswith(".pt")
    assert not verify_checkpoint(paths[2])
    assert find_resumable(str(tmp_path)) == paths[1]
    # a write that fails validation is written again; one that fails
    # twice keeps the pointer where it was
    checks = []

    def flaky(path, fail):
        checks.append(path)
        if len(checks) <= fail:
            corrupt_checkpoint(path)
        return verify_checkpoint(path)

    monkeypatch.setattr(ckpt_mod, "verify_checkpoint",
                        lambda p: flaky(p, 1))
    again = mgr.save(state, buf, episode=4, draws=trainer.draws)
    assert again and len(checks) == 2 and verify_checkpoint(again)
    checks.clear()
    monkeypatch.setattr(ckpt_mod, "verify_checkpoint",
                        lambda p: flaky(p, 2))
    assert mgr.save(state, buf, episode=5, draws=trainer.draws) is None
    with open(mgr.pointer_path) as f:
        assert json.load(f)["episode"] == 4
    restored, full = load_full_or_partial(again, *trainer.template(1),
                                          draws=Draws(0, "cpu"))
    assert full and restored["extra"] == {"episode": 4}


def test_train_checkpoints_periodically_and_skips_a_poisoned_state(
        tmp_path):
    trainer = _port_stack()
    mgr = CheckpointManager(str(tmp_path / "c"), retain=5)
    trainer.train(3, ckpt_manager=mgr, ckpt_interval=2)
    assert find_resumable(str(tmp_path)).endswith("ep00000002")
    poisoned = _port_stack()
    state = poisoned.init_state()
    with torch.no_grad():
        next(state.actor.parameters()).fill_(float("nan"))
    poisoned.train(3, init_state=state,
                   ckpt_manager=CheckpointManager(str(tmp_path / "p")),
                   ckpt_interval=1)
    assert find_resumable(str(tmp_path / "p")) is None


def _configs(tmp_path):
    (tmp_path / "agent.yaml").write_text(TINY_AGENT)
    (tmp_path / "sim.yaml").write_text(TINY_SIM)
    return ["--device", "cpu", "--agent-config", str(tmp_path / "agent.yaml"),
            "--simulator-config", str(tmp_path / "sim.yaml")]


def test_init_configs_writes_the_jax_files(tmp_path):
    from click.testing import CliRunner

    from gsc_tpu.cli import cli as j_cli
    from gsc_tpu.topology.compiler import read_graphml as j_read

    res = CliRunner().invoke(j_cli, ["init-configs", "--out",
                                     str(tmp_path / "jax")])
    assert res.exit_code == 0, res.output
    assert cli.main(["init-configs", "--out", str(tmp_path / "port")]) == 0
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    files = sorted(p.relative_to(jdir) for p in jdir.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tdir) for p in tdir.rglob("*")
                           if p.is_file())
    for rel in files:
        if rel.suffix == ".graphml":
            assert vars(j_read(str(tdir / rel))) == vars(j_read(str(jdir
                                                                  / rel)))
        else:
            want = (jdir / rel).read_text().replace(str(jdir), "OUT")
            assert (tdir / rel).read_text().replace(str(tdir), "OUT") == \
                want, rel


def test_cli_round_trip_on_cpu(tmp_path, capsys):
    """``init-configs``, then ``train --scheduler`` over two of its
    networks (switching every episode) with the unseen third as the
    inference network, ``train --resume`` from the checkpoint and
    ``--resume auto``, and ``infer``; the resumed run's final state equals
    a straight run's bit for bit."""
    from gsc_tpu_torch.ops.gat_attention import gat_attention
    from gsc_tpu_torch.ops.substep import substep_megakernel

    cfg = _configs(tmp_path)
    assert cli.main(["init-configs", "--out", str(tmp_path / "c")]) == 0
    nets = tmp_path / "c" / "networks"
    sched = tmp_path / "sched.yaml"
    sched.write_text(
        f"training_network_files: [{nets / 'triangle.graphml'}, "
        f"{nets / 'line3.graphml'}]\n"
        f"inference_network: {nets / 'compuserve-in4-cap1.graphml'}\n"
        "period: 1\n")
    args = cfg + ["--scheduler", str(sched), "--max-nodes", "16",
                  "--max-edges", "20"]
    before = (gat_attention.launches, substep_megakernel.launches)

    def last_line():
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    first = cli.run_train(args + ["--episodes", "2", "--result-dir",
                                  str(tmp_path / "r1")])
    out1 = last_line()
    assert out1["replicas"] == 1 and out1["start_episode"] == 0
    assert out1["checkpoint"] == str(tmp_path / "r1" / "checkpoint")
    assert verify_checkpoint(out1["checkpoint"])
    assert read_checkpoint_meta(out1["checkpoint"])["episode"] == 2
    for k in ("mean_return", "final_succ_ratio", "compile_warmup_s",
              "steady_s", "total_s"):
        assert k in out1 and k in first["eval"]
    rows = (tmp_path / "r1" / "rewards.csv").read_text().split()
    assert rows[0] == "r" and len(rows) == 3
    assert (tmp_path / "r1" / "test" / "metrics.csv").exists()
    assert first["buffers"].size.item() == 6

    resumed = cli.run_train(args + ["--episodes", "3", "--resume",
                                    out1["checkpoint"], "--result-dir",
                                    str(tmp_path / "r2")])
    out2 = last_line()
    assert out2["start_episode"] == 2 and out2["ckpt_load_s"] is not None
    assert [r["episode"] for r in resumed["trainer"].history] == [2]
    straight = cli.run_train(args + ["--episodes", "3", "--result-dir",
                                     str(tmp_path / "r0")])
    capsys.readouterr()
    want = _tensors(straight["state"], straight["buffers"],
                    straight["trainer"].draws)
    got = _tensors(resumed["state"], resumed["buffers"],
                   resumed["trainer"].draws)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    auto = cli.run_train(args + ["--episodes", "4", "--resume", "auto",
                                 "--result-dir", str(tmp_path / "r2")])
    assert last_line()["start_episode"] == 3
    assert [r["episode"] for r in auto["trainer"].history] == [3]
    with pytest.raises(SystemExit, match="must exceed"):
        cli.run_train(args + ["--episodes", "2", "--resume",
                              out1["checkpoint"]])
    with pytest.raises(SystemExit, match="contradicts"):
        cli.run_train(args + ["--episodes", "3", "--precision", "bf16",
                              "--resume", out1["checkpoint"]])

    inferred = cli.run_infer(cfg + ["--scheduler", str(sched),
                                    "--max-nodes", "16", "--max-edges", "20",
                                    "--checkpoint", out1["checkpoint"],
                                    "--episodes", "2"])
    assert last_line() == inferred["eval"]
    for k, v in first["state"].actor.state_dict().items():
        assert torch.equal(inferred["state"].actor.state_dict()[k], v), k
    assert math.isfinite(inferred["eval"]["mean_return"])
    # no kernel ran on the CPU
    assert (gat_attention.launches, substep_megakernel.launches) == before


def test_cli_train_replicas_resume_keeps_its_returns(tmp_path, capsys):
    """``--replicas 2``: 1 episode, then ``--resume`` to 2 equals 2
    straight, through the CLI (the replica shards restored)."""
    args = _configs(tmp_path) + ["--replicas", "2", "--chunk", "1",
                                 "--network", "abilene"]
    cli.run_train(args + ["--episodes", "1", "--result-dir",
                          str(tmp_path / "a")])
    ck = str(tmp_path / "a" / "checkpoint")
    resumed = cli.run_train(args + ["--episodes", "2", "--resume", ck])
    straight = cli.run_train(args + ["--episodes", "2"])
    capsys.readouterr()
    assert resumed["summary"]["checkpoint"] is None
    assert resumed["trainer"].history[-1]["episodic_return"] == \
        straight["trainer"].history[-1]["episodic_return"]
    assert torch.equal(resumed["buffers"].data["action"],
                       straight["buffers"].data["action"])
