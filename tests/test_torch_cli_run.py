"""The port's default ``cli train`` run and ``cli simulate`` against the
JAX package's, on the CPU at the tiny sizes of
tests/test_torch_single_env.py.

- a default ``run_train`` (pipeline, observer, learn ledger, cost
  ledger and rollback on) writes ``events.jsonl``, ``metrics.json``,
  ``series.json``, ``curves.json``, ``perf.json``, ``result.yaml`` and
  ``run.log``; its event kinds are the JAX ``cli train`` run's set minus
  ``compile`` (the port's compile monitor reports kernel-library builds
  and loads, of which a CPU run has none but the native traffic
  sampler's); ``run_start`` records the
  ledger and the monitor on; ``tools/obs_report.py`` exits 0 on it and
  ``tools/bench_diff.py ingest`` finds its ``curves_<run>`` and
  ``perf_<run>`` rows; the last ``series.json`` point
  of each episode gauge equals ``metrics.json``; ``run.log`` has the
  episode lines and the package logger still propagates to the root's
  handlers;
- ``--runs 2`` reports the run ``select_best_agent`` picks;
- ``simulate`` on Abilene equals the JAX ``cli simulate``: the integer
  fields exactly, ``avg_end2end_delay`` to rel 1e-6 (both packages'
  native traffic sampler), also under ``controller: per_flow``
  (the local per-flow algorithm, the default ``--per-flow-algo``);
- one bf16 single-env episode (2 warm-up steps, 2 acting steps, the
  4-step learn burst) against the JAX package's ``DDPG.episode_step`` on
  the same traffic and draws: episode stats rtol 1e-5, atol 1e-5 (the
  engine's tolerance); the bf16 replay's float leaves within 2^-7 of each
  leaf's largest entry (one to two bf16 ulps, the actor's bf16 rounding
  boundaries as in tests/test_torch_precision.py), integers exact; the
  burst's losses within relative 2^-3 (tests/test_torch_precision.py's
  BURST_REL, for the same reason), the masters f32.
"""
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsc_tpu_torch import cli
from gsc_tpu_torch.utils.experiment import select_best_agent
from test_torch_single_env import (AGENT_KW, TINY_AGENT, TINY_SIM, _Draws,
                                   _jax_stack, _port_stack, _traffic)
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# event kinds of the JAX run that a CPU run of the port has no source
# for: the JAX jit traces' compile events (the port's are kernel builds)
NOT_PORTED_EVENTS = {"compile"}


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg")
    cli.init_configs(str(d / "c"))
    (d / "agent.yaml").write_text(TINY_AGENT.replace("gnn_impl: pallas\n",
                                                     ""))
    (d / "sim.yaml").write_text(TINY_SIM)
    nets = d / "c" / "networks"
    (d / "sched.yaml").write_text(
        f"training_network_files: [{nets / 'triangle.graphml'}, "
        f"{nets / 'line3.graphml'}]\n"
        f"inference_network: {nets / 'line3.graphml'}\nperiod: 1\n")
    return d


def _port_args(d):
    return ["--device", "cpu", "--agent-config", str(d / "agent.yaml"),
            "--simulator-config", str(d / "sim.yaml"), "--service",
            str(d / "c" / "service_abc.yaml"), "--scheduler",
            str(d / "sched.yaml"), "--max-nodes", "8", "--max-edges", "8"]


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_default_run_writes_what_the_tools_read(configs, tmp_path, capsys):
    import jax
    from click.testing import CliRunner

    from gsc_tpu.cli import cli as j_cli

    jax.config.update("jax_platforms", "cpu")
    d = configs
    res = CliRunner().invoke(j_cli, [
        "train", str(d / "agent.yaml"), str(d / "sim.yaml"),
        str(d / "c" / "service_abc.yaml"), str(d / "sched.yaml"),
        "--episodes", "3", "--result-dir", str(tmp_path / "j"),
        "--max-nodes", "8", "--max-edges", "8"], catch_exceptions=False)
    assert res.exit_code == 0, res.output
    jrun = json.loads(res.output.strip().splitlines()[-1])["result_dir"]
    jkinds = {e["event"] for e in _events(os.path.join(jrun,
                                                       "events.jsonl"))}

    run = tmp_path / "t"
    out = cli.run_train(_port_args(d) + ["--episodes", "3", "--result-dir",
                                         str(run)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["runs"] == 1 and last["all_result_dirs"] == [str(run)]
    for name in ("events.jsonl", "metrics.json", "series.json",
                 "curves.json", "perf.json", "result.yaml", "run.log",
                 "rewards.csv"):
        assert (run / name).is_file(), name
    events = _events(run / "events.jsonl")
    # the port's only compile source on the CPU: the native traffic
    # sampler's build and load, when this is the process's first run
    kinds = {e["event"] for e in events} - {"compile"}
    assert kinds == jkinds - NOT_PORTED_EVENTS
    assert {e["fn"].rsplit("_", 1)[0] for e in events
            if e["event"] == "compile"} <= {"traffic_gen"}
    start = events[0]
    assert start["event"] == "run_start" and start["pipeline"] is True
    assert start["perf"] is True and start["compile_events"] is True
    # the cost ledger: the JAX run's entry names and fields (a compiled
    # executable's memory residency aside)
    with open(os.path.join(jrun, "perf.json")) as f:
        jperf = json.load(f)
    with open(run / "perf.json") as f:
        tperf = json.load(f)
    assert set(tperf["entries"]) == set(jperf["entries"]) == {"episode_step"}
    assert set(jperf["entries"]["episode_step"]) - {"memory"} <= \
        set(tperf["entries"]["episode_step"])
    assert tperf["schema_version"] == jperf["schema_version"] == 1
    assert [e["episode"] for e in events if e["event"] == "episode"] == \
        [0, 1, 2]
    assert [e["topology"] for e in events if e["event"] == "episode"] == \
        ["triangle.graphml", "line3.graphml", "triangle.graphml"]
    assert events[-1]["event"] == "run_end" and \
        events[-1]["status"] == "ok"
    assert out["trainer"].history[-1]["state_finite"] == 1.0
    # run.log has the episode lines, and the package logger still hands
    # its records to the root's handlers (a host program's log capture)
    assert "episode=2 return=" in (run / "run.log").read_text()
    assert logging.getLogger("gsc_tpu_torch").propagate

    with open(run / "metrics.json") as f:
        metrics = json.load(f)["metrics"]
    with open(run / "series.json") as f:
        series = json.load(f)["series"]
    for name in ("sps", "episodic_return"):
        key = f'gsc_{name}{{run="t",seed="0"}}'
        assert series[key][-1][1] == metrics[key], name
    with open(run / "curves.json") as f:
        curves = json.load(f)
    assert curves["episodes"] == 3 and "td_abs_mean" in curves["series"]

    rep = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                       "obs_report.py"),
                          str(run)], capture_output=True, text=True)
    assert rep.returncode == 0, rep.stderr
    assert "learning dynamics" in rep.stdout
    rows = tmp_path / "rows.json"
    ing = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                       "bench_diff.py"),
                          "ingest", "--scan", str(run), "--out", str(rows)],
                         capture_output=True, text=True)
    assert ing.returncode == 0, ing.stderr
    with open(rows) as f:
        got = json.load(f)["rows"]
    assert "curves_t" in got and "perf_t" in got


def test_runs_two_reports_the_best(configs, tmp_path, capsys):
    out = cli.run_train(_port_args(configs) + [
        "--episodes", "2", "--runs", "2", "--result-dir",
        str(tmp_path / "r"), "--obs-dir", str(tmp_path / "o"),
        "--no-pipeline"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    dirs = last["all_result_dirs"]
    assert last["runs"] == 2 and len(dirs) == 2 and len(set(dirs)) == 2
    assert all(os.path.dirname(os.path.dirname(p)) == str(tmp_path / "r")
               for p in dirs)
    assert last["result_dir"] == os.path.abspath(select_best_agent(dirs))
    assert out["result_dir"] == select_best_agent(dirs)
    assert [o["trainer"].seed for o in out["runs"]] == [0, 1]
    for k in (0, 1):
        assert (tmp_path / "o" / f"run{k}" / "events.jsonl").is_file()
    with pytest.raises(SystemExit, match="--runs 1"):
        cli.run_train(_port_args(configs) + ["--runs", "2", "--resume",
                                             "auto", "--result-dir",
                                             str(tmp_path / "r")])
    with pytest.raises(SystemExit, match="needs the run observer"):
        cli.run_train(_port_args(configs) + ["--no-obs", "--metrics-port",
                                             "9"])


SIM_YAML = ("inter_arrival_mean: 10.0\ndeterministic_arrival: true\n"
            "flow_dr_mean: 1.0\nflow_size_shape: 0.001\n"
            "deterministic_size: true\nrun_duration: 100\n"
            "ttl_choices: [100]\n")


def test_simulate_matches_jax(tmp_path, capsys):
    from click.testing import CliRunner

    from gsc_tpu.cli import cli as j_cli

    from gsc_tpu_torch.topology.synthetic import abilene, write_graphml

    write_graphml(abilene(), str(tmp_path / "abilene.graphml"))
    (tmp_path / "sim.yaml").write_text(SIM_YAML)
    cli.init_configs(str(tmp_path / "c"))
    args = ["-d", "500", "-n", str(tmp_path / "abilene.graphml"), "-sf",
            str(tmp_path / "c" / "service_abc.yaml"), "-c",
            str(tmp_path / "sim.yaml")]
    res = CliRunner().invoke(j_cli, ["simulate", *args],
                             catch_exceptions=False)
    want = json.loads(res.output.strip().splitlines()[-1])
    assert cli.main(["simulate", *args, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for k in ("total_flows", "successful_flows", "dropped_flows",
              "drop_reasons"):
        assert got[k] == want[k], k
    assert want["total_flows"] > 0
    assert got["avg_end2end_delay"] == pytest.approx(
        want["avg_end2end_delay"], rel=1e-6)
    (tmp_path / "pf.yaml").write_text(SIM_YAML + "controller: per_flow\n")
    pf_args = [*args[:-1], str(tmp_path / "pf.yaml")]
    res = CliRunner().invoke(j_cli, ["simulate", *pf_args],
                             catch_exceptions=False)
    want_pf = json.loads(res.output.strip().splitlines()[-1])
    assert cli.main(["simulate", *pf_args, "--device", "cpu"]) == 0
    got_pf = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("total_flows", "successful_flows", "dropped_flows",
              "drop_reasons"):
        assert got_pf[k] == want_pf[k], k
    assert got_pf["avg_end2end_delay"] == pytest.approx(
        want_pf["avg_end2end_delay"], rel=1e-6)
    assert got_pf != got


def test_bf16_single_env_episode_matches_jax(monkeypatch):
    import jax
    import jax.numpy as jnp
    from test_torch_train import _state_tree

    from gsc_tpu_torch.utils.convert import learner_state_from_jax

    monkeypatch.setitem(AGENT_KW, "precision", "bf16")
    jt, tt = _jax_stack(), _port_stack(gnn_impl="dense")
    assert tt.agent_cfg.precision == "bf16"
    jtopo, jtraffic = jt.driver.episode(0)
    ttopo, _ = tt.driver.episode(0)
    jes, jobs = jt.env.reset(jax.random.PRNGKey(0), jtopo, jtraffic)
    jd = jt.ddpg
    jstate = jd.init(jax.random.PRNGKey(4), jobs)
    jbuf = jd.init_buffer(jobs)
    rng, sub = jax.random.split(jstate.rng)
    sub, _ = jax.random.split(sub)
    steps = []
    for i in range(AGENT_KW["episode_steps"]):
        k1, k2 = jax.random.split(jax.random.fold_in(sub, i))
        steps.append((np.asarray(jax.random.uniform(k1, (jd.action_dim,)))
                      [None], np.asarray(jax.random.normal(
                          k2, (jd.action_dim,)))[None]))
    state_in = _state_tree(jstate)
    jstate, jbuf, _, _, jstats, jm = jd.episode_step(
        jstate, jbuf, jes, jobs, jtopo, jtraffic, jnp.int32(0), None, True)
    _, bsub = jax.random.split(rng)
    batches = [np.asarray(jax.random.randint(
        jax.random.fold_in(bsub, i), (AGENT_KW["batch_size"],), 0,
        jnp.maximum(jbuf.size, 1))) for i in range(AGENT_KW["episode_steps"])]

    draws = _Draws(steps, batches)
    tstate = tt.init_state()
    learner_state_from_jax(state_in, tstate)
    tes, tobs = tt.env.reset(ttopo, _traffic(jtraffic), batch=1)
    tbuf = tt.ddpg.init_buffer(tobs.map(lambda x: x[0]))
    tstate, tbuf, _, _, stats, tm = tt.ddpg.episode_step(
        tstate, tbuf, tes, tobs, ttopo, _traffic(jtraffic), 0, draws,
        learn=True)
    assert not draws.steps and not draws.batches
    for k in ("episodic_return", "mean_succ_ratio", "mean_e2e_delay",
              "final_succ_ratio"):
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    jleaves = dict(zip(
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(jbuf.data)[0]],
        jax.tree_util.tree_leaves(jbuf.data)))
    n_bf16 = 0
    for name, t in tbuf.data.items():
        path = "".join(f"['{p}']" if i == 0 else f".{p}"
                       for i, p in enumerate(name.split(".")))
        want = np.asarray(jleaves[path].astype(jnp.float32)) \
            if jleaves[path].dtype == jnp.bfloat16 else np.asarray(
                jleaves[path])
        if jleaves[path].dtype == jnp.bfloat16:
            n_bf16 += 1
            assert t.dtype == torch.bfloat16, name
        got = t.float().numpy() if t.is_floating_point() else t.numpy()
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)
        else:
            bound = 2.0 ** -7 * max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(got - want).max()) <= bound, name
    assert n_bf16 >= 3
    for k in ("critic_loss", "actor_loss"):
        assert abs(float(tm[k]) - float(jm[k])) <= 2.0 ** -3 * abs(
            float(jm[k])), k
    for net in ("actor", "critic", "target_actor", "target_critic"):
        assert all(p.dtype == torch.float32 for p in
                   getattr(tstate, net).parameters()), net
