"""The port's self-healing training loop, on the CPU at the tiny sizes of
tests/test_torch_single_env.py.

- ``FaultPlan.parse`` on a battery of valid and invalid plans: the same
  specs and the same error messages as the JAX package's; the async-only
  sites are refused before a run;
- ``call_with_retry``: the JAX package's attempt and backoff sequence
  with an injected sleep; a CUDA-like ``RuntimeError`` is not retried;
- ``PreemptionGuard``: the first signal sets the flag, the second
  restores the handlers, and outside the main thread it is inert;
- the rollback guard restores the networks, both Adam states (their
  ``step`` tensors equal and the same objects), the replay and the random
  source exactly;
- pipeline on vs off and ledger on vs off, ``dispatch_transient`` and
  ``prefetch_die`` runs, and repeated prefetch faults that degrade the run
  to pipeline-off: the learner state, replay and random source
  ``torch.equal`` to a fault-free serial run;
- ``nan_grads@1;dispatch_transient@2`` retries episode 2's dispatch and
  rolls back episode 1, and its ``recovery`` events (site, action,
  episode) equal those of the JAX package's ``cli train`` under the same
  plan on the CPU (``chip_smoke.py`` phase 15 asserts the same on the
  card); the run ends finite;
- ``ckpt_corrupt`` is caught by validation and saved again;
- SIGTERM to a ``cli train`` subprocess leaves a checksummed snapshot,
  and ``--resume auto`` from it equals the straight run bit for bit.
"""
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from gsc_tpu_torch import cli
from gsc_tpu_torch.obs import RunObserver
from gsc_tpu_torch.resilience import ckpt as ckpt_mod
from gsc_tpu_torch.resilience.faults import FaultPlan, refuse_async_sites
from gsc_tpu_torch.resilience.guard import (RollbackGuard, all_finite,
                                            poison_tree)
from gsc_tpu_torch.resilience.preempt import PreemptionGuard
from gsc_tpu_torch.resilience.retry import (RetryPolicy,
                                            TransientDispatchError,
                                            call_with_retry)
from test_torch_single_env import TINY_AGENT, TINY_SIM, _port_stack, _tensors
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the plan of the recovery-event comparison (chip_smoke.py phase 15's)
FAULT_PLAN = "nan_grads@1;dispatch_transient@2"

PLANS = [
    "prefetch_die@1", "nan_grads@3;slow_episode@2:1.5",
    " dispatch_transient@0 , ckpt_corrupt@4 ",
    "actor_die@a0:3;ring_poison@5;publish_corrupt@v2;"
    "watcher_stall@a1:4:0.5;learner_transient@7",
    "", "nope@1", "nan_grads", "nan_grads@x", "nan_grads@-1",
    "slow_episode@1:abc", "actor_die@3", "actor_die@ax:3", "actor_die@a-1:3",
    "actor_die@a1", "publish_corrupt@2", "publish_corrupt@vq",
    "learner_transient@b", "prefetch_die@1;;nan_grads@2:"]


def _parsed(cls, text):
    try:
        return [(s.site, s.episode, s.arg, s.actor, s.key)
                for s in cls.parse(text).specs]
    except ValueError as e:
        return f"error: {e}"


@pytest.mark.parametrize("text", PLANS)
def test_fault_plan_parses_as_jax(text):
    from gsc_tpu.resilience.faults import FaultPlan as JPlan

    assert _parsed(FaultPlan, text) == _parsed(JPlan, text)


def test_fault_plan_env_fires_once_and_async_sites_are_refused(monkeypatch):
    monkeypatch.setenv("GSC_FAULT_PLAN", "nan_grads@2")
    plan = FaultPlan.from_env(None)
    assert [s.site for s in plan.specs] == ["nan_grads"]
    assert FaultPlan.from_env("") is None
    assert plan.fire("nan_grads", 1) is None
    assert plan.fire("nan_grads", 2).fired_at == 2
    assert plan.fire("nan_grads", 2) is None and plan.unfired() == []
    refuse_async_sites(FaultPlan.parse("prefetch_die@0;ckpt_corrupt@1"))
    with pytest.raises(ValueError, match="--async"):
        refuse_async_sites(FaultPlan.parse("ring_poison@2"))
    with pytest.raises(SystemExit, match="--async"):
        cli.run_train(["--device", "cpu", "--fault-plan", "actor_die@a0:1"])


def _retry_trace(call, fails, exc=TransientDispatchError):
    """(attempts, retries seen by on_retry, sleeps) of ``call`` over a
    function that raises ``exc`` ``fails`` times."""
    attempts, retries = [], []

    def fn():
        attempts.append(len(attempts))
        if len(attempts) <= fails:
            raise exc("transient")
        return "ok"

    try:
        out = call(fn, lambda a, e, d: retries.append((a, round(d, 6))))
    except Exception as e:
        out = type(e).__name__
    return out, len(attempts), retries


@pytest.mark.parametrize("fails", [0, 1, 2, 3, 5])
def test_retry_sequence_equals_jax(fails, monkeypatch):
    from gsc_tpu.resilience import retry as jretry

    sleeps_j, sleeps_t = [], []
    monkeypatch.setattr(jretry.time, "sleep", sleeps_j.append)
    pol = dict(attempts=4, base_s=0.05, cap_s=0.15)
    want = _retry_trace(lambda fn, cb: jretry.call_with_retry(
        fn, jretry.RetryPolicy(**pol), on_retry=cb), fails,
        jretry.TransientDispatchError)
    got = _retry_trace(lambda fn, cb: call_with_retry(
        fn, RetryPolicy(**pol), on_retry=cb, sleep=sleeps_t.append), fails)
    assert got == want and sleeps_t == sleeps_j


def test_cuda_like_runtime_error_is_not_retried():
    out = _retry_trace(lambda fn, cb: call_with_retry(
        fn, RetryPolicy(attempts=3), on_retry=cb, sleep=lambda s: None), 1,
        lambda m: RuntimeError("CUDA error: an illegal memory access was "
                               "encountered"))
    assert out == ("RuntimeError", 1, [])


def test_preemption_guard():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.triggered and guard.signame == "SIGTERM"
        os.kill(os.getpid(), signal.SIGTERM)   # second: handlers restored
        assert signal.getsignal(signal.SIGTERM) == before
    assert signal.getsignal(signal.SIGTERM) == before
    box = []
    t = threading.Thread(target=lambda: box.append(
        PreemptionGuard().__enter__()))
    t.start()
    t.join()
    assert not box[0].triggered and signal.getsignal(signal.SIGTERM) == before


def test_rollback_guard_restores_everything_exactly():
    trainer = _port_stack()
    state, buffer = trainer.train(2, pipeline=False)
    guard = RollbackGuard(trainer.draws)
    guard.init(1, state, buffer)
    want = {k: v.clone() for k, v in _tensors(state, buffer,
                                              trainer.draws).items()}
    steps = {id(st["step"]): st["step"] for st in
             state.actor_opt.state.values()}
    trainer.train(3, init_state=state, init_buffer=buffer, start_episode=2)
    poison_tree(state.actor)
    assert float(all_finite(state)) == 0.0
    tag, state2, buffer2 = guard.restore(state, buffer)
    assert tag == 1 and state2 is state and buffer2 is buffer
    got = _tensors(state, buffer, trainer.draws)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for st in state.actor_opt.state.values():
        assert steps[id(st["step"])] is st["step"]
    assert float(all_finite(state)) == 1.0


def _run(obs=None, fault_plan=None, pipeline_fault_limit=3, **kw):
    """A 3-episode single-env run of the tiny stack; returns its tensors
    and the trainer."""
    from gsc_tpu_torch.agents.trainer import Trainer

    base = _port_stack()
    trainer = Trainer(base.env, base.driver, base.agent_cfg, seed=base.seed,
                      device="cpu", obs=obs, fault_plan=fault_plan,
                      pipeline_fault_limit=pipeline_fault_limit)
    state, buffer = trainer.train(3, **kw)
    return _tensors(state, buffer, trainer.draws), trainer


def _equal(a, b):
    assert set(a) == set(b)
    for k, v in a.items():
        assert torch.equal(b[k], v), k


def _recoveries(obs):
    return [(r["site"], r["action"], r["episode"])
            for r in obs.events.of_kind("recovery")]


def test_pipeline_and_ledger_leave_the_run_unchanged():
    serial, _ = _run(pipeline=False)
    piped, _ = _run(pipeline=True)
    _equal(serial, piped)
    obs = RunObserver(None, learn=True)
    ledger, t = _run(pipeline=True, obs=obs)
    _equal(serial, ledger)
    signals = obs.events.of_kind("learn_signal")
    assert len(signals) == 3 and signals[-1]["grad_norms"]
    assert set(signals[-1]["per_topology_td"]) <= {"tri", "line"}
    assert [e["episode"] for e in obs.events.of_kind("episode")] == [0, 1, 2]


@pytest.mark.parametrize("plan, recoveries", [
    ("dispatch_transient@1", [("dispatch", "retry", 1)]),
    ("prefetch_die@1", [("prefetcher", "restart", 1)]),
    ("prefetch_die@0;prefetch_die@1",
     [("prefetcher", "restart", 0), ("pipeline", "pipeline_off", 1)]),
])
def test_faults_heal_to_the_fault_free_run(plan, recoveries):
    clean, _ = _run(pipeline=False)
    obs = RunObserver(None)
    got, t = _run(obs=obs, fault_plan=FaultPlan.parse(plan),
                  pipeline_fault_limit=1)
    _equal(clean, got)
    assert _recoveries(obs) == recoveries
    assert t.completed_episodes == 3 and t.fault_plan.unfired() == []


@pytest.fixture(scope="module")
def jax_nan_grads_run(tmp_path_factory):
    """The JAX package's ``cli train`` under ``FAULT_PLAN`` (3 episodes,
    the tiny configs) and the same configs' paths for the port."""
    import jax
    from click.testing import CliRunner

    from gsc_tpu.cli import cli as j_cli

    jax.config.update("jax_platforms", "cpu")
    d = tmp_path_factory.mktemp("nan")
    cli.init_configs(str(d / "c"))
    (d / "agent.yaml").write_text(TINY_AGENT.replace("gnn_impl: pallas\n",
                                                     ""))
    (d / "sim.yaml").write_text(TINY_SIM)
    nets = d / "c" / "networks"
    (d / "sched.yaml").write_text(
        f"training_network_files: [{nets / 'triangle.graphml'}, "
        f"{nets / 'line3.graphml'}]\n"
        f"inference_network: {nets / 'line3.graphml'}\nperiod: 1\n")
    files = [str(d / n) for n in ("agent.yaml", "sim.yaml")] + \
        [str(d / "c" / "service_abc.yaml"), str(d / "sched.yaml")]
    res = CliRunner().invoke(j_cli, [
        "train", *files, "--episodes", "3", "--result-dir", str(d / "j"),
        "--max-nodes", "8", "--max-edges", "8", "--fault-plan",
        FAULT_PLAN], catch_exceptions=False)
    assert res.exit_code == 0, res.output
    run = json.loads(res.output.strip().splitlines()[-1])["result_dir"]
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    return d, files, events


def test_nan_grads_recovery_events_equal_jax(jax_nan_grads_run, capsys):
    d, files, jevents = jax_nan_grads_run
    want = [(e["site"], e["action"], e["episode"]) for e in jevents
            if e["event"] == "recovery"]
    assert want == [("dispatch", "retry", 2),
                    ("learner_state", "rollback", 1)]
    args = ["--device", "cpu", "--agent-config", files[0],
            "--simulator-config", files[1], "--service", files[2],
            "--scheduler", files[3], "--max-nodes", "8", "--max-edges", "8",
            "--episodes", "3", "--fault-plan", FAULT_PLAN,
            "--result-dir", str(d / "t")]
    out = cli.run_train(args)
    capsys.readouterr()
    with open(d / "t" / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    got = [(e["site"], e["action"], e["episode"]) for e in events
           if e["event"] == "recovery"]
    assert got == want
    assert [e["episode"] for e in events if e["event"] == "episode"] == \
        [e["episode"] for e in jevents if e["event"] == "episode"]
    assert float(all_finite(out["state"])) == 1.0
    assert out["trainer"].completed_episodes == 1


def test_ckpt_corrupt_is_saved_again(tmp_path, capsys):
    (tmp_path / "a.yaml").write_text(TINY_AGENT)
    (tmp_path / "s.yaml").write_text(TINY_SIM)
    cli.run_train(["--device", "cpu", "--agent-config",
                   str(tmp_path / "a.yaml"), "--simulator-config",
                   str(tmp_path / "s.yaml"), "--episodes", "2",
                   "--ckpt-interval", "1", "--fault-plan", "ckpt_corrupt@1",
                   "--result-dir", str(tmp_path / "r")])
    capsys.readouterr()
    with open(tmp_path / "r" / "events.jsonl") as f:
        rec = [json.loads(line) for line in f]
    assert [(e["site"], e["action"], e["episode"]) for e in rec
            if e["event"] == "recovery"] == [("checkpoint", "resave", 1)]
    assert ckpt_mod.find_resumable(str(tmp_path / "r" / "ckpts")) \
        .endswith("ep00000002")


def test_sigterm_leaves_a_snapshot_that_resumes_exactly(tmp_path, capsys):
    (tmp_path / "a.yaml").write_text(TINY_AGENT)
    (tmp_path / "s.yaml").write_text(TINY_SIM)
    args = ["--device", "cpu", "--agent-config", str(tmp_path / "a.yaml"),
            "--simulator-config", str(tmp_path / "s.yaml"),
            "--episodes", "5"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    # the producer stalls 20 s before staging episode 2: the signal
    # lands while the loop waits for it
    child = subprocess.Popen(
        [sys.executable, "-m", "gsc_tpu_torch.cli", "train", *args,
         "--result-dir", str(tmp_path / "p"), "--fault-plan",
         "slow_episode@2:20"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, env=env, cwd=str(tmp_path))
    lines = []
    try:
        for line in child.stdout:
            lines.append(line)
            if '"episode": 0' in line:
                child.send_signal(signal.SIGTERM)
                break
        lines += child.stdout.readlines()
        assert child.wait(timeout=120) == 0
    finally:
        if child.poll() is None:
            child.kill()
    last = json.loads(lines[-1])
    assert last["status"] == "preempted" and last["signal"] == "SIGTERM"
    assert 1 <= last["episodes_completed"] < 5
    assert ckpt_mod.verify_checkpoint(last["checkpoint"])
    resumed = cli.run_train(args + ["--resume", "auto", "--result-dir",
                                    str(tmp_path / "p")])
    straight = cli.run_train(args)
    capsys.readouterr()
    assert resumed["summary"]["start_episode"] == \
        last["episodes_completed"]
    _equal(_tensors(straight["state"], straight["buffers"],
                    straight["trainer"].draws),
           _tensors(resumed["state"], resumed["buffers"],
                    resumed["trainer"].draws))
    with open(tmp_path / "p" / "events.jsonl") as f:
        kinds = [json.loads(line)["event"] for line in f]
    assert "recovery" in kinds and kinds.count("run_start") == 2
    np.testing.assert_array_equal(
        [r["episodic_return"] for r in resumed["trainer"].history],
        [r["episodic_return"] for r in straight["trainer"].history[
            last["episodes_completed"]:]])
