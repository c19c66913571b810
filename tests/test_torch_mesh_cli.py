"""``train --mesh DPxMP --partition-rules replicated|sharded`` through the
port's CLI on CPU ranks (gloo).

- Elastic resume: a run checkpointed under 2x2 (``--ckpt-interval 1``)
  resumes with ``--resume auto`` under 2x1 and runs episodes 2 and 3
  after 0 and 1; each ``run_start`` records its mesh, the rule book and a
  positive ``partition_specs`` count; the same checkpoint resumes with
  no mesh at all.
- The refusals of the JAX CLI (gsc_tpu/cli.py:583-621) and the port's
  own: ``--mesh`` without replicas, grammar errors, indivisible replica
  counts, ``--partition-rules`` without ``--mesh``, ``--async`` and
  ``tp`` with ``--mesh`` (the next slice's), and a card run on fewer
  cards than ranks, which names the count and ``--device cpu``.
- A rank that fails (the launcher's test hook) makes the launch raise
  with its traceback and the CLI exit non-zero, within the deadline, with
  no rank left running; a rank past the deadline is killed.
- A torchrun-style start (``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` set in
  each of two processes) joins as the mesh's ranks.

Sizes: ``TINY_AGENT`` of tests/test_torch_single_env.py, 8 replicas,
chunk 3; every launch and subprocess has a deadline of its own."""
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from gsc_tpu_torch import cli
from gsc_tpu_torch.parallel.mesh import RankFailed, launch
from test_torch_single_env import TINY_AGENT, TINY_SIM
from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 120.0


@pytest.fixture
def cfg(tmp_path):
    (tmp_path / "agent.yaml").write_text(TINY_AGENT)
    (tmp_path / "sim.yaml").write_text(TINY_SIM)
    return ["--device", "cpu", "--agent-config", str(tmp_path / "agent.yaml"),
            "--simulator-config", str(tmp_path / "sim.yaml"),
            "--replicas", "8", "--chunk", "3"]


def _runs(root):
    """(run_start, episode numbers) of every events.jsonl under root."""
    out = []
    for d, _, files in os.walk(root):
        if "events.jsonl" in files:
            with open(os.path.join(d, "events.jsonl")) as f:
                ev = [json.loads(line) for line in f]
            start = [e for e in ev if e["event"] == "run_start"][0]
            out.append((start, [e["episode"] for e in ev
                                if e["event"] == "episode"]))
    return out


def test_elastic_resume_across_meshes_and_to_no_mesh(cfg, tmp_path, capsys):
    res = str(tmp_path / "res")
    base = cfg + ["--partition-rules", "sharded", "--result-dir", res,
                  "--experiment-id", "e"]
    first = cli.run_train(base + ["--mesh", "2x2", "--episodes", "2",
                                  "--ckpt-interval", "1"],
                          deadline_s=DEADLINE_S)
    second = cli.run_train(base + ["--mesh", "2x1", "--episodes", "4",
                                   "--resume", "auto"], deadline_s=DEADLINE_S)
    capsys.readouterr()
    assert first["summary"]["mesh"] == "2x2"
    assert second["summary"]["mesh"] == "2x1"
    assert second["summary"]["start_episode"] == 2
    by_mesh = {s["mesh"]: (s, eps) for s, eps in _runs(res)}
    assert by_mesh["2x2"][1] == [0, 1]
    assert by_mesh["2x1"][1] == [2, 3]
    for start, _ in by_mesh.values():
        assert start["partition_rules"] == "sharded"
        assert sum(start["partition_specs"].values()) > 0
        assert start["partition_specs"]["PartitionSpec('mp', None)"] > 0
    # every rank of the 2x2 run trained all of its episodes, and rank 0
    # alone wrote the run directory
    assert [r["completed_episodes"] for r in first["ranks"]] == [2] * 4
    assert [h["episode"] for h in second["history"]] == [2, 3]
    # the 2x2 checkpoint resumes with no mesh as well
    third = cli.run_train(cfg + ["--episodes", "4", "--resume",
                                 first["summary"]["checkpoint"],
                                 "--result-dir", str(tmp_path / "plain")])
    capsys.readouterr()
    assert [h["episode"] for h in third["trainer"].history] == [2, 3]
    assert third["buffers"].size.shape == (8,)
    assert _runs(str(tmp_path / "plain"))[0][1] == [2, 3]


REFUSALS = [
    (["--replicas", "1", "--mesh", "2x1"], "requires the replica-parallel"),
    (["--mesh", "2x"], "--mesh: mesh shape '2x' is not 'DPxMP'"),
    (["--mesh", "0x2"], "axes must be positive"),
    (["--mesh", "3x1"], "must be divisible by the mesh device count (3 = 3x1)"),
    (["--partition-rules", "sharded"], "has no effect without --mesh"),
    (["--mesh", "2x1", "--async"], "next slice"),
    (["--mesh", "2x2", "--partition-rules", "tp"], "next slice"),
]


@pytest.mark.parametrize("extra,match", REFUSALS,
                         ids=[m for _, m in REFUSALS])
def test_mesh_refusals(cfg, extra, match):
    with pytest.raises(SystemExit) as e:
        cli.run_train(cfg + extra)
    assert match in str(e.value.code)


def test_partition_rules_vocabulary_is_a_flag_error(cfg, capsys):
    with pytest.raises(SystemExit) as e:
        cli.run_train(cfg + ["--mesh", "2x1", "--partition-rules", "zigzag"])
    assert e.value.code == 2
    assert "zigzag" in capsys.readouterr().err


def test_card_run_with_fewer_cards_than_ranks_is_refused(cfg, monkeypatch):
    """Before anything is built: the count, and --device cpu as the dry
    run; never a quiet move to the CPU or onto a shared card."""
    import gsc_tpu_torch.device as device

    monkeypatch.setattr(device, "resolve_device",
                        lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = [a for a in cfg if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit) as e:
        cli.run_train(argv + ["--mesh", "2x2"])
    msg = str(e.value.code)
    assert "needs 4 cards" in msg and "has 1" in msg and "--device cpu" in msg


def _sleep_forever(mesh):
    time.sleep(3600)


def _return_rank(mesh):
    return {"rank": mesh.rank, "world": mesh.world, "mp": mesh.mp_index}


def test_launch_results_failure_and_deadline():
    """Each rank's result in rank order; a rank that raises fails the
    launch with its traceback well within the deadline; a launch past
    its deadline is killed; no rank process is left either way."""
    assert launch(_return_rank, 1, 2, device="cpu", deadline_s=DEADLINE_S) \
        == [{"rank": 0, "world": 2, "mp": 0}, {"rank": 1, "world": 2, "mp": 1}]
    t0 = time.perf_counter()
    with pytest.raises(RankFailed, match="injected failure in rank 1"):
        launch(_sleep_forever, 2, 1, device="cpu", fail_rank=1,
               deadline_s=DEADLINE_S)
    assert time.perf_counter() - t0 < DEADLINE_S
    assert not multiprocessing.active_children()
    with pytest.raises(TimeoutError, match="did not finish within"):
        launch(_sleep_forever, 2, 1, device="cpu", deadline_s=5)
    assert not multiprocessing.active_children()


def _cli(argv, env_extra, timeout=DEADLINE_S):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **env_extra)
    return subprocess.Popen(
        [sys.executable, "-m", "gsc_tpu_torch.cli", "train", *argv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def test_cli_exits_nonzero_when_a_rank_fails(cfg):
    p = _cli(cfg + ["--mesh", "2x1", "--episodes", "1", "--no-obs"],
             {"GSC_MESH_FAIL_RANK": "1"})
    out, err = p.communicate(timeout=DEADLINE_S)
    assert p.returncode != 0
    assert "rank 1 of mesh 2x1 failed" in err
    assert "injected failure in rank 1" in err


def test_torchrun_environment_joins_as_ranks(cfg):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [_cli(cfg + ["--mesh", "2x1", "--episodes", "1", "--no-obs"],
                  {"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r),
                   "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE_S))
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-2000:]
    lines = [json.loads(line) for line in outs[0][0].splitlines()
             if line.startswith("{")]
    assert lines[-1]["mesh"] == "2x1" and lines[-1]["episodes"] == 1
    assert not outs[1][0].strip()      # rank 1 prints nothing
