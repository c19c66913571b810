"""``python -m gsc_tpu_torch.cli serve`` and ``train --hot-swap-dir`` on
the CPU.

- Without ``--checkpoint`` the command serves the SPR tier, as the JAX
  CLI does: its JSON says ``"tier": "spr"`` and every answer equals the
  JAX package's ``spr_schedule_action`` on the same network, exactly.
- The closing JSON carries the JAX command's keys (but its compile-cache
  and artifact-cache paths) and the refusals give the JAX messages.
- A learned fleet of two continuous workers with two fired swaps answers
  every request with no error and four swaps; ``train --hot-swap-dir
  --publish-interval 1`` writes one version per episode on one replica
  and on two (there with ``publish_corrupt@v2``, whose blob the
  fingerprint check refuses), and a fleet watching that directory adopts
  the last."""
import json
import re

import numpy as np
import pytest

from gsc_tpu_torch import cli
from gsc_tpu_torch.serve import load_version
from torch_port_helpers import one_torch_thread  # noqa: F401

JAX_SERVE_KEYS = {"tier", "requests", "workers", "mode", "errors",
                  "error_detail", "wall_s", "rps", "p50_ms", "p99_ms",
                  "buckets", "slo", "swaps", "published_versions",
                  "policy_version", "brownout", "startup", "result_dir"}
TINY_AGENT = ("GNN_features: 4\nGNN_num_layers: 1\nGNN_num_iter: 1\n"
              "episode_steps: 3\nactor_hidden_layer_nodes: [8]\n"
              "critic_hidden_layer_nodes: [8]\nbatch_size: 4\nmem_limit: 8\n"
              "nb_steps_warmup_critic: 2\ngnn_impl: pallas\n")
SERVE = ["serve", "--device", "cpu", "--pool-steps", "1"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_serve_without_checkpoint_is_the_spr_tier(monkeypatch, capsys):
    from gsc_tpu.config.catalog import abc_service as jabc
    from gsc_tpu.config.schema import EnvLimits as JLimits
    from gsc_tpu.serve.fallback import spr_schedule_action as jspr
    from gsc_tpu.topology import synthetic as jsyn
    from gsc_tpu.topology.compiler import compile_topology as jcompile

    import gsc_tpu_torch.serve as serve

    reports = []
    real = serve.run_serve
    monkeypatch.setattr(serve, "run_serve", lambda *a, **kw: reports.append(
        real(*a, **kw)) or reports[-1])
    assert cli.main(SERVE + ["--requests", "12", "--concurrency",
                             "3"]) == 0
    out = _last_json(capsys)
    assert out["tier"] == "spr" and out["errors"] == 0
    assert out["completed"] == 12 and out["startup"]["tier"] == "spr"
    want = jspr(jcompile(jsyn.abilene(), max_nodes=24, max_edges=37),
                JLimits.for_service(jabc()))
    (report,) = reports
    assert report.ddpg is None and len(report.answers) == 12
    for _, ans in report.answers:
        np.testing.assert_array_equal(ans, want)


def test_serve_json_has_the_jax_keys(capsys):
    assert cli.main(SERVE + ["--requests", "3", "--concurrency", "1",
                             "--trace-sample", "1", "--slo-p99-ms",
                             "50"]) == 0
    out = _last_json(capsys)
    assert JAX_SERVE_KEYS <= set(out)
    assert out["mode"] == "deadline" and out["workers"] == 1
    assert out["slo"]["p99_target_ms"] == 50.0 and out["slo"]["requests"] == 3
    assert out["brownout"] is None and out["swaps"] == 0


@pytest.mark.parametrize("argv,message", [
    (["--buckets", "1,x"], "--buckets must be comma-separated positive ints"),
    (["--buckets", "0,4"], "--buckets must be comma-separated positive ints"),
    (["--requests", "0"], "--requests and --concurrency must be positive"),
    (["--concurrency", "0"], "--requests and --concurrency must be positive"),
    (["--workers", "0"], "--workers must be >= 1"),
    (["--fire-swaps", "-1"], "--fire-swaps must be >= 0"),
    (["--fire-swaps", "2"], "--fire-swaps publishes into the hot-swap "
     "directory — pass --hot-swap-dir"),
    (["--swap-poll-s", "0"], "--swap-poll-s must be > 0"),
    (["--metrics-port", "-1"], "--metrics-port must be >= 0 (0 = disabled)"),
    (["--metrics-port", "9", "--no-obs"],
     "--metrics-port needs the run observer (drop --no-obs)"),
    (["--trace-sample", "-2"],
     "--trace-sample must be >= 0 (0 = request spans off)"),
    (["--trace-sample", "2", "--no-obs"],
     "--trace-sample/--slo-p99-ms need the run observer (drop --no-obs)"),
    (["--slo-p99-ms", "25", "--no-obs"],
     "--trace-sample/--slo-p99-ms need the run observer (drop --no-obs)"),
    (["--slo-p99-ms", "4:40,4:50"], "--slo-p99-ms '4:40,4:50': duplicate "
     "bucket 4 in SLO spec '4:40,4:50'"),
])
def test_serve_refusals_give_the_jax_messages(argv, message):
    with pytest.raises(SystemExit, match="^" + re.escape(message)):
        cli.main(SERVE + argv)


def test_spr_fleet_with_fired_swaps(tmp_path, capsys):
    assert cli.main(SERVE + ["--requests", "16", "--concurrency", "4",
                             "--workers", "2", "--continuous",
                             "--hot-swap-dir", str(tmp_path),
                             "--fire-swaps", "2", "--swap-poll-s",
                             "0.02"]) == 0
    out = _last_json(capsys)
    assert out["tier"] == "spr" and out["errors"] == 0
    assert out["swaps"] == 4 and out["published_versions"] == 2
    assert out["policy_version"] == 2 and out["mode"] == "continuous"
    # an SPR fleet is the bottom tier: no brownout below it
    assert out["brownout"] == {"slo_burn": 0, "overflow": 0}


@pytest.mark.parametrize("replicas", [1, 2])
def test_train_publishes_and_learned_fleet_swaps(tmp_path, capsys,
                                                 replicas):
    (tmp_path / "agent.yaml").write_text(TINY_AGENT)
    cfg = ["--device", "cpu", "--agent-config", str(tmp_path / "agent.yaml")]
    pub = tmp_path / "pub"
    # on B replicas the publisher's fault site too: v2 leaves damaged
    chaos = ["--fault-plan", "publish_corrupt@v2"] if replicas > 1 else []
    out = cli.run_train(cfg + chaos + [
        "--replicas", str(replicas), "--chunk", "1", "--episodes", "3",
        "--checkpoint", str(tmp_path / "ck"), "--hot-swap-dir", str(pub),
        "--publish-interval", "1"])
    assert sorted(p.name for p in pub.iterdir()) == [
        "latest.json"] + [f"v0000{v}.{x}" for v in (1, 2, 3)
                          for x in ("json", "npz")]
    v2 = json.loads((pub / "v00002.json").read_text())
    if chaos:
        with pytest.raises(ValueError, match="unreadable|fingerprint"):
            load_version(str(pub), v2)
    else:
        load_version(str(pub), v2)
    starts = [e for e in out["trainer"].obs.events.of_kind("run_start")]
    assert starts[0]["hot_swap_dir"] == str(pub)
    capsys.readouterr()
    # a learned fleet from the checkpoint, two fired swaps under load
    assert cli.main(SERVE + cfg[2:] + [
        "--checkpoint", str(tmp_path / "ck"), "--requests", "12",
        "--concurrency", "3", "--workers", "2", "--continuous",
        "--hot-swap-dir", str(tmp_path / "fire"), "--fire-swaps", "2",
        "--swap-poll-s", "0.02"]) == 0
    served = _last_json(capsys)
    assert served["tier"] == "learned" and served["errors"] == 0
    assert served["swaps"] == 4 and served["completed"] == 12
    # watching the trainer's directory: each worker adopts its last
    # version at start
    assert cli.main(SERVE + cfg[2:] + [
        "--checkpoint", str(tmp_path / "ck"), "--requests", "4",
        "--concurrency", "2", "--workers", "2", "--hot-swap-dir",
        str(pub), "--swap-poll-s", "0.02"]) == 0
    watched = _last_json(capsys)
    assert watched["policy_version"] == 3 and watched["swaps"] == 2


def test_train_refuses_a_zero_publish_interval(tmp_path):
    with pytest.raises(SystemExit, match="--publish-interval must be >= 1"):
        cli.run_train(["--device", "cpu", "--hot-swap-dir", str(tmp_path),
                       "--publish-interval", "0"])
