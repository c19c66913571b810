"""The config keys the port used to drop, and the JAX CLI's last ``train``
flags, against the JAX package.

- ``agent_type`` and ``scan_unroll``: a yaml the JAX package refuses
  (``agent_type: TD3``, ``scan_unroll`` below 1) is refused by the port
  with the same message; a valid yaml loads the same value into every
  field the port carries.  (Before the port carried these two keys it
  loaded both refused files and trained DDPG with no word.)
- ``train --substep-impl`` and ``--unroll`` override the simulator
  yaml's keys, are validated as the JAX CLI validates them and recorded
  in the run's ``run_start`` event; ``--tensorboard`` writes
  ``charts/episodic_return``, ``charts/SPS`` and, after a learn burst,
  ``losses/*`` per episode, read back here with TensorBoard's event
  reader, equal to the run's history rows (float32 as the event stores
  them).
"""
import json

import numpy as np
import pytest

from gsc_tpu_torch import cli
from gsc_tpu_torch.config.loader import load_agent, load_sim
from gsc_tpu_torch.config.schema import AgentConfig, SimConfig
from test_torch_single_env import TINY_AGENT, TINY_SIM
from torch_port_helpers import one_torch_thread  # noqa: F401

REFUSED = [
    ("agent", "agent_type: TD3\n", "unsupported agent_type 'TD3' (only DDPG)"),
    ("sim", "scan_unroll: 0\n", "scan_unroll must be >= 1"),
    ("sim", "scan_unroll: -3\n", "scan_unroll must be >= 1"),
]


def _loaders(kind):
    from gsc_tpu.config import loader as jloader
    if kind == "agent":
        return jloader.load_agent, load_agent
    return jloader.load_sim, load_sim


@pytest.mark.parametrize("kind,extra,message", REFUSED,
                         ids=["agent_type", "scan_unroll_0",
                              "scan_unroll_negative"])
def test_yaml_refused_by_both_packages_with_one_message(tmp_path, kind,
                                                        extra, message):
    path = tmp_path / f"{kind}.yaml"
    path.write_text((TINY_AGENT if kind == "agent" else TINY_SIM) + extra)
    jload, tload = _loaders(kind)
    with pytest.raises(ValueError) as jerr:
        jload(str(path))
    with pytest.raises(ValueError) as terr:
        tload(str(path))
    assert str(jerr.value) == str(terr.value) == message


@pytest.mark.parametrize("kind", ["agent", "sim"])
def test_valid_yaml_loads_the_same_fields(tmp_path, kind):
    extra = ("agent_type: DDPG\ngraph_mode: false\nshuffle_nodes: true\n"
             if kind == "agent" else
             "scan_unroll: 4\nsubstep_impl: pallas\nmax_flows: 64\n")
    path = tmp_path / f"{kind}.yaml"
    path.write_text((TINY_AGENT if kind == "agent" else TINY_SIM) + extra)
    jload, tload = _loaders(kind)
    want, got = jload(str(path)), tload(str(path))
    cls = AgentConfig if kind == "agent" else SimConfig
    for name in cls.__dataclass_fields__:
        assert getattr(got, name) == getattr(want, name), name
    if kind == "agent":
        assert got.agent_type == "DDPG" and not got.graph_mode
    else:
        assert got.scan_unroll == 4 and got.substep_impl == "pallas"


def _yamls(tmp_path, agent=TINY_AGENT):
    (tmp_path / "agent.yaml").write_text(agent)
    (tmp_path / "sim.yaml").write_text(TINY_SIM)
    return ["--device", "cpu", "--agent-config", str(tmp_path / "agent.yaml"),
            "--simulator-config", str(tmp_path / "sim.yaml"), "--network",
            "abilene", "--no-perf"]


def test_unroll_refused_as_the_jax_cli_refuses_it(tmp_path):
    with pytest.raises(SystemExit, match="--unroll must be a positive "
                       "integer"):
        cli.run_train(_yamls(tmp_path) + ["--unroll", "0"])
    with pytest.raises(SystemExit):
        cli.run_train(_yamls(tmp_path) + ["--substep-impl", "mosaic"])


def test_substep_impl_and_unroll_recorded(tmp_path):
    rdir = tmp_path / "run"
    cli.run_train(_yamls(tmp_path) + [
        "--episodes", "1", "--substep-impl", "pallas", "--unroll", "3",
        "--result-dir", str(rdir)])
    events = [json.loads(line) for line in open(rdir / "events.jsonl")]
    start = [e for e in events if e["event"] == "run_start"][0]
    assert start["substep_impl"] == "pallas" and start["unroll"] == 3
    assert start["graph_mode"] is True


def _scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


@pytest.mark.parametrize("replicas", [1, 2])
def test_tensorboard_events_read_back(tmp_path, replicas):
    pytest.importorskip("tensorboard")
    rdir = tmp_path / "run"
    argv = _yamls(tmp_path) + ["--episodes", "2", "--tensorboard",
                               "--result-dir", str(rdir)]
    if replicas > 1:
        argv += ["--replicas", str(replicas), "--chunk", "3"]
    out = cli.run_train(argv)
    rows = out["trainer"].history
    got = _scalars(rdir / "tb")
    steps = 3   # TINY_AGENT's episode_steps
    want = {"charts/episodic_return": "episodic_return", "charts/SPS": "sps"}
    if replicas == 1:
        want.update({"losses/qf1_loss": "critic_loss",
                     "losses/actor_loss": "actor_loss",
                     "losses/qf1_values": "q_values"})
    assert set(got) == set(want)
    for tag, key in want.items():
        learned = [r for r in rows if key in r]
        assert len(got[tag]) == len(learned) == 2, tag
        for (step, value), row in zip(got[tag], learned):
            end = (row["episode"] + 1) * steps - (1 if replicas == 1 else 0)
            assert step == end, tag
            assert value == np.float32(row[key]), tag


def test_no_tensorboard_by_default(tmp_path):
    rdir = tmp_path / "run"
    cli.run_train(_yamls(tmp_path) + ["--episodes", "1", "--result-dir",
                                      str(rdir)])
    assert not (rdir / "tb").exists()
