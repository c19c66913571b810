"""The port's checkpoints (``gsc_tpu_torch.utils.checkpoint``) and the
CLI paths that write and read them, on the CPU.

- the metadata sidecar keeps the JAX package's semantics
  (tests/test_precision.py::test_checkpoint_precision_meta_roundtrip): it
  sits beside the checkpoint directory, a missing or truncated one reads
  as {}, a save without meta removes a stale one;
- a save and load restores every tensor of the learner state (both
  networks, both targets, both Adam states), the replay shards and the
  random source bit for bit, into a state of other values;
- the recorded checksum detects a flipped byte;
- ``cli train --precision bf16 --checkpoint`` writes a bf16 checkpoint,
  and ``cli serve --checkpoint`` serves its actor under bf16; an explicit
  ``--precision`` that contradicts the checkpoint is refused.
"""
import json
import os

import numpy as np
import pytest
import torch

from gsc_tpu_torch import cli
from gsc_tpu_torch.agents.ddpg import Draws
from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import AgentConfig, EnvLimits, SimConfig
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.env.observations import GraphObs
from gsc_tpu_torch.parallel.dp import ParallelDDPG
from gsc_tpu_torch.utils.checkpoint import (checkpoint_checksum,
                                            checkpoint_precision,
                                            load_actor_state,
                                            load_checkpoint,
                                            read_checkpoint_meta,
                                            save_checkpoint,
                                            verify_checkpoint)
from test_torch_train import AGENT_KW, SIM_KW, B, E, N, _batch, _obs, _tbatch
from torch_port_helpers import one_torch_thread  # noqa: F401

TINY_AGENT = ("GNN_features: 4\nGNN_num_layers: 1\nGNN_num_iter: 1\n"
              "episode_steps: 2\nactor_hidden_layer_nodes: [8]\n"
              "critic_hidden_layer_nodes: [8]\nbatch_size: 4\nmem_limit: 8\n"
              "nb_steps_warmup_critic: 2\ngnn_impl: pallas\n")
TINY_SIM = ("inter_arrival_mean: 10.0\ndeterministic_arrival: true\n"
            "deterministic_size: true\nflow_dr_mean: 1.0\n"
            "flow_dr_stdev: 0.0\nflow_size_shape: 0.001\nrun_duration: 10\n"
            "ttl_choices: [100]\n")


def _stack(precision="bf16", seed=0):
    """A trained-a-little learner: a ParallelDDPG with replay shards
    holding two transitions per replica and one gradient step taken."""
    agent = AgentConfig(**dict(AGENT_KW, precision=precision,
                               gnn_impl="pallas"))
    env = ServiceCoordEnv(abc_service(), SimConfig(**SIM_KW), agent,
                          EnvLimits.for_service(abc_service(), max_nodes=N,
                                                max_edges=E))
    pd = ParallelDDPG(env, agent, B, device="cpu", seed=seed)
    state = pd.init(torch.Generator().manual_seed(seed))
    one = GraphObs(**{k: torch.from_numpy(np.asarray(v[0]))
                      for k, v in _obs(1, seed).items()})
    buffers = pd.init_buffers(one)
    from gsc_tpu_torch.agents.buffer import buffer_add
    for i in range(2):
        b = _tbatch(_batch(seed * 10 + i, size=B))
        buffer_add(buffers, {**b, "topo_idx": torch.zeros(B,
                                                          dtype=torch.int32)})
    pd.ddpg.gradient_step_on_batch(state, _tbatch(_batch(seed + 40)))
    pd.draws.uniform((3,))
    return pd, state, buffers


def _tensors(state, buffers, draws):
    out = {}
    for net in ("actor", "critic", "target_actor", "target_critic"):
        for k, v in getattr(state, net).state_dict().items():
            out[f"{net}.{k}"] = v
    for opt in ("actor_opt", "critic_opt"):
        for i, st in getattr(state, opt).state_dict()["state"].items():
            for k, v in st.items():
                out[f"{opt}.{i}.{k}"] = v
    for k, v in buffers.data.items():
        out[f"replay.{k}"] = v
    out["replay.pos"], out["replay.size"] = buffers.pos, buffers.size
    out["draws"] = draws.generator.get_state()
    return out


def test_checkpoint_precision_meta_roundtrip(tmp_path):
    pd, state, buffers = _stack()
    ck = save_checkpoint(str(tmp_path / "ck"), state, buffer=buffers,
                         meta={"precision": pd.agent.precision})
    assert read_checkpoint_meta(ck) == {"precision": "bf16"}
    assert (tmp_path / "ck.meta.json").exists()
    assert not (tmp_path / "ck" / "ck.meta.json").exists()
    assert read_checkpoint_meta(str(tmp_path / "nonexistent")) == {}
    (tmp_path / "ck.meta.json").write_text('{"precision": "bf')
    assert read_checkpoint_meta(ck) == {}
    (tmp_path / "ck.meta.json").write_text('["bf16"]')
    assert read_checkpoint_meta(ck) == {}
    save_checkpoint(str(tmp_path / "ck"), state)
    assert not (tmp_path / "ck.meta.json").exists()
    assert read_checkpoint_meta(ck) == {}
    # a checkpoint without a sidecar is an f32 one
    assert checkpoint_precision(ck) == "f32"


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_save_and_load_are_bit_exact(tmp_path, precision):
    pd, state, buffers = _stack(precision, seed=0)
    want = {k: v.clone() for k, v in _tensors(state, buffers,
                                              pd.draws).items()}
    ck = save_checkpoint(str(tmp_path / "ck"), state, buffer=buffers,
                         meta={"precision": precision}, draws=pd.draws)
    other, ostate, obuf = _stack(precision, seed=1)
    draws = Draws(7, "cpu")
    before = _tensors(ostate, obuf, draws)
    assert any(not torch.equal(before[k], v) for k, v in want.items())
    load_checkpoint(ck, ostate, buffer=obuf, draws=draws)
    got = _tensors(ostate, obuf, draws)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    if precision == "bf16":
        assert obuf.data["obs.nodes"].dtype == torch.bfloat16
        assert all(p.dtype == torch.float32
                   for p in ostate.actor.parameters())
    # the random source continues where the saved one stood
    assert torch.equal(draws.uniform((5,)), pd.draws.uniform((5,)))
    # the restored learner steps on exactly like the saved one
    b = _tbatch(_batch(99))
    _, m1 = pd.ddpg.gradient_step_on_batch(state, b)
    _, m2 = other.ddpg.gradient_step_on_batch(ostate, b)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    assert torch.equal(load_actor_state(ck)["mlp.layers.0.weight"],
                       want["actor.mlp.layers.0.weight"])


def test_load_refuses_a_mismatched_replay(tmp_path):
    pd, state, buffers = _stack("bf16")
    ck = save_checkpoint(str(tmp_path / "ck"), state, buffer=buffers)
    _, s32, b32 = _stack("f32")
    with pytest.raises(ValueError, match="replay leaf"):
        load_checkpoint(ck, s32, buffer=b32)
    bare = save_checkpoint(str(tmp_path / "bare"), state)
    with pytest.raises(ValueError, match="Draws"):
        load_checkpoint(bare, state, draws=Draws(0, "cpu"))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(bare, state, buffer=buffers)


def test_checksum_detects_a_flipped_byte(tmp_path):
    pd, state, buffers = _stack()
    ck = save_checkpoint(str(tmp_path / "ck"), state, buffer=buffers,
                         meta={"precision": "bf16"}, checksum=True)
    meta = read_checkpoint_meta(ck)
    assert meta["precision"] == "bf16"
    assert meta["checksum"] == checkpoint_checksum(ck)
    assert verify_checkpoint(ck)
    path = os.path.join(ck, "state.pt")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    open(path, "wb").write(bytes(raw))
    assert checkpoint_checksum(ck) != meta["checksum"]
    assert not verify_checkpoint(ck)
    assert not verify_checkpoint(str(tmp_path / "missing"))
    plain = save_checkpoint(str(tmp_path / "plain"), state)
    assert not verify_checkpoint(plain)


def test_checkpoint_precision_rule(tmp_path):
    pd, state, _ = _stack()
    ck = save_checkpoint(str(tmp_path / "ck"), state,
                         meta={"precision": "bf16"})
    assert checkpoint_precision(ck) == "bf16"
    assert checkpoint_precision(ck, "bf16") == "bf16"
    with pytest.raises(ValueError, match="contradicts"):
        checkpoint_precision(ck, "f32")
    bare = save_checkpoint(str(tmp_path / "bare"), state)
    with pytest.raises(ValueError, match="implicit"):
        checkpoint_precision(bare, "bf16")


def test_checkpoint_precision_to_serve(tmp_path):
    """With ``implicit=None`` (serve and infer) a checkpoint without a
    sidecar leaves the policy to the caller, and a recorded one still
    refuses a contradicting ``precision``."""
    _, state, _ = _stack()
    ck = save_checkpoint(str(tmp_path / "ck"), state,
                         meta={"precision": "bf16"})
    assert checkpoint_precision(ck, implicit=None) == "bf16"
    with pytest.raises(ValueError, match="contradicts"):
        checkpoint_precision(ck, "f32", implicit=None)
    bare = save_checkpoint(str(tmp_path / "bare"), state)
    assert checkpoint_precision(bare, implicit=None) is None
    assert checkpoint_precision(bare, "bf16", implicit=None) == "bf16"


def _configs(tmp_path):
    (tmp_path / "agent.yaml").write_text(TINY_AGENT)
    (tmp_path / "sim.yaml").write_text(TINY_SIM)
    return ["--agent-config", str(tmp_path / "agent.yaml"),
            "--simulator-config", str(tmp_path / "sim.yaml")]


def test_cli_train_bf16_then_serve_the_checkpoint(tmp_path, capsys):
    """``train --precision bf16 --checkpoint`` then ``serve --checkpoint``
    on the CPU at a tiny size: the checkpoint records bf16, the trained
    actor is served under bf16 (answers equal to the checkpoint's actor's
    own greedy policy), no kernel launches on the CPU, and a contradicting
    ``--precision`` is refused."""
    from gsc_tpu_torch.ops.gat_attention import (gat_attention,
                                                 gat_attention_bf16)
    from gsc_tpu_torch.serve import run_serve

    cfg = _configs(tmp_path)
    ck = str(tmp_path / "ck")
    out = cli.run_train(["--device", "cpu", "--replicas", "2", "--chunk",
                         "1", "--episodes", "2", "--precision", "bf16",
                         "--checkpoint", ck, *cfg])
    summary = out["summary"]
    assert summary["precision"] == "bf16"
    assert summary["checkpoint"] == os.path.abspath(ck)
    assert out["trainer"].agent_cfg.precision == "bf16"
    meta = read_checkpoint_meta(ck)
    assert meta["precision"] == "bf16" and meta["episode"] == 2
    assert verify_checkpoint(ck)
    assert out["buffers"].data["action"].dtype == torch.bfloat16
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]
                      )["precision"] == "bf16"

    before = (gat_attention.launches, gat_attention_bf16.launches)
    rc = cli.main(["serve", "--device", "cpu", "--checkpoint", ck,
                   "--requests", "4", "--concurrency", "2",
                   "--pool-steps", "2", *cfg])
    assert rc == 0
    served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert served["completed"] == 4 and served["errors"] == 0
    assert (gat_attention.launches, gat_attention_bf16.launches) == before

    from gsc_tpu_torch.config.loader import load_agent, load_sim
    report = run_serve(load_agent(str(tmp_path / "agent.yaml")),
                       load_sim(str(tmp_path / "sim.yaml")), requests=3,
                       concurrency=1, pool_steps=2, device="cpu",
                       checkpoint=ck)
    ddpg = report.ddpg
    assert ddpg.agent.precision == "bf16"
    assert ddpg.actor.mlp.dtype == torch.bfloat16
    trained = out["state"].actor.state_dict()
    for k, v in ddpg.actor.state_dict().items():
        assert torch.equal(v, trained[k]), k
    for k, ans in report.answers:
        obs = GraphObs(**{f: torch.from_numpy(np.asarray(v))[None]
                          for f, v in vars(report.pool[k]).items()})
        np.testing.assert_array_equal(ans, ddpg.greedy_action(obs)[0].numpy())

    with pytest.raises(SystemExit, match="contradicts"):
        cli.main(["serve", "--device", "cpu", "--checkpoint", ck,
                  "--precision", "f32", "--requests", "1", *cfg])


def test_serve_without_a_sidecar_keeps_the_yaml_precision(tmp_path, capsys):
    """A checkpoint whose sidecar is lost or unreadable carries no policy:
    ``serve --checkpoint`` and ``infer`` then run under the agent yaml's
    precision (the JAX package's rule), not under f32."""
    from gsc_tpu_torch.serve import run_serve

    cfg = _configs(tmp_path)
    ck = str(tmp_path / "ck")
    cli.run_train(["--device", "cpu", "--replicas", "2", "--chunk", "1",
                   "--episodes", "1", "--checkpoint", ck, *cfg])
    os.unlink(ck + ".meta.json")
    (tmp_path / "bf16.yaml").write_text(TINY_AGENT + "precision: bf16\n")
    bf16_cfg = ["--agent-config", str(tmp_path / "bf16.yaml"),
                "--simulator-config", str(tmp_path / "sim.yaml")]
    from gsc_tpu_torch.config.loader import load_agent, load_sim
    report = run_serve(load_agent(str(tmp_path / "bf16.yaml")),
                       load_sim(str(tmp_path / "sim.yaml")), requests=2,
                       concurrency=1, pool_steps=1, device="cpu",
                       checkpoint=ck)
    assert report.ddpg.agent.precision == "bf16"
    assert not report.errors
    rc = cli.main(["serve", "--device", "cpu", "--checkpoint", ck,
                   "--requests", "2", "--concurrency", "1", "--pool-steps",
                   "1", *bf16_cfg])
    assert rc == 0
    (tmp_path / "ck.meta.json").write_text('{"precision": "bf')
    out = cli.run_infer(["--device", "cpu", "--checkpoint", ck,
                         *bf16_cfg])
    assert out["trainer"].agent_cfg.precision == "bf16"
    out = cli.run_infer(["--device", "cpu", "--checkpoint", ck, *cfg])
    assert out["trainer"].agent_cfg.precision == "f32"
    capsys.readouterr()


def test_partial_restore_when_the_replay_does_not_fit(tmp_path):
    """``load_full_or_partial``: a replay of another capacity is not
    restored (the buffer keeps its values), the learner state, the random
    source and the episode counter are."""
    from gsc_tpu_torch.utils.checkpoint import load_full_or_partial

    pd, state, buffers = _stack("f32", seed=0)
    ck = save_checkpoint(str(tmp_path / "ck"), state, buffer=buffers,
                         draws=pd.draws, extra={"episode": 5})
    other, ostate, obuf = _stack("f32", seed=1)
    full, fstate, fbuf = _stack("f32", seed=2)
    restored, ok = load_full_or_partial(ck, fstate, buffer=fbuf,
                                        draws=Draws(3, "cpu"))
    assert ok and restored["extra"] == {"episode": 5}
    assert torch.equal(fbuf.data["action"], buffers.data["action"])
    from gsc_tpu_torch.agents.buffer import buffer_init
    small = buffer_init(other.ddpg.example_transition(
        GraphObs(**{k: torch.from_numpy(np.asarray(v[0]))
                    for k, v in _obs(1, 0).items()})), 2, lead=(B,))
    before = small.data["action"].clone()
    draws = Draws(9, "cpu")
    restored, ok = load_full_or_partial(ck, ostate, buffer=small,
                                        draws=draws)
    assert not ok and restored["buffer"] is None
    assert restored["extra"] == {"episode": 5}
    assert torch.equal(small.data["action"], before)
    assert torch.equal(draws.generator.get_state(),
                       pd.draws.generator.get_state())
    want = _tensors(state, buffers, pd.draws)
    got = _tensors(ostate, buffers, draws)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
