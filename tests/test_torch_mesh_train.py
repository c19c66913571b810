"""Training on a mesh of ranks, port against port, bit for bit.

The ``tests/test_multichip.py:167-204`` contract at 4 ranks, on CPU ranks
over gloo (one spawned process per rank, one torch thread each, as this
module's own process runs the legs without a mesh): the final learner
state (every tensor of the networks, the targets and both Adam states,
``torch.equal``) of 2x2, 1x4 and 4x1 under ``sharded``, with the leaves
actually split asserted where mp > 1, is the same, and ``replicated`` on
2x2 gives the same bits; a 1x1 mesh equals the run without one, and
legs that stay within the warm-up (2 and 4 ranks) equal the run without
a mesh, replay included.  The shard -> gather round trip of the
residency is the identity, and a rank holds fewer bytes than the whole
state between dispatches.

Sizes: ``TINY_AGENT`` of tests/test_torch_single_env.py with 2-step
episodes, 8 replicas, chunk 2, 2 episodes.  Each launch has its own
deadline.  The card test (``-m cuda``, runnable with ``--noconftest``)
repeats legs (a) and (b) of ``chip_smoke.py`` phase 21 at this size:
1x1 on NCCL against no mesh, and 2x1 and 1x2 on two ranks sharing the
card (gloo) within the warm-up."""
import pytest
import torch

from gsc_tpu_torch import cli
from gsc_tpu_torch.meshspec import parse_mesh_shape
from gsc_tpu_torch.parallel.mesh import launch
from gsc_tpu_torch.parallel.partition import (ShardingPlan, apply_fns,
                                              make_shard_and_gather_fns,
                                              state_leaves)
from test_torch_single_env import TINY_AGENT, TINY_SIM
from torch_port_helpers import one_torch_thread  # noqa: F401

DEADLINE_S = 120.0
CONTRACT = [("2x2", "sharded"), ("1x4", "sharded"), ("4x1", "sharded"),
            ("2x2", "replicated")]


def _write(tmp_path, warmup):
    agent = (TINY_AGENT.replace("episode_steps: 3", "episode_steps: 2")
             .replace("nb_steps_warmup_critic: 2",
                      f"nb_steps_warmup_critic: {warmup}"))
    (tmp_path / f"agent{warmup}.yaml").write_text(agent)
    (tmp_path / "sim.yaml").write_text(TINY_SIM)
    return ["--agent-config", str(tmp_path / f"agent{warmup}.yaml"),
            "--simulator-config", str(tmp_path / "sim.yaml"),
            "--replicas", "8", "--chunk", "2", "--episodes", "2",
            "--no-obs"]


def _legs(mesh, legs, round_trip=False):
    """On each rank: every leg (an argv with its --mesh, a carving of this
    launch's ranks) through ``cli.mesh_legs``; returns rank 0's learner
    state and replay and every rank's accounting per leg, and with
    ``round_trip`` whether place -> gather gave the state back."""
    out = [{k: res[k] for k in ("state", "buffers", "rank")}
           for res in cli.mesh_legs(mesh, legs)]
    if round_trip:
        from gsc_tpu_torch.agents.ddpg import DDPG

        args = cli._parser().parse_args(["train", *legs[0]])
        env, _, agent = cli._build(args, None)
        ddpg = DDPG(env, agent, device="cpu")
        state = ddpg.init_state(torch.Generator().manual_seed(3))
        plan = ShardingPlan(mesh.recarve(2, 2), "sharded")
        before = {k: v.detach().clone()
                  for k, v in state_leaves(state).items()}
        plan.place_state(state)
        sliced = sum(1 for k, v in state_leaves(state).items()
                     if v.shape != before[k].shape)
        resident, full = plan.resident_bytes, plan.full_bytes
        plan.gather_state(state)
        after = state_leaves(state)
        # the per-leaf shard and gather callables do the same one leaf at
        # a time
        shard_fns, gather_fns = make_shard_and_gather_fns(
            plan.specs(before), plan.mesh)
        back = apply_fns(gather_fns, apply_fns(shard_fns, before))
        out.append({"round_trip": all(torch.equal(before[k], after[k])
                                      and torch.equal(before[k], back[k])
                                      for k in before),
                    "sliced": sliced, "resident": resident, "full": full})
    return out


def _same_state(a, b):
    assert set(a) == set(b)
    bad = [k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]
    assert not bad, bad


def _same_replay(a, b):
    assert set(a.data) == set(b.data)
    for k in a.data:
        assert torch.equal(a.data[k].cpu(), b.data[k].cpu()), k
    assert torch.equal(a.pos.cpu(), b.pos.cpu())
    assert torch.equal(a.size.cpu(), b.size.cpu())


def _no_mesh(argv, device="cpu"):
    out = cli.run_train(["--device", device, *argv])
    return ({k: v.detach().cpu() for k, v in state_leaves(
        out["state"]).items()}, out["buffers"].to("cpu"))


def test_carvings_of_four_ranks_are_bit_identical(tmp_path, capsys):
    """2x2, 1x4 and 4x1 under ``sharded`` and 2x2 under ``replicated``
    end with the same learner state past the warm-up, which is the run
    without a mesh's, replay included, as a 4-rank leg within the warm-up
    is; the residency's round trip is the identity."""
    past, warm = _write(tmp_path, 2), _write(tmp_path, 100)
    legs = [["--device", "cpu", *past, "--mesh", m, "--partition-rules", r]
            for m, r in CONTRACT]
    legs.append(["--device", "cpu", *warm, "--mesh", "4x1",
                 "--partition-rules", "sharded"])
    per_rank = launch(_legs, 2, 2, device="cpu", deadline_s=DEADLINE_S,
                      args=(legs, True))
    capsys.readouterr()
    rank0 = per_rank[0]
    states = [leg["state"] for leg in rank0[:len(CONTRACT)]]
    for (m, r), st in zip(CONTRACT[1:], states[1:]):
        _same_state(states[0], st)
    for i, (m, r) in enumerate(CONTRACT):
        split = [rank[i]["rank"]["plan"]["split_leaves"] for rank in per_rank]
        dp, mp = parse_mesh_shape(m)
        if mp > 1 and r == "sharded":
            assert min(split) > 0, (m, r, "sharded rules split no leaf")
            gathers = [rank[i]["rank"]["plan"]["entry_gathers"]
                       for rank in per_rank]
            assert min(gathers) > 0
        else:
            assert max(split) == 0, (m, r)
    # past the warm-up too, at one torch thread: the slicing of every
    # replica-axis draw and the stats' gather give the run without a mesh
    # bit for bit (on the card, cuBLAS may take other bits for fewer
    # acting rows, chip_smoke.py phase 21 (c))
    want_state, want_replay = _no_mesh(past)
    _same_state(want_state, states[0])
    _same_replay(want_replay, rank0[0]["buffers"])
    want_state, want_replay = _no_mesh(warm)
    _same_state(want_state, rank0[len(CONTRACT)]["state"])
    _same_replay(want_replay, rank0[len(CONTRACT)]["buffers"])
    for rank in per_rank:
        rt = rank[-1]
        assert rt["round_trip"] and rt["sliced"] > 0
        assert rt["resident"] < rt["full"]


def test_two_ranks_within_warmup_and_one_rank_equal_no_mesh(tmp_path,
                                                            capsys):
    """2x1 and 1x2 (sharded, replicated) within the warm-up, and 1x1 past
    it, equal the run without a mesh: learner state and replay."""
    past, warm = _write(tmp_path, 2), _write(tmp_path, 100)
    legs = [["--device", "cpu", *warm, "--mesh", m, "--partition-rules", r]
            for m, r in (("2x1", "sharded"), ("1x2", "sharded"),
                         ("1x2", "replicated"))]
    two = launch(_legs, 2, 1, device="cpu", deadline_s=DEADLINE_S,
                 args=(legs,))[0]
    one = launch(_legs, 1, 1, device="cpu", deadline_s=DEADLINE_S,
                 args=([["--device", "cpu", *past, "--mesh", "1x1",
                         "--partition-rules", "sharded"]],))[0]
    capsys.readouterr()
    want_state, want_replay = _no_mesh(warm)
    for leg in two:
        _same_state(want_state, leg["state"])
        _same_replay(want_replay, leg["buffers"])
    want_state, want_replay = _no_mesh(past)
    _same_state(want_state, one[0]["state"])
    _same_replay(want_replay, one[0]["buffers"])


MIXES = {True: ["schedule,ring5~link@1.0,random6:3",
                "factory:all+shapes~faults"],
         False: ["schedule,ring5~link@1.0,random6:3", None]}


@pytest.mark.parametrize("device_traffic", [True, False],
                         ids=["device-traffic", "host-traffic"])
def test_topo_mix_and_shuffle_on_two_ranks_equal_no_mesh(tmp_path, capsys,
                                                         device_traffic):
    """A registry mix and the scenario factory (with the curriculum and
    the learn ledger of the in-memory observer), nodes shuffled: the
    per-replica networks, traffic and permutations are drawn whole and
    sliced, so 2x1 within the warm-up equals the run without a mesh,
    learner state and replay.  Host traffic (the trainer's
    ``device_traffic=False``, seeded per replica) on a registry mix and on
    the scheduled network; the factory samples on the device only."""
    import gsc_tpu_torch.agents.trainer as trainer_mod

    warm = _write(tmp_path, 100)
    agent = tmp_path / "agent100.yaml"
    agent.write_text(agent.read_text() + "shuffle_nodes: true\n")
    warm = [a for a in warm if a != "--no-obs"]
    runs = [warm + (["--topo-mix", mix] if mix else [])
            for mix in MIXES[device_traffic]]
    legs = [["--device", "cpu", *argv, "--mesh", "2x1",
             "--partition-rules", "sharded"] for argv in runs]
    got = launch(_legs if device_traffic else _legs_host, 2, 1,
                 device="cpu", deadline_s=DEADLINE_S, args=(legs,))[0]
    for leg, argv in zip(got, runs):
        if device_traffic:
            want_state, want_replay = _no_mesh(argv)
        else:
            want_state, want_replay = _no_mesh_host(argv, trainer_mod)
        _same_state(want_state, leg["state"])
        _same_replay(want_replay, leg["buffers"])
    capsys.readouterr()


def _host_traffic(trainer_mod):
    """Make Trainer.train_parallel sample host traffic."""
    original = trainer_mod.Trainer.train_parallel

    def host(self, *a, **k):
        k["device_traffic"] = False
        return original(self, *a, **k)

    trainer_mod.Trainer.train_parallel = host
    return original


def _legs_host(mesh, legs):
    import gsc_tpu_torch.agents.trainer as trainer_mod

    _host_traffic(trainer_mod)
    return _legs(mesh, legs)


def _no_mesh_host(argv, trainer_mod):
    original = _host_traffic(trainer_mod)
    try:
        return _no_mesh(argv)
    finally:
        trainer_mod.Trainer.train_parallel = original


@pytest.mark.cuda
def test_mesh_legs_on_card(tmp_path, capsys):
    """Legs (a) and (b) of ``chip_smoke.py`` phase 21 at the tiny size:
    1x1 on NCCL and 2x1, 1x2 on two ranks sharing the card (gloo), within
    the warm-up, equal to the run without a mesh, with every rank
    launching both kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    warm = _write(tmp_path, 100)
    want_state, want_replay = _no_mesh(warm, device="cuda")
    one = cli.run_train(["--device", "cuda", *warm, "--mesh", "1x1"],
                        deadline_s=300)
    _same_state(want_state, one["state"])
    _same_replay(want_replay, one["buffers"])
    for m in ("2x1", "1x2"):
        out = cli.run_train(["--device", "cuda", *warm, "--mesh", m,
                             "--partition-rules", "sharded"],
                            devices=["cuda:0"] * 2, deadline_s=300)
        _same_state(want_state, out["state"])
        _same_replay(want_replay, out["buffers"])
        for rank in out["ranks"]:
            assert rank["launches"]["substep_megakernel"] > 0
            assert rank["launches"]["gat_attention_backward"] > 0
    capsys.readouterr()
