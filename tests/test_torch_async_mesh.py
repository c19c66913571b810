"""Decoupled training across ranks (``train --async --mesh``,
``parallel.async_rl.run_async`` over a ``ShardingPlan``) and flat agents
under ``--async`` and ``--mesh``, on CPU ranks over gloo.

- **Ring parity** (tests/test_async_rl.py:486-527's contract): 2x1, one
  actor per rank, publishing frozen, exploration noise off and on, past
  the warm-up, two replica rows per rank (an actor acting on one row takes
  another matrix-vector path, whose actions differ from the two-row
  batch's in the last bit, with or without a mesh): the gathered ring
  (data, ``pos``, ``size``) is bit-identical to the single-process
  ``run_async`` ring on the same seeds, which
  tests/test_torch_async.py holds against the port's synchronous
  rollout (itself held against the JAX package in
  tests/test_torch_train.py); ``ring_shards`` 2, no collective from an
  actor thread or an ingest, no transition lost.
- **Ranks agree**: 2x1 (replicated) and 2x2 (sharded) with two actors per
  rank and publishing on: every episode drains exactly once on every
  rank, in the same order, with the same returns and burst count, and
  the learner state (networks, targets, Adam moments and step counts)
  is bit-identical across ranks.
- **One draw per episode**: a scenario source the learner moves (the
  factory's curriculum) is read from the snapshot the learners hand out
  at one agreed pass: every rank's actors get the same snapshot for an
  episode although rank 1's actors run late, and under ``train --async
  --mesh 2x1 --topo-mix factory:...`` both ranks draw each episode's
  [B] scenarios under the same curriculum weights, bit for bit, and keep
  their rows of that draw.
- **The thread guard**: a collective from a thread that is not the
  learner raises and names the thread.
- **Refusals**: a tp-only carving (1x2) under ``--async`` at the plan, at
  ``run_async`` and at the CLI (tests/test_async_rl.py:429-455, 529-555);
  ``--partition-rules tp`` under ``--async --mesh``.
- **Resume**: a ``--async --mesh 2x1`` checkpoint resumes under
  ``--async`` without a mesh (its ring bit-identical to the gathered
  one) and under ``--mesh 2x1`` synchronously.
- **Flat mode**: a flat agent under ``--mesh 2x1`` equals the run without
  a mesh bit for bit within the warm-up; under ``--async`` with one actor
  and publishing frozen it fills the ring the synchronous flat rollout
  fills; under ``--async --mesh 2x1`` the drain accounting holds.

Sizes: tests/test_torch_async.py's tiny stack (a triangle padded to 8
nodes, GATv2 4 x 1 x 1, 4-step episodes in chunks of 2) at B = 2 and 4,
and tests/test_torch_single_env.py's ``TINY_AGENT`` for the CLI legs.
Each launch has its own deadline.  Comparisons are exact (the same code
on the same CPU at one torch thread per process).
"""
import hashlib
import threading
import time

import pytest
import torch

from gsc_tpu_torch import cli
from gsc_tpu_torch.agents.buffer import ReplayBuffer
from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import AgentConfig, EnvLimits, SimConfig
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.env.observations import obs_map
from gsc_tpu_torch.parallel.async_rl import AsyncConfig, run_async
from gsc_tpu_torch.parallel.dp import ParallelDDPG
from gsc_tpu_torch.parallel.mesh import CollectiveThreadError, launch
from gsc_tpu_torch.parallel.partition import ShardingPlan, state_leaves
from gsc_tpu_torch.sim.state import stack_traffic
from gsc_tpu_torch.sim.traffic import generate_traffic
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import compile_topology
from test_torch_async import AGENT_KW, CHUNK, STEPS
from test_torch_single_env import TINY_AGENT, TINY_SIM
from torch_port_helpers import one_torch_thread  # noqa: F401

DEADLINE_S = 150.0
FROZEN = AsyncConfig(actor_threads=1, publish_bursts=10 ** 6)
FLEET = AsyncConfig(actor_threads=2)
# the parity runs' exploration noise: off, and the agent's own
NOISE = {"noise_off": {"rand_sigma": 0.0, "rand_mu": 0.0}, "noise_on": {}}


class MeshStack:
    """The tiny stack of tests/test_torch_async.py at ``b`` replicas, one
    rank of ``plan`` (None: no mesh)."""

    def __init__(self, b, plan=None, **agent_kw):
        agent = AgentConfig(**{**AGENT_KW, **agent_kw})
        sim = SimConfig(inter_arrival_mean=2.0, run_duration=10.0,
                        ttl_choices=(100.0,))
        lim = EnvLimits.for_service(abc_service(), max_nodes=8, max_edges=8)
        self.env = ServiceCoordEnv(abc_service(), sim, agent, lim)
        self.topo = compile_topology(synthetic.triangle(
            node_caps=(2.0, 3.0, 2.0), num_ingress=2), max_nodes=8,
            max_edges=8)
        self.traffic = stack_traffic([generate_traffic(
            sim, abc_service(), self.topo, STEPS, seed=s) for s in range(b)])
        self.pddpg = ParallelDDPG(self.env, agent, b, device="cpu", seed=0,
                                  plan=plan)
        lo, hi = self.pddpg.lo, self.pddpg.hi
        self.rows = (self.topo.rows(lo, hi), self.traffic.rows(lo, hi))
        _, obs = self.env.reset(self.topo, self.traffic, batch=b)
        self.one = obs_map(obs, lambda x: x[0])

    def run(self, episodes, cfg, scenario_fn=None, **kw):
        state = self.pddpg.init(torch.Generator().manual_seed(0))
        ring = self.pddpg.init_buffers(self.one)
        return run_async(self.pddpg, scenario_fn or (lambda ep: self.rows),
                         state, ring, episodes=episodes, episode_steps=STEPS,
                         chunk=CHUNK, seed=0, cfg=cfg, **kw)


def _cpu_leaves(state):
    return {k: v.detach().cpu().clone()
            for k, v in state_leaves(state).items()}


def _ring_cpu(ring):
    return ReplayBuffer(data={k: v.clone() for k, v in ring.data.items()},
                        pos=ring.pos.clone(), size=ring.size.clone(),
                        shapes=ring.shapes)


def _accounting(res):
    return {"state": _cpu_leaves(res.state),
            "episodes": [e["episode"] for e in res.episodes],
            "returns": [e["episodic_return"] for e in res.episodes],
            "info": res.info}


def _snapshot_run(plan):
    """The fleet run with a scenario source the learner moves (its burst
    count, handed out as ``scenario_snapshot``); rank 1's actors read
    their scenarios late.  Returns episode -> the snapshot it got."""
    stack = MeshStack(2, plan)
    moved, seen = [0], {}

    def scenario(ep, snap):
        if plan.mesh.rank == 1:
            time.sleep(0.05)
        seen[ep] = snap
        return stack.rows

    stack.run(6, FLEET, scenario_fn=scenario,
              scenario_snapshot=lambda: moved[0],
              on_burst=lambda n, st, m: moved.__setitem__(0, n))
    return seen


def _factory_draws(mesh, argv):
    """``train --async --mesh`` of a factory mix on this rank, recording
    what every actor thread's factory draw was: episode -> (the family
    weights, a sha256 over the whole [B] draw)."""
    from gsc_tpu_torch.agents.trainer import Trainer
    from gsc_tpu_torch.topology.factory import ScenarioFactory

    draws, last = {}, threading.local()
    gen0, sample0 = Trainer._episode_generator, ScenarioFactory.sample_batch

    def gen(self, ep):
        last.ep = ep
        return gen0(self, ep)

    def sample(self, generator, probs, b):
        out = sample0(self, generator, probs, b)
        if threading.current_thread().name.startswith("gsc-actor-"):
            h = hashlib.sha256()
            for tree in out:
                tree.map(lambda t: h.update(
                    t.detach().reshape(-1).contiguous().cpu()
                    .view(torch.uint8).numpy().tobytes()) or t)
            draws[last.ep] = (torch.as_tensor(probs).tolist(),
                              h.hexdigest())
        return out

    Trainer._episode_generator, ScenarioFactory.sample_batch = gen, sample
    try:
        leg = cli.mesh_legs(mesh, [argv])[0]
    finally:
        Trainer._episode_generator = gen0
        ScenarioFactory.sample_batch = sample0
    return {"draws": draws, "rank": leg["rank"]}


def _two_rank_legs(mesh, argvs, factory_argv):
    """On each of two ranks: the ring-parity run, the fleet run (2x1,
    replicated), the snapshot run, the thread guard, the CLI legs, then
    the factory leg."""
    plan = ShardingPlan(mesh, "replicated")
    out = {}
    for noise, kw in NOISE.items():
        res = MeshStack(4, plan, **kw).run(3, FROZEN)
        out[f"parity_ring_{noise}"] = _ring_cpu(
            plan.gather_buffers(res.buffers, 4))
        out[f"parity_info_{noise}"] = res.info
    drained = []
    fleet = MeshStack(2, plan).run(
        6, FLEET, on_episode=lambda rec, ring: drained.append(rec["episode"]))
    out["fleet"] = _accounting(fleet)
    out["fleet_on_episode"] = drained
    out["snapshots"] = _snapshot_run(plan)
    # a collective from a thread that is not the learner
    caught = []

    def rogue():
        try:
            mesh.agree_any(True)
        except CollectiveThreadError as e:
            caught.append(str(e))

    t = threading.Thread(target=rogue, name="gsc-rogue", daemon=True)
    t.start()
    t.join(30.0)
    out["guard"] = caught
    out["legs"] = [{k: leg[k] for k in ("state", "buffers", "rank",
                                        "summary", "history")}
                   for leg in cli.mesh_legs(mesh, argvs)]
    out["factory"] = _factory_draws(mesh, factory_argv)
    return out


def _four_rank_fleet(mesh):
    """On each of four ranks (2x2, sharded): the fleet run."""
    plan = ShardingPlan(mesh, "sharded")
    res = MeshStack(4, plan).run(4, FLEET)
    return {**_accounting(res), "split": len(plan.split_leaves())}


def _write(tmp_path, warmup, flat=False):
    agent = (TINY_AGENT.replace("episode_steps: 3", "episode_steps: 2")
             .replace("nb_steps_warmup_critic: 2",
                      f"nb_steps_warmup_critic: {warmup}"))
    if flat:
        agent += "graph_mode: false\n"
    path = tmp_path / f"agent{warmup}{'flat' if flat else ''}.yaml"
    path.write_text(agent)
    (tmp_path / "sim.yaml").write_text(TINY_SIM)
    return ["--device", "cpu", "--agent-config", str(path),
            "--simulator-config", str(tmp_path / "sim.yaml"),
            "--replicas", "4", "--chunk", "2", "--no-obs"]


def _same_state(a, b):
    assert set(a) == set(b)
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, bad


def _same_ring(a, b):
    assert set(a.data) == set(b.data)
    for k in a.data:
        assert torch.equal(a.data[k].cpu().view(torch.uint8),
                           b.data[k].cpu().view(torch.uint8)), k
    assert torch.equal(a.pos.cpu(), b.pos.cpu())
    assert torch.equal(a.size.cpu(), b.size.cpu())


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("async_mesh")
    ckpt = str(tmp / "ckpt")
    past, warm = _write(tmp, 2), _write(tmp, 100, flat=True)
    argvs = [
        # (0) --async --mesh 2x1, then its checkpoint resumed synchronously
        # on 2x1
        past + ["--episodes", "2", "--async", "--async-actors", "2",
                "--mesh", "2x1", "--checkpoint", ckpt],
        past + ["--episodes", "3", "--mesh", "2x1", "--resume", ckpt,
                "--checkpoint", str(tmp / "ckpt_sync")],
        # (2) a flat agent on 2x1 within the warm-up, (3) under --async
        warm + ["--episodes", "2", "--mesh", "2x1"],
        warm + ["--episodes", "2", "--async", "--async-actors", "2",
                "--mesh", "2x1", "--partition-rules", "sharded"]]
    # a factory mix whose curriculum moves (the observer's learn ledger
    # on rank 0, its spec on rank 1)
    factory = [a for a in past if a != "--no-obs"] + [
        "--episodes", "8", "--async", "--async-actors", "2", "--mesh",
        "2x1", "--topo-mix", "factory:all"]
    per_rank = launch(_two_rank_legs, 2, 1, device="cpu",
                      deadline_s=DEADLINE_S, args=(argvs, factory))
    return per_rank, {"past": past, "warm": warm, "ckpt": ckpt}


@pytest.mark.parametrize("noise", list(NOISE))
def test_ring_parity_with_one_process(two_ranks, noise):
    """With noise on, each rank's actor draws the noise of all four rows
    and keeps its own (``ParallelDDPG.actor_draws``)."""
    per_rank, _ = two_ranks
    single = MeshStack(4, **NOISE[noise]).run(3, FROZEN)
    got = per_rank[0]
    info = got[f"parity_info_{noise}"]
    assert info["ring_shards"] == 2 and info["mesh"] == "2x1"
    assert info["actor_collectives"] == 0 and info["ingest_collectives"] == 0
    assert info["transitions_lost"] == 0 and info["publishes"] == 0
    _same_ring(single.buffers, got[f"parity_ring_{noise}"])
    _same_ring(got[f"parity_ring_{noise}"],
               per_rank[1][f"parity_ring_{noise}"])


def test_two_ranks_agree(two_ranks):
    per_rank, _ = two_ranks
    a, b = (r["fleet"] for r in per_rank)
    assert sorted(a["episodes"]) == list(range(6))
    # each episode once, in the same order on both ranks
    assert a["episodes"] == b["episodes"]
    assert per_rank[0]["fleet_on_episode"] == a["episodes"]
    assert a["returns"] == b["returns"]
    for r in (a, b):
        info = r["info"]
        assert info["actor_collectives"] == 0
        assert info["ingest_collectives"] == 0
        assert info["produced_steps"] == info["ingested_steps"] == 6 * 4
        assert info["transitions_lost"] == 0 and info["publishes"] >= 1
    assert a["info"]["bursts"] == b["info"]["bursts"] == 6
    _same_state(a["state"], b["state"])


def test_four_ranks_sharded_agree():
    per_rank = launch(_four_rank_fleet, 2, 2, device="cpu",
                      deadline_s=DEADLINE_S)
    first = per_rank[0]
    assert min(r["split"] for r in per_rank) > 0
    for r in per_rank:
        assert sorted(r["episodes"]) == list(range(4))
        assert r["episodes"] == first["episodes"]
        assert r["info"]["bursts"] == first["info"]["bursts"] == 4
        assert r["info"]["actor_collectives"] == 0
        assert r["info"]["ingest_collectives"] == 0
        assert r["info"]["ring_shards"] == 4
        _same_state(first["state"], r["state"])


def test_ranks_read_one_snapshot_per_episode(two_ranks):
    per_rank, _ = two_ranks
    a, b = (r["snapshots"] for r in per_rank)
    assert sorted(a) == list(range(6))
    assert a == b
    # the source moved during the run: later episodes see later bursts
    assert len(set(a.values())) > 1


def test_factory_curriculum_draws_each_episode_once(two_ranks):
    per_rank, _ = two_ranks
    a, b = (r["factory"] for r in per_rank)
    assert sorted(a["draws"]) == list(range(8))
    assert a["draws"] == b["draws"]
    weights = {tuple(w) for w, _ in a["draws"].values()}
    assert len(weights) > 1, weights
    for r in (a, b):
        assert r["rank"]["async"]["episodes_drained"] == 8
        assert r["rank"]["async"]["transitions_lost"] == 0
    assert a["rank"]["state_sha256"] == b["rank"]["state_sha256"]


def test_collective_from_another_thread_raises(two_ranks):
    per_rank, _ = two_ranks
    for r in per_rank:
        assert len(r["guard"]) == 1 and "gsc-rogue" in r["guard"][0]


def test_tp_only_carving_refused_everywhere():
    plan = ShardingPlan.from_spec("1x2")
    with pytest.raises(ValueError, match="dp") as err:
        plan.assert_async_capable()
    assert "Recarve" in str(err.value) and "2x1" in str(err.value)
    stack = MeshStack(2)
    pddpg = ParallelDDPG(stack.env, stack.pddpg.agent, 2, device="cpu",
                         plan=plan)
    with pytest.raises(ValueError, match="Recarve"):
        run_async(pddpg, lambda ep: stack.rows, object(), object(),
                  episodes=1, episode_steps=STEPS, chunk=CHUNK, seed=0,
                  cfg=AsyncConfig(actor_threads=1))
    with pytest.raises(SystemExit, match="Recarve"):
        cli.run_train(["--device", "cpu", "--async", "--replicas", "2",
                       "--mesh", "1x2"])
    with pytest.raises(SystemExit, match="tp"):
        cli.run_train(["--device", "cpu", "--async", "--replicas", "2",
                       "--mesh", "2x1", "--partition-rules", "tp"])
    # a dp carving passes the flag checks
    args = cli._parser().parse_args(["train", "--device", "cpu", "--async",
                                     "--replicas", "2", "--mesh", "2x1"])
    cli._check_train_args(args)
    assert args.mesh == "2x1"


def test_async_mesh_checkpoint_resumes_without_mesh_and_synchronously(
        two_ranks):
    from gsc_tpu_torch.agents.trainer import Trainer
    from gsc_tpu_torch.utils.checkpoint import load_full_or_partial

    per_rank, argv = two_ranks
    first, sync = per_rank[0]["legs"][:2]
    assert first["summary"]["drain"]["transitions_lost"] == 0
    assert [h["episode"] for h in sync["history"]] == [2]
    # the checkpoint's ring is the gathered one, bit for bit
    args = cli._parser().parse_args(["train", *argv["past"]])
    env, driver, agent = cli._build(args, None)
    trainer = Trainer(env, driver, agent, seed=0, device="cpu")
    state, template = trainer.template(4)
    _, ok = load_full_or_partial(argv["ckpt"], state, buffer=template,
                                 draws=trainer.draws)
    assert ok
    _same_ring(template, first["buffers"])
    _same_state(_cpu_leaves(state), first["state"])
    out = cli.run_train(argv["past"] + ["--episodes", "3", "--async",
                                        "--async-actors", "1",
                                        "--resume", argv["ckpt"]])
    assert [h["episode"] for h in out["trainer"].history] == [2]
    assert out["summary"]["drain"]["transitions_lost"] == 0


def test_flat_agent_on_two_ranks(two_ranks):
    per_rank, argv = two_ranks
    flat_mesh, flat_async = per_rank[0]["legs"][2:]
    want = cli.run_train(argv["warm"] + ["--episodes", "2"])
    assert not want["trainer"].agent_cfg.graph_mode
    _same_state(_cpu_leaves(want["state"]), flat_mesh["state"])
    _same_ring(want["buffers"], flat_mesh["buffers"])
    drain = flat_async["summary"]["drain"]
    assert drain["produced_steps"] == drain["ingested_steps"] == 2 * 2 * 2
    assert drain["transitions_lost"] == 0 and drain["episodes_drained"] == 2
    for rank in flat_async["rank"], per_rank[1]["legs"][3]["rank"]:
        assert rank["async"]["actor_collectives"] == 0
        assert rank["async"]["ingest_collectives"] == 0
    # every rank ends with the same learner state (its digest)
    for leg in (0, 3):
        digests = {r["legs"][leg]["rank"]["state_sha256"] for r in per_rank}
        assert len(digests) == 1
    assert sorted(h["episode"] for h in flat_async["history"]) == [0, 1]


def test_flat_agent_async_frozen_fills_the_synchronous_ring():
    stack = MeshStack(2, graph_mode=False)
    res = stack.run(3, FROZEN)
    assert res.info["publishes"] == 0
    p = stack.pddpg
    actor = p.actor_copy(p.init(torch.Generator().manual_seed(0)).actor)
    draws = p.actor_draws(0, 0)
    ring = p.init_buffers(stack.one)
    for ep in range(3):
        env_states, obs = p.reset_all(*stack.rows)
        for c in range(STEPS // CHUNK):
            _, ring, env_states, obs, _ = p.rollout_episodes(
                None, ring, env_states, obs, *stack.rows,
                ep * STEPS + c * CHUNK, CHUNK, actor=actor, draws=draws)
    _same_ring(res.buffers, ring)


@pytest.mark.cuda
def test_async_mesh_on_card(tmp_path, capsys):
    """``train --async --mesh 2x1`` on two ranks sharing the card (gloo)
    at the tiny size: every episode drained on both ranks, nothing lost,
    no collective from an actor thread or an ingest, both ranks' learner
    states equal, every rank launching both kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    past = _write(tmp_path, 2)
    past[past.index("cpu")] = "cuda"
    out = cli.run_train(past + ["--episodes", "3", "--async",
                                "--async-actors", "2", "--mesh", "2x1"],
                        devices=["cuda:0"] * 2, deadline_s=300)
    capsys.readouterr()
    assert len({r["state_sha256"] for r in out["ranks"]}) == 1
    for rank in out["ranks"]:
        info = rank["async"]
        assert info["episodes_drained"] == 3 and info["transitions_lost"] == 0
        assert info["actor_collectives"] == 0
        assert info["ingest_collectives"] == 0
        assert rank["launches"]["substep_megakernel"] > 0
        assert rank["launches"]["gat_attention_backward"] > 0
