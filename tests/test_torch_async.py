"""Decoupled actor/learner training (``parallel.async_rl``,
``Trainer.train_async``, ``cli train --async``) on the CPU.

- ``make_replay_ingest`` byte-equal to the JAX package's on the same
  blocks, wrap included;
- one actor with publishing frozen: two runs fill bit-identical replays,
  equal to the port's own synchronous rollout of the same episodes with
  the same actor weights and random source (``ParallelDDPG
  .rollout_episodes``, which tests/test_torch_train.py holds against the
  JAX package);
- the drain accounting (every episode drained once, produced == ingested
  steps, bursts paced by ``learn_ratio``), the staleness bound under a
  throttled learner, a graceful stop that drains everything, the
  scenario stream independent of the number of actor threads;
- self-healing: ``actor_die`` restarted and, past the restart budget,
  degraded; ``ring_poison`` quarantined; ``nan_grads`` rolled back;
- the CLI flag contract (tests/test_async_rl.py's, minus ``--mesh``) and
  ``train_async`` end to end with its gauges.

The tests marked ``cuda`` need a card and import no JAX: on the card,
``python -m pytest --noconftest tests/test_torch_async.py -q -m cuda``
runs two actor threads on their own streams (the drain accounting and a
finite learner state) and the frozen-publish determinism there.

Every run joins its threads with a timeout (``run_async``'s 30 s join)
and each test is bounded by the fixture's tiny stack: a triangle padded to
8 nodes, GATv2 4 x 1 x 1, B = 2, 4-step episodes in chunks of 2.
Comparisons are exact (the same code on the same CPU).
"""
import copy

import numpy as np
import pytest
import torch

from gsc_tpu_torch.agents.buffer import ReplayBuffer
from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import AgentConfig, EnvLimits, SimConfig
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.parallel.async_rl import AsyncConfig, run_async
from gsc_tpu_torch.parallel.dp import ParallelDDPG, make_replay_ingest
from gsc_tpu_torch.resilience.faults import FaultPlan
from gsc_tpu_torch.resilience.guard import all_finite
from gsc_tpu_torch.sim.state import stack_traffic
from gsc_tpu_torch.sim.traffic import generate_traffic
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import compile_topology
from torch_port_helpers import one_torch_thread  # noqa: F401

B, STEPS, CHUNK = 2, 4, 2
AGENT_KW = dict(episode_steps=STEPS, gnn_features=4, gnn_num_layers=1,
                gnn_num_iter=1, actor_hidden_layer_nodes=(8,),
                critic_hidden_layer_nodes=(8,), batch_size=4, mem_limit=16,
                nb_steps_warmup_critic=2, objective="prio-flow",
                gnn_impl="pallas")


class Stack:
    """The tiny stack: one ParallelDDPG (shared by the runs, as the
    trainer shares it) and a fresh learner state and ring per run."""

    def __init__(self):
        agent = AgentConfig(**AGENT_KW)
        sim = SimConfig(inter_arrival_mean=2.0, run_duration=10.0,
                        ttl_choices=(100.0,))
        lim = EnvLimits.for_service(abc_service(), max_nodes=8, max_edges=8)
        self.env = ServiceCoordEnv(abc_service(), sim, agent, lim)
        self.topo = compile_topology(synthetic.triangle(
            node_caps=(2.0, 3.0, 2.0), num_ingress=2), max_nodes=8,
            max_edges=8)
        self.traffic = stack_traffic([generate_traffic(
            sim, abc_service(), self.topo, STEPS, seed=s) for s in range(B)])
        self.pddpg = ParallelDDPG(self.env, agent, B, device="cpu", seed=0)
        _, obs = self.env.reset(self.topo, self.traffic, batch=B)
        self.one = obs.map(lambda x: x[0])

    def scenario(self, ep):
        return self.topo, self.traffic

    def state(self):
        return self.pddpg.init(torch.Generator().manual_seed(0))

    def ring(self, capacity=None):
        return self.pddpg.init_buffers(self.one, capacity=capacity)

    def run(self, episodes=4, cfg=None, **kw):
        kw.setdefault("scenario_fn", self.scenario)
        return run_async(self.pddpg, kw.pop("scenario_fn"), self.state(),
                         kw.pop("buffers", None) or self.ring(),
                         episodes=episodes, episode_steps=STEPS, chunk=CHUNK,
                         seed=0, cfg=cfg or AsyncConfig(), **kw)


@pytest.fixture(scope="module")
def stack():
    return Stack()


def _ring_equal(a, b):
    for k in a.data:
        assert torch.equal(a.data[k].view(torch.uint8),
                           b.data[k].view(torch.uint8)), k
    assert torch.equal(a.pos, b.pos) and torch.equal(a.size, b.size)


# ------------------------------------------------------------ the ingest
def test_replay_ingest_matches_jax_with_wrap():
    import jax.numpy as jnp

    from gsc_tpu.agents.buffer import ReplayBuffer as JBuffer
    from gsc_tpu.parallel.async_rl import make_replay_ingest as j_make

    cap, t_n = 4, 3
    rng = np.random.default_rng(0)
    blocks = [{"x": rng.standard_normal((B, t_n, 2)).astype(np.float32),
               "y": rng.integers(0, 100, (B, t_n)).astype(np.int32),
               "z": rng.random((B, t_n)) > 0.5} for _ in range(3)]
    zeros = {"x": np.zeros((B, cap, 2), np.float32),
             "y": np.zeros((B, cap), np.int32),
             "z": np.zeros((B, cap), bool)}
    jbuf = JBuffer(data={k: jnp.asarray(v) for k, v in zeros.items()},
                   pos=jnp.zeros(B, jnp.int32), size=jnp.zeros(B, jnp.int32))
    tbuf = ReplayBuffer(data={k: torch.from_numpy(v.copy())
                              for k, v in zeros.items()},
                        pos=torch.zeros(B, dtype=torch.int32),
                        size=torch.zeros(B, dtype=torch.int32),
                        shapes={k: None for k in zeros})
    j_ingest, t_ingest = j_make(B, cap), make_replay_ingest(B, cap)
    for blk in blocks:
        jbuf = j_ingest(jbuf, {k: jnp.asarray(v) for k, v in blk.items()})
        tbuf = t_ingest(tbuf, {k: torch.from_numpy(v) for k, v in
                               blk.items()})
        for k in zeros:
            np.testing.assert_array_equal(tbuf.data[k].numpy(),
                                          np.asarray(jbuf.data[k]))
        np.testing.assert_array_equal(tbuf.pos.numpy(), np.asarray(jbuf.pos))
        np.testing.assert_array_equal(tbuf.size.numpy(),
                                      np.asarray(jbuf.size))
    # wrapped: the third block's slots [2, 3, 0] overwrote the first two
    assert tbuf.pos.tolist() == [1, 1] and tbuf.size.tolist() == [4, 4]
    assert tbuf.data["y"][:, 2].tolist() == blocks[2]["y"][:, 0].tolist()


def test_replay_ingest_rejects_undersized_ring(stack):
    with pytest.raises(ValueError, match="capacity"):
        stack.run(episodes=1, buffers=stack.ring(capacity=1))


# ------------------------------------------------------- determinism
def test_single_actor_frozen_publish_is_deterministic_and_synchronous(
        stack):
    cfg = AsyncConfig(actor_threads=1, publish_bursts=10 ** 6)
    r1, r2 = stack.run(episodes=3, cfg=cfg), stack.run(episodes=3, cfg=cfg)
    _ring_equal(r1.buffers, r2.buffers)
    assert r1.info["publishes"] == 0 and r1.info["bursts"] == 3
    assert [e["episodic_return"] for e in r1.episodes] == \
        [e["episodic_return"] for e in r2.episodes]
    # the same episodes rolled out synchronously, with the initial actor
    # and actor 0's random source, straight into one ring
    p = stack.pddpg
    actor = p.actor_copy(stack.state().actor)
    draws = p.actor_draws(0, 0)
    ring = stack.ring()
    for ep in range(3):
        env_states, obs = p.reset_all(stack.topo, stack.traffic)
        for c in range(STEPS // CHUNK):
            _, ring, env_states, obs, _ = p.rollout_episodes(
                None, ring, env_states, obs, stack.topo, stack.traffic,
                ep * STEPS + c * CHUNK, CHUNK, actor=actor, draws=draws)
    _ring_equal(r1.buffers, ring)


# --------------------------------------------------------- accounting
def test_drain_accounting_and_pacing(stack):
    recs = []
    res = stack.run(episodes=6, cfg=AsyncConfig(actor_threads=2),
                    on_episode=lambda rec, ring: recs.append(rec))
    info = res.info
    assert sorted(r["episode"] for r in recs) == list(range(6))
    assert info["episodes_drained"] == 6
    assert info["produced_steps"] == info["ingested_steps"] == 6 * STEPS * B
    assert info["transitions_lost"] == 0
    assert info["bursts"] == 6 and info["publishes"] >= 1
    assert {r["actor"] for r in recs} == {0, 1}
    assert res.buffers.size.tolist() == [min(6 * STEPS, 8)] * B
    half = stack.run(episodes=4, cfg=AsyncConfig(actor_threads=2,
                                                 learn_ratio=0.5))
    assert half.info["bursts"] == 2


def test_staleness_bound_under_throttled_learner(stack):
    from gsc_tpu_torch.utils.telemetry import PhaseTimer

    timer = PhaseTimer()
    bound = B * CHUNK
    res = stack.run(episodes=4, timer=timer, cfg=AsyncConfig(
        actor_threads=2, max_staleness=bound, throttle_s=1.0))
    info = res.info
    assert info["max_staleness"] == bound
    assert info["max_replay_lag"] <= bound
    assert info["produced_steps"] == info["ingested_steps"]
    assert "actor_idle" in timer.summary()
    assert info["actor_idle_frac"] > 0


def test_graceful_stop_drains_everything(stack):
    drained = []
    res = stack.run(episodes=40, cfg=AsyncConfig(actor_threads=2,
                                                 max_staleness=B * STEPS),
                    on_episode=lambda rec, ring: drained.append(rec),
                    should_stop=lambda: len(drained) >= 2)
    assert 2 <= res.info["episodes_drained"] < 40
    assert res.info["produced_steps"] == res.info["ingested_steps"]
    assert res.info["transitions_lost"] == 0


def test_scenario_stream_independent_of_thread_count(stack):
    seen = {}
    for n in (1, 2):
        calls = []

        def spy(ep, _calls=calls):
            _calls.append(ep)
            return stack.scenario(ep)

        stack.run(episodes=4, scenario_fn=spy,
                  cfg=AsyncConfig(actor_threads=n))
        seen[n] = sorted(calls)
    assert seen[1] == seen[2] == list(range(4))


# ------------------------------------------------------- self-healing
def _recoveries():
    got = []
    return got, lambda episode, **kw: got.append((kw["site"], kw["action"]))


def test_actor_die_restarts_then_degrades(stack):
    got, on_recovery = _recoveries()
    res = stack.run(episodes=4, cfg=AsyncConfig(actor_threads=2),
                    fault_plan=FaultPlan.parse("actor_die@a0:2"),
                    on_recovery=on_recovery)
    assert ("actor", "restart") in got
    assert res.info["actor_restarts"] == 1
    assert res.info["episodes_drained"] == 4
    got, on_recovery = _recoveries()
    res = stack.run(episodes=4, cfg=AsyncConfig(actor_threads=2,
                                                restart_budget=0),
                    fault_plan=FaultPlan.parse("actor_die@a1:1"),
                    on_recovery=on_recovery)
    assert ("actor", "degrade") in got
    assert res.info["actors_degraded"] == 1
    assert sorted(e["episode"] for e in res.episodes) == [0, 1, 2, 3]
    assert {e["actor"] for e in res.episodes} == {0}


def test_ring_poison_quarantined_and_nan_grads_rolled_back(stack):
    got, on_recovery = _recoveries()
    res = stack.run(episodes=4, cfg=AsyncConfig(actor_threads=1),
                    fault_plan=FaultPlan.parse("ring_poison@1;nan_grads@1"),
                    rollback=True, on_recovery=on_recovery)
    assert ("replay", "quarantine") in got
    assert ("learner_state", "rollback") in got
    info = res.info
    assert info["blocks_quarantined"] == 1 and info["rollbacks"] >= 1
    assert info["produced_steps"] == info["ingested_steps"]
    assert float(all_finite(res.state)) == 1.0
    assert all(torch.isfinite(d).all() for d in res.buffers.data.values()
               if d.is_floating_point())


# ------------------------------------------------------------- the CLI
def test_cli_async_flag_contract(tmp_path):
    from gsc_tpu_torch import cli

    with pytest.raises(SystemExit, match="--replicas"):
        cli.run_train(["--device", "cpu", "--async"])
    with pytest.raises(SystemExit, match="--async"):
        cli.run_train(["--device", "cpu", "--async-actors", "4"])
    with pytest.raises(SystemExit, match="--async-actors"):
        cli.run_train(["--device", "cpu", "--async", "--replicas", "2",
                       "--async-actors", "0"])
    with pytest.raises(SystemExit, match="--learn-ratio"):
        cli.run_train(["--device", "cpu", "--async", "--replicas", "2",
                       "--learn-ratio", "0"])
    # an async fault site is refused without --async only
    with pytest.raises(SystemExit, match="--async"):
        cli.run_train(["--device", "cpu", "--replicas", "2",
                       "--fault-plan", "ring_poison@1"])


def test_train_async_end_to_end_with_gauges(tmp_path):
    import json

    from gsc_tpu_torch import cli
    from test_torch_single_env import TINY_AGENT, TINY_SIM

    (tmp_path / "agent.yaml").write_text(TINY_AGENT.replace(
        "episode_steps: 3", "episode_steps: 4"))
    (tmp_path / "sim.yaml").write_text(TINY_SIM)
    out = cli.run_train([
        "--device", "cpu", "--replicas", "2", "--chunk", "2",
        "--episodes", "3", "--async", "--async-actors", "2",
        "--network", "abilene", "--agent-config", str(tmp_path / "agent.yaml"),
        "--simulator-config", str(tmp_path / "sim.yaml"),
        "--fault-plan", "learner_transient@1",
        "--result-dir", str(tmp_path / "r")])
    tr = out["trainer"]
    assert tr.completed_episodes == 3 and len(tr.history) == 3
    drain = out["summary"]["drain"]
    assert drain["produced_steps"] == drain["ingested_steps"] == 3 * 4 * 2
    assert drain["transitions_lost"] == 0 and drain["bursts"] == 3
    snap = json.load(open(tmp_path / "r" / "metrics.json"))["metrics"]
    for g in ("policy_lag", "replay_lag", "learner_idle_frac",
              "actor_idle_frac", "replay_fill_frac", "actor_policy_version"):
        assert any(k.split("{")[0].endswith(g) for k in snap), g
    assert any('phase="actor_dispatch"' in k for k in snap)
    assert any('phase="learner_idle"' in k for k in snap)
    events = [json.loads(l) for l in open(tmp_path / "r" / "events.jsonl")]
    kinds = {e["event"] for e in events}
    assert {"async_train", "async_actor_ep", "async_learner_spans"} <= kinds
    assert any(e["event"] == "recovery" and e["site"] == "learner"
               and e["action"] == "retry" for e in events)
    assert (tmp_path / "r" / "rewards.csv").read_text().count("\n") == 4
    assert all(np.isfinite(h["episodic_return"]) for h in tr.history)
    assert copy.deepcopy(out["state"].actor) is not None


# ------------------------------------------------------------ on the card
class CardStack(Stack):
    """The tiny stack on the card."""

    def __init__(self):
        super().__init__()
        dev = torch.device("cuda")
        self.pddpg = ParallelDDPG(self.env, self.pddpg.agent, B, device=dev,
                                  seed=0)
        self.topo, self.traffic = self.topo.to(dev), self.traffic.to(dev)
        self.one = self.one.map(lambda x: x.to(dev))


@pytest.mark.cuda
def test_two_actor_streams_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    card = CardStack()
    res = card.run(episodes=6, cfg=AsyncConfig(actor_threads=2))
    info = res.info
    assert info["produced_steps"] == info["ingested_steps"] == 6 * STEPS * B
    assert info["bursts"] == 6 and info["episodes_drained"] == 6
    assert float(all_finite(res.state)) == 1.0
    frozen = AsyncConfig(actor_threads=1, publish_bursts=10 ** 6)
    r1, r2 = card.run(episodes=3, cfg=frozen), card.run(episodes=3,
                                                         cfg=frozen)
    _ring_equal(r1.buffers, r2.buffers)
