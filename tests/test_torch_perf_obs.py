"""The port's device-cost ledger (``gsc_tpu_torch.obs.perf``), held to the
contracts of the JAX package's (tests/test_perf_obs.py:45-190) on the
CPU at small sizes:

- the ledger's fields are arithmetically consistent (MFU, bandwidth use
  and the roofline from the counts and the merged wall; schema 1), and
  its entries carry the JAX ledger's keys (``fusions`` None: no compiled
  program);
- a capture failure is recorded and never raised: the dispatch runs; a
  profile that lost device records leaves ``launches`` None with the
  counts in ``no_profile``;
- the ledger adds nothing to a later dispatch: no mode, no tap, no sync;
- a tiny pipelined ``Trainer.train`` writes ``perf.json`` with
  ``episode_step`` (the observed dispatch left out of ``dispatches``)
  and one ``compile_cost`` event, which ``tools/obs_report.py`` and the
  trace exporter read;
- the serial and ``--replicas`` runs give the JAX CLI's entry names for
  the same configuration (the pipelined one: tests/test_torch_cli_run.py),
  ``--mesh`` and the scenario factory the JAX trainer's;
- ``tools/bench_diff.py ingest`` and ``tools/obs_report.py`` read the
  port's ``perf.json`` unchanged;
- FLOPs of an actor forward (under ``no_grad`` and ``inference_mode``)
  and of a learn burst equal the matmul count plus ``ops.cost``'s kernel
  counts exactly: the forward's against the closed form of the network's
  linear layers, the burst's against ``torch.utils.flop_counter``'s count
  of the same burst with the attention's plain version hidden from it;
- a kernel's work is counted once, as ``ops.cost`` counts it on the
  launch's inputs, read after the observed call; past ``HOLD_BYTES`` of
  held inputs the counts settle mid-call to the same numbers and let go
  of their inputs;
- checkpoints are byte-equal after ``cli train --device cpu`` with
  ``--perf`` and ``--no-perf`` (pipelined, serial, replicas);
- a served learned tier lists ``serve_policy_b<B>`` per bucket (one
  ledger for a fleet); the SPR tier captures nothing.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401

from gsc_tpu_torch import cli
from gsc_tpu_torch.analysis import no_host_sync
from gsc_tpu_torch.obs import (PEAK_ENVELOPES, PERF_SCHEMA_VERSION,
                               CostLedger, ListSink, MetricsHub, RunObserver)
from gsc_tpu_torch.obs.trace import build_trace, read_events, validate_trace
from gsc_tpu_torch.ops import cost
from gsc_tpu_torch.ops.gat_attention import gat_attention
from test_torch_single_env import TINY_AGENT, TINY_SIM, _port_stack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import obs_report  # noqa: E402


def _mm(a, b):
    return torch.tanh(a @ b).sum()


# ------------------------------------------------------------- the ledger
def test_cost_ledger_fields_arithmetically_consistent():
    hub = MetricsHub(tags={"run": "ledger"})
    sink = ListSink()
    hub.add_sink(sink)
    led = CostLedger(hub=hub)
    a = torch.ones(64, 64)
    led.capture("mm", _mm, a, a, device="cpu")
    entry = led.entry("mm")
    assert entry["available"] is True
    assert entry["flops"] == 2 * 64 ** 3       # the matmul; tanh, sum: 0
    assert entry["bytes_accessed"] > 3 * 64 * 64 * 4
    assert entry["fusions"] is None
    assert set(entry["ops"]) == {"while", "dot", "scatter", "gather"}
    assert entry["ops"]["dot"] == 1 and entry["ops"]["while"] is None
    assert entry["arithmetic_intensity"] == pytest.approx(
        entry["flops"] / entry["bytes_accessed"], rel=1e-3)
    assert entry["launches"] is None and entry["device_s"] is None \
        and entry["no_profile"].startswith("no card")
    # one structured compile_cost event per capture
    (ev,) = sink.of_kind("compile_cost")
    assert ev["fn"] == "mm" and ev["flops"] == entry["flops"]
    assert ev["fusions"] is None and ev["launches"] is None

    # timing merge: MFU/roofline derive exactly from flops x wall x peak
    led.note_timing("mm", total_s=0.5, count=100)
    full = led.entry("mm")
    assert full["dispatches"] == 100
    assert full["wall_s_mean"] == pytest.approx(0.005)
    peak = PEAK_ENVELOPES["cpu"]
    assert led.peaks()["placeholder"] is True
    assert full["achieved_flops_per_s"] == pytest.approx(
        entry["flops"] / 0.005, rel=1e-3)
    assert full["mfu"] == pytest.approx(
        (entry["flops"] / 0.005) / peak["flops_per_s"], rel=1e-2)
    roof = full["roofline"]
    ridge = peak["flops_per_s"] / peak["bytes_per_s"]
    assert roof["ridge"] == pytest.approx(ridge, rel=1e-3)
    assert roof["regime"] == ("memory_bound" if roof["intensity"] < ridge
                              else "compute_bound")
    assert roof["roof_multiple"] >= 1.0
    # an observed dispatch left out of the timings
    led.exclude("mm", 0.1)
    led.note_timing("mm", total_s=0.6, count=101)
    assert led.entry("mm")["dispatches"] == 100
    assert led.entry("mm")["wall_s_total"] == pytest.approx(0.5)

    # schema-versioned document roundtrip
    doc = led.summary()
    assert doc["schema_version"] == PERF_SCHEMA_VERSION == 1
    assert doc["backend"] == "cpu" and doc["card"] is None
    assert doc["run"] == "ledger"
    assert json.loads(json.dumps(doc))["entries"]["mm"]["mfu"] \
        == full["mfu"]


def test_entries_carry_the_jax_ledgers_keys():
    import jax
    import jax.numpy as jnp

    from gsc_tpu.obs.perf import CostLedger as JaxLedger

    jax.config.update("jax_platforms", "cpu")
    j = JaxLedger()
    a = jnp.ones((64, 64), jnp.float32)
    j.capture("mm", jax.jit(lambda x, y: jnp.tanh(x @ y).sum()), (a, a))
    j.note_timing("mm", 0.5, 100)
    led = CostLedger()
    led.capture("mm", _mm, torch.ones(64, 64), torch.ones(64, 64),
                device="cpu")
    led.note_timing("mm", 0.5, 100)
    want, got = j.entry("mm"), led.entry("mm")
    # memory residency is a compiled executable's; the port has none
    assert set(want) - {"memory"} <= set(got)
    assert set(want["ops"]) == set(got["ops"])
    assert set(j.summary()) <= set(led.summary())


def test_cost_ledger_capture_failure_is_nonfatal(monkeypatch):
    from gsc_tpu_torch.obs import perf as perf_mod

    def broken(self):
        raise RuntimeError("no capture here")

    monkeypatch.setattr(perf_mod._Capture, "open", broken)
    led = CostLedger()
    a = torch.ones(8, 8)
    out = led.capture("broken", _mm, a, a, device="cpu")
    assert float(out) == pytest.approx(64 * float(torch.tanh(torch.tensor(
        8.0))))
    entry = led.entry("broken")
    assert entry["available"] is False and "no capture here" in \
        entry["error"]
    # an unavailable entry serializes without derived fields
    led.note_timing("broken", 1.0, 10)
    doc = json.loads(json.dumps(led.summary()))
    assert doc["entries"]["broken"]["available"] is False
    assert "mfu" not in doc["entries"]["broken"]
    assert torch._C._len_torch_dispatch_stack() == 0


def test_a_failing_count_is_recorded_not_raised(monkeypatch):
    def boom(*a):
        raise ValueError("unreadable adjacency")

    monkeypatch.setattr(cost, "edge_ops", boom)
    led = CostLedger()
    g = torch.Generator().manual_seed(0)
    xl, xr = torch.randn(2, 5, 3, generator=g), torch.randn(2, 5, 3,
                                                            generator=g)
    att, bias = torch.randn(3, generator=g), torch.randn(3, generator=g)
    adj = torch.rand(2, 5, 5, generator=g) < 0.5
    out = led.capture("att", gat_attention, xl, xr, att, bias, adj,
                      device="cpu")
    assert out.shape == xl.shape
    assert led.entry("att")["available"] is False
    assert "unreadable adjacency" in led.entry("att")["error"]


@pytest.mark.parametrize("seen", [0, 2, 3])
def test_a_profile_that_lost_records_leaves_launches_null(seen):
    """The card's profiler drops a profile's records now and then: an
    observation whose hand-kernel launches differ from the wrappers'
    posts records no launches and no device seconds, with both counts in
    ``no_profile``, and is not taken again; a complete one keeps its
    counts."""
    from gsc_tpu_torch.analysis.launches import Frame

    f = Frame()
    f.launches, f.device_s = 40, 0.5
    f.by_kind.update(gemm=10, gat_attention=seen)
    per = {"gat_attention": {"launches": 3, "flops": 1.0, "bytes": 1.0}}
    led = CostLedger()
    led._record(("step",), f, cost.Work(), per, 0.1, True)
    e = led.entry("step")
    assert e["available"] and not led.wants("step")
    if seen == 3:
        assert e["launches"] == {"count": 40, "by_kind": {
            "gemm": 10, "gat_attention": 3}}
        assert e["device_s"] == 0.5 and "no_profile" not in e
    else:
        assert e["launches"] is None and e["device_s"] is None
        assert e["no_profile"] == (
            "the profiler lost device records: the hand kernels posted "
            f"{{'gat_attention': 3}}, it recorded {{'gat_attention': "
            f"{seen}}}")


def _attention_burst(steps: int):
    """``steps`` forward and backward passes of the attention, each on a
    fresh adjacency (as a learn burst builds one per forward)."""
    g = torch.Generator().manual_seed(3)
    b, n, f = 4, 8, 4
    xl = torch.randn(b, n, f, generator=g, requires_grad=True)
    xr = torch.randn(b, n, f, generator=g)
    att, bias = torch.randn(f, generator=g), torch.randn(f, generator=g)
    adjs = [torch.rand(b, n, n, generator=g) < 0.3 for _ in range(steps)]

    def burst():
        for adj in adjs:
            out = gat_attention(xl, xr, att, bias, adj.clone())
            torch.autograd.grad(out.sum(), [xl])
    return burst


def test_held_inputs_settle_mid_call_to_the_same_counts(monkeypatch):
    """Past HOLD_BYTES of held inputs (here: any) the capture settles the
    deferred counts mid-call: the entry counts what the capture that
    holds every input to its end counts, no input stays held past one
    post, and no value is read inside the call."""
    from gsc_tpu_torch.analysis import launches

    led = CostLedger()
    led.capture("burst", _attention_burst(5), device="cpu")
    want = led.entry("burst")

    held, settles = [], []
    post, settle = launches.CostCounter.post, launches.Frame.settle

    def watched_post(self, name, parts):
        post(self, name, parts)
        held.append(self.held_bytes)

    def counted_settle(self, memo):
        settles.append(len(self.posts))
        return settle(self, memo)

    monkeypatch.setattr(launches, "HOLD_BYTES", 0)
    monkeypatch.setattr(launches.CostCounter, "post", watched_post)
    monkeypatch.setattr(launches.Frame, "settle", counted_settle)
    led = CostLedger()
    led.capture("burst", _attention_burst(5), device="cpu")
    got = led.entry("burst")
    # every forward post settles on its thread; the backward's wait for
    # the next forward post or the end
    assert len(held) == 10 and len(settles) > 5 and max(held) <= 4 * 8 * 8
    for k in ("flops", "bytes_accessed", "kernels", "host_syncs", "ops"):
        assert got[k] == want[k], k
    assert got["host_syncs"] == 0


def test_a_failing_count_settled_mid_call_is_recorded_not_raised(
        monkeypatch):
    from gsc_tpu_torch.analysis import launches

    def boom(*a):
        raise ValueError("unreadable adjacency")

    monkeypatch.setattr(launches, "HOLD_BYTES", 0)
    monkeypatch.setattr(cost, "edge_ops", boom)
    led = CostLedger()
    led.capture("burst", _attention_burst(2), device="cpu")
    e = led.entry("burst")
    assert e["available"] is False and "unreadable adjacency" in e["error"]
    assert torch._C._len_torch_dispatch_stack() == 0


def test_ledger_adds_no_host_sync_to_dispatch():
    """After a capture the dispatch path carries nothing of it: no mode,
    no tap, no value read; a dispatch that raises inside an observation
    records nothing and leaves nothing behind."""
    a = torch.ones(32, 32)
    led = CostLedger()
    led.capture("mm", _mm, a, a, device="cpu")
    assert torch._C._len_torch_dispatch_stack() == 0 and cost.tap() is None
    with no_host_sync("perf-instrumented dispatch"):
        out = _mm(a, a)                  # dispatch only: no tripwire
    assert torch.isfinite(out)            # read outside the guard

    with pytest.raises(ZeroDivisionError):
        with led.observe("raises", device="cpu"):
            _mm(a, a)
            1 / 0
    assert not led.has("raises") and led.wants("raises")
    assert torch._C._len_torch_dispatch_stack() == 0


# ------------------------------------------------------------ end-to-end
def _observed_trainer(obs):
    from gsc_tpu_torch.agents.trainer import Trainer

    stack = _port_stack()
    return Trainer(stack.env, stack.driver, stack.agent_cfg, seed=0,
                   device="cpu", obs=obs)


def test_tiny_run_writes_perf_json_and_valid_trace(tmp_path):
    """A tiny pipelined train run under RunObserver(perf=True) produces a
    complete cost ledger for episode_step (its observed first dispatch
    left out of the dispatch count) and an event stream the trace
    exporter renders into a valid trace."""
    obs = RunObserver(str(tmp_path / "obs"), run_id="perfrun", perf=True)
    obs.start(meta={"episodes": 3})
    trainer = _observed_trainer(obs)
    trainer.train(3)
    obs.close()

    with open(tmp_path / "obs" / "perf.json") as f:
        perf = json.load(f)
    assert perf["schema_version"] == PERF_SCHEMA_VERSION
    assert set(perf["entries"]) == {"episode_step"}
    e = perf["entries"]["episode_step"]
    assert e["available"] and e["flops"] > 0 and e["bytes_accessed"] > 0
    assert e["fusions"] is None
    assert set(e["kernels"]) == {"gat_attention", "gat_attention_backward",
                                 "substep_megakernel"}
    # the step reads nothing back (the no_host_sync contract of
    # tests/test_torch_no_host_sync.py, seen by the ledger)
    assert e["host_syncs"] == 0
    assert e["dispatches"] == 2 and e["wall_s_total"] > 0
    assert 0 < e["mfu"] < 1
    assert e["roofline"]["regime"] in ("memory_bound", "compute_bound")
    assert e["arithmetic_intensity"] == pytest.approx(
        e["flops"] / e["bytes_accessed"], rel=1e-3)
    assert "dispatch" in perf["phases"]

    events = read_events(str(tmp_path / "obs" / "events.jsonl"))
    costs = [ev for ev in events if ev["event"] == "compile_cost"]
    assert [ev["fn"] for ev in costs] == ["episode_step"]
    assert costs[0]["flops"] == e["flops"]
    assert events[0]["perf"] is True

    # obs_report renders the ledger without error
    summary = obs_report.summarize(
        obs_report.load_events(str(tmp_path / "obs")),
        perf=obs_report.load_perf(str(tmp_path / "obs")))
    assert summary["perf"]["entries"]["episode_step"]["mfu"] == e["mfu"]
    with open(os.devnull, "w") as devnull:
        obs_report.render_text(summary, out=devnull)

    trace = build_trace(events)
    assert validate_trace(trace) == []
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "cost episode_step" in names and "dispatch" in names


@pytest.fixture
def tiny(tmp_path):
    (tmp_path / "agent.yaml").write_text(TINY_AGENT)
    (tmp_path / "sim.yaml").write_text(TINY_SIM)
    return tmp_path


def _port_run(d, name, *extra):
    cli.run_train(["--device", "cpu", "--agent-config", str(d / "agent.yaml"),
                   "--simulator-config", str(d / "sim.yaml"), "--network",
                   "abilene", "--episodes", "3", "--result-dir",
                   str(d / name), *extra])
    return d / name


def _entries(run_dir):
    with open(os.path.join(run_dir, "perf.json")) as f:
        return json.load(f)["entries"]


@pytest.mark.parametrize("mode", ["serial", "replicas"])
def test_entry_names_match_the_jax_cli(tiny, mode, capsys):
    import jax
    from click.testing import CliRunner

    from gsc_tpu.cli import cli as j_cli

    jax.config.update("jax_platforms", "cpu")
    flags = {"serial": ["--no-pipeline"],
             "replicas": ["--replicas", "2", "--chunk", "3"]}[mode]
    cli.init_configs(str(tiny / "c"))
    res = CliRunner().invoke(j_cli, [
        "train", str(tiny / "agent.yaml"), str(tiny / "sim.yaml"),
        str(tiny / "c" / "service_abc.yaml"),
        str(tiny / "c" / "scheduler.yaml"), "--episodes", "2",
        "--result-dir", str(tiny / "j"), *flags], catch_exceptions=False)
    assert res.exit_code == 0, res.output
    jrun = json.loads(res.output.strip().splitlines()[-1])["result_dir"]
    cli.run_train(["--device", "cpu", "--agent-config",
                   str(tiny / "agent.yaml"), "--simulator-config",
                   str(tiny / "sim.yaml"), "--service",
                   str(tiny / "c" / "service_abc.yaml"), "--scheduler",
                   str(tiny / "c" / "scheduler.yaml"), "--episodes", "2",
                   "--result-dir", str(tiny / "t"), *flags])
    capsys.readouterr()
    want = {"serial": {"rollout_episode", "learn_burst"},
            "replicas": {"chunk_step", "learn_burst"}}[mode]
    assert set(_entries(jrun)) == want
    got = _entries(tiny / "t")
    assert set(got) == want and all(e["available"] for e in got.values())
    # the replica path's timings: the dispatch phase (less the observed
    # episode) to the fused entry alone, as in the JAX package (the learn
    # bursts are enqueued, not waited for)
    if mode == "replicas":
        assert got["chunk_step"]["dispatches"] == 1
        assert "dispatches" not in got["learn_burst"]


def test_mesh_and_factory_entries(tiny, capsys):
    """Under ``--mesh`` rank 0 records ``chunk_step_sharded`` beside the
    plain entries, with the collectives its dispatch ran; the scenario
    factory adds ``factory_sample`` (the JAX trainer's names)."""
    run = _port_run(tiny, "mesh", "--replicas", "4", "--chunk", "3",
                    "--mesh", "2x1")
    got = _entries(run)
    assert set(got) == {"chunk_step", "chunk_step_sharded", "learn_burst"}
    col = got["chunk_step_sharded"]["collectives"]
    assert col["count"] > 0 and col["bytes"] > 0
    assert set(col["ops"]) <= {"all-gather", "broadcast", "all-reduce"}
    run = _port_run(tiny, "factory", "--replicas", "4", "--chunk", "3",
                    "--topo-mix", "factory:all")
    got = _entries(run)
    assert set(got) == {"chunk_step", "learn_burst", "factory_sample"}
    assert got["factory_sample"]["available"]
    assert "dispatches" not in got["factory_sample"]
    capsys.readouterr()


def test_tools_read_the_port_perf_json(tiny, capsys):
    run = _port_run(tiny, "r")
    capsys.readouterr()
    rows = tiny / "rows.json"
    ing = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                       "bench_diff.py"),
                          "ingest", "--scan", str(run), "--out", str(rows)],
                         capture_output=True, text=True)
    assert ing.returncode == 0, ing.stderr
    with open(rows) as f:
        metrics = json.load(f)["rows"]["perf_r"]["metrics"]
    assert metrics["episode_step_flops"] == \
        _entries(run)["episode_step"]["flops"]
    assert metrics["episode_step_mfu"] > 0
    diff = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                        "bench_diff.py"),
                           "diff", str(run / "perf.json"), "--baseline",
                           "perf_r", "--trajectory", str(rows)],
                          capture_output=True, text=True)
    assert diff.returncode == 0, diff.stdout + diff.stderr
    rep = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                       "obs_report.py"),
                          str(run)], capture_output=True, text=True)
    assert rep.returncode == 0, rep.stderr
    assert "perf ledger: schema v1" in rep.stdout
    assert "episode_step" in rep.stdout


# ------------------------------------------------------------ exact counts
def _agent():
    from gsc_tpu_torch.config.schema import AgentConfig

    return AgentConfig(episode_steps=4, gnn_features=4, gnn_num_layers=2,
                       gnn_num_iter=2, actor_hidden_layer_nodes=(8,),
                       critic_hidden_layer_nodes=(8,), batch_size=4,
                       mem_limit=8, nb_steps_warmup_critic=2,
                       gnn_impl="pallas")


def _stack():
    """A trainer over _port_stack's schedule with a 2-layer, 2-iteration
    GNN, after one learning episode (its replay holds 4 transitions)."""
    from gsc_tpu_torch.agents.trainer import Trainer
    from gsc_tpu_torch.env.env import ServiceCoordEnv

    base = _port_stack()
    agent = _agent()
    env = ServiceCoordEnv(base.env.service, base.env.sim_cfg, agent,
                          base.env.limits)
    trainer = Trainer(env, base.driver, agent, seed=3, device="cpu")
    state, buffer = trainer.train(1)
    return trainer, state, buffer


def _actor_matmul_flops(actor, agent, obs):
    """The closed form of the monolithic actor's matmuls: the encoder's
    two projections, the process convs' (num_iter x (num_layers - 1)),
    the MLP's layers; each 2 x rows x fan_in x fan_out."""
    b, n, fin = obs.nodes.shape
    f = agent.gnn_features
    convs = agent.gnn_num_iter * (agent.gnn_num_layers - 1)
    flops = 2 * (2 * b * n * fin * f) + convs * 2 * (2 * b * n * f * f)
    for lin in actor.mlp.layers:
        flops += 2 * b * lin.in_features * lin.out_features
    return flops, 1 + convs


@pytest.mark.parametrize("mode", ["no_grad", "inference"])
def test_actor_forward_flops_are_the_matmuls_plus_the_kernel(mode):
    from gsc_tpu_torch.ops.gat import dense_adj

    trainer, state, _ = _stack()
    agent = trainer.agent_cfg
    topo, traffic = trainer._episode(0)
    _, obs = trainer.env.reset(topo, traffic, batch=3)
    ctx = torch.inference_mode if mode == "inference" else torch.no_grad
    led = CostLedger()

    def forward():
        with ctx():
            return state.actor(obs)

    led.capture("actor", forward, device="cpu")
    e = led.entry("actor")
    matmuls, convs = _actor_matmul_flops(state.actor, agent, obs)
    f = agent.gnn_features
    adj = dense_adj(obs.edge_index, obs.edge_mask, obs.node_mask)
    kernel = cost.edge_ops(adj, 6 * f + 3, 2 * f).flops
    assert e["kernels"]["gat_attention"]["launches"] == convs
    assert e["kernels"]["gat_attention"]["flops"] == convs * kernel
    assert e["flops"] == matmuls + convs * kernel


def test_learn_burst_flops_are_the_matmuls_plus_the_kernels(monkeypatch):
    import copy

    from torch.utils._python_dispatch import _disable_current_modes
    from torch.utils.flop_counter import FlopCounterMode

    from gsc_tpu_torch.agents.buffer import buffer_sample
    from gsc_tpu_torch.agents.ddpg import Draws
    from gsc_tpu_torch.ops import gat_attention as ga

    trainer, state, buffer = _stack()
    ddpg = trainer.ddpg
    n = trainer.agent_cfg.batch_size

    def burst(st):
        draws = Draws(11, "cpu")
        return ddpg.learn_burst(st, lambda: buffer_sample(buffer, draws, n),
                                steps=3)

    led = CostLedger()
    led.capture("learn_burst", burst, copy.deepcopy(state), device="cpu")
    got = led.entry("learn_burst")

    # the same burst with the attention's plain version hidden from torch's
    # own flop counter, its launches recorded to count with ops.cost
    calls = []

    class Hidden(torch.autograd.Function):
        @staticmethod
        def forward(ctx, xl, xr, att, bias, adj, mean_aggr):
            with _disable_current_modes():
                out = ga.attention_dense(xl, xr, att, bias, adj, mean_aggr)
            ctx.save_for_backward(xl, xr, att, adj)
            ctx.mean_aggr = mean_aggr
            calls.append(cost.attention_work(xl, xr, att, bias, adj))
            return out

        @staticmethod
        def backward(ctx, grad):
            xl, xr, att, adj = ctx.saved_tensors
            with _disable_current_modes():
                grads = ga.attention_backward_plain(grad, xl, xr, att, adj,
                                                    ctx.mean_aggr)
            calls.append(cost.attention_backward_work(grad, xl, xr, att,
                                                      adj))
            return (*grads, None, None)

    monkeypatch.setattr(ga, "attention_plain", Hidden.apply)
    with FlopCounterMode(display=False) as fc:
        burst(copy.deepcopy(state))
    matmuls = fc.get_total_flops()
    assert matmuls > 0 and len(calls) == sum(
        r["launches"] for r in got["kernels"].values())
    assert got["flops"] == matmuls + sum(w.flops for w in calls)


def test_kernel_work_is_counted_once_on_the_launchs_inputs():
    """The attention's forward and gradient, and one interval of the
    substep, each count as ``ops.cost`` counts their inputs; the plain
    versions' own aten calls and the counts' reads of the data stay out
    (a capture of dispatches alone shows no value read)."""
    g = torch.Generator().manual_seed(1)
    b, n, f = 3, 6, 4
    xl = torch.randn(b, n, f, generator=g, requires_grad=True)
    xr = torch.randn(b, n, f, generator=g)
    att, bias = torch.randn(f, generator=g), torch.randn(f, generator=g)
    adj = torch.rand(b, n, n, generator=g) < 0.4
    led = CostLedger()

    def fwd_bwd():
        out = gat_attention(xl, xr, att, bias, adj)
        torch.autograd.grad(out.sum(), [xl])

    led.capture("att", fwd_bwd, device="cpu")
    e = led.entry("att")
    fw = cost.attention_work(xl, xr, att, bias, adj)
    bw = cost.attention_backward_work(xl, xl, xr, att, adj)
    assert e["kernels"]["gat_attention"] == {
        "launches": 1, "flops": fw.flops, "bytes": fw.bytes}
    assert e["kernels"]["gat_attention_backward"] == {
        "launches": 1, "flops": bw.flops, "bytes": bw.bytes}
    # no matmul outside the kernels: the flops are theirs alone
    assert e["flops"] == fw.flops + bw.flops
    assert e["host_syncs"] == 0 and e["ops"]["dot"] == 0

    from gsc_tpu_torch.ops.substep import substep_megakernel
    from gsc_tpu_torch.sim import cases

    case = cases.abilene_case(batch=2, intervals=1, seed=7)
    eng = case.engine
    st, cap = eng.begin_interval(cases.run_case(case, "cpu")[-1],
                                 case.traffic, case.schedule, case.placement)
    topo = case.topo.expand(2)
    led.capture("interval", substep_megakernel, eng, st, topo, case.traffic,
                cap, device="cpu")
    want = cost._evaluate(cost.substep_launch_parts(eng, st, case.traffic,
                                                    None, None))
    got = led.entry("interval")
    assert got["kernels"]["substep_megakernel"] == {
        "launches": 1, "flops": want.flops, "bytes": want.bytes}
    assert got["flops"] == want.flops and got["host_syncs"] == 0


# ------------------------------------------------------- bits and serving
@pytest.mark.parametrize("flags", [[], ["--no-pipeline"],
                                   ["--replicas", "2", "--chunk", "3"]],
                         ids=["pipelined", "serial", "replicas"])
def test_checkpoints_are_byte_equal_with_and_without_perf(tiny, flags,
                                                          capsys):
    on = _port_run(tiny, "on", *flags)
    off = _port_run(tiny, "off", *flags, "--no-perf")
    capsys.readouterr()
    assert (on / "perf.json").is_file() and not (off / "perf.json").exists()
    names = sorted(os.listdir(on / "checkpoint"))
    assert names == sorted(os.listdir(off / "checkpoint")) and names
    for name in names:
        assert (on / "checkpoint" / name).read_bytes() == \
            (off / "checkpoint" / name).read_bytes(), name


@pytest.mark.parametrize("workers", [1, 2])
def test_serve_lists_serve_policy_per_bucket(tmp_path, workers):
    from gsc_tpu_torch.config.schema import AgentConfig
    from gsc_tpu_torch.serve import run_serve

    agent = AgentConfig(episode_steps=4, gnn_features=4, gnn_num_layers=1,
                        gnn_num_iter=1, actor_hidden_layer_nodes=(8,),
                        critic_hidden_layer_nodes=(8,), gnn_impl="pallas")
    obs = RunObserver(str(tmp_path / "s"), perf=True)
    report = run_serve(agent, device="cpu", pool_steps=2, requests=24,
                       concurrency=4, buckets=(1, 4, 8), deadline_ms=5.0,
                       seed=0, seeded_actor=True, workers=workers,
                       observer=obs)
    assert not report.errors
    with open(tmp_path / "s" / "perf.json") as f:
        doc = json.load(f)
    entries = doc["entries"]
    assert sorted(entries) == ["serve_policy_b1", "serve_policy_b4",
                               "serve_policy_b8"]
    flops = [entries[f"serve_policy_b{b}"]["flops"] for b in (1, 4, 8)]
    assert 0 < flops[0] < flops[1] < flops[2]
    for b in (1, 4, 8):
        e = entries[f"serve_policy_b{b}"]
        assert e["available"] and e["kernels"]["gat_attention"][
            "launches"] == 1
        used = [bucket for _, bucket in report.flushes].count(b)
        assert e.get("dispatches", 0) == used
    costs = [ev for ev in read_events(str(tmp_path / "s" / "events.jsonl"))
             if ev["event"] == "compile_cost"]
    assert sorted(ev["fn"] for ev in costs) == sorted(entries)

    # the SPR tier has no policy call to capture
    spr = RunObserver(str(tmp_path / "spr"), perf=True)
    run_serve(agent, device="cpu", pool_steps=2, requests=4, seed=0,
              observer=spr)
    assert not (tmp_path / "spr" / "perf.json").exists()
