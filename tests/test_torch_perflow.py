"""Per-flow control in the port against the JAX package.

Every case of tests/test_perflow.py runs through both packages on the
JAX package's traffic (its TrafficSchedule arrays fed to the port): flows
waiting without a decision, place-on-decision, the flow-action CSV
(byte-equal), ``apply_per_flow``, the idle-instance expiry, the duration
controller never expiring, truncated arrivals, the pending flows' network
view, the SPR algorithm end to end and its preference for running
instances, ``cli simulate`` under the local and the SPR algorithm, and the
loader's controller keys.  The two engines advance in lockstep and their
states are compared after every substep or interval.  Then the port's
``apply_per_flow`` with the local policy on the line3-egress oracle of
tests/test_reference_parity.py:210-257 (generated 201 +- 2, processed 197,
dropped 0, average end-to-end delay 35.0), and the megakernel wrapper's
refusals of what its per-flow mode does not take.

The tests marked ``cuda`` need a card and import no JAX (the JAX imports
of the others are inside them): on the card, ``python -m pytest
--noconftest tests/test_torch_perflow.py -q -m cuda`` holds the kernel's
per-flow mode against its plain version bit for bit on CPU copies of the
inputs on two battery cases, and K chained one-substep launches against
one K-substep launch in duration mode.

Tolerances: integer and boolean state exact; float state rtol 1e-5, atol
1e-5, the bar of tests/test_torch_substep.py (the port's scatter-adds and
sums may add in another order than XLA's one-hot contractions; on these
integer-valued cases they agree exactly).  The oracle's average
end-to-end delay rel 1e-6, as the JAX test holds it.
"""
import csv
import json
import os

import numpy as np
import pytest
import torch

from gsc_tpu_torch.config.schema import (EnvLimits, ServiceConfig,
                                         ServiceFunction, SimConfig)
from gsc_tpu_torch.ops.substep import substep_megakernel, substep_plain
from gsc_tpu_torch.sim import PerFlowController, SimEngine, cases
from gsc_tpu_torch.sim.perflow import local_decisions
from gsc_tpu_torch.sim.state import PH_DECIDE
from gsc_tpu_torch.topology.compiler import NetworkSpec, compile_topology
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-5
N, E = 8, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_reference_parity.py PERFLOW
ORACLE = {"generated": 201, "processed": 197, "dropped": 0, "avg_e2e": 35.0}
STATE_FIELDS = ("t", "cursor", "node_load", "sf_available", "placed",
                "sf_startup", "sf_last_active", "edge_used", "rel_node",
                "rel_edge", "truncated_arrivals", "run_idx")


# ----------------------------------------------------------------- helpers
def _service(jax_side=False):
    if jax_side:
        from gsc_tpu.config.schema import ServiceConfig as S
        from gsc_tpu.config.schema import ServiceFunction as F
    else:
        S, F = ServiceConfig, ServiceFunction
    sf = lambda n: F(name=n, processing_delay_mean=5.0,
                     processing_delay_stdev=0.0)
    return S(sfc_list={"sfc_1": ("a", "b", "c")},
             sf_list={n: sf(n) for n in "abc"})


def _line(jax_side=False):
    kw = dict(node_caps=[10.0] * 3,
              node_types=["Ingress", "Normal", "Normal"],
              edges=[(0, 1, 100.0, 3.0), (1, 2, 100.0, 3.0)])
    if jax_side:
        from gsc_tpu.topology.compiler import NetworkSpec as JSpec
        from gsc_tpu.topology.compiler import compile_topology as j_compile
        return j_compile(JSpec(**kw), max_nodes=N, max_edges=E)
    return compile_topology(NetworkSpec(**kw), max_nodes=N, max_edges=E)


class Pair:
    """The same engine, topology and traffic in both packages: the JAX
    side's traffic drawn with ``episode_steps`` intervals and ``seed``,
    its arrays fed to the port."""

    def __init__(self, episode_steps=2, seed=0, **cfg):
        import jax

        from gsc_tpu.config.schema import EnvLimits as JLimits
        from gsc_tpu.config.schema import SimConfig as JSim
        from gsc_tpu.sim import SimEngine as JEngine
        from gsc_tpu.sim.traffic import generate_traffic as j_traffic
        from test_torch_env import _to_port_traffic

        cfg = {"ttl_choices": (1000.0,), **cfg}
        lim = dict(max_nodes=N, max_edges=E, num_sfcs=1, max_sfs=3)
        self.jeng = JEngine(_service(True), JSim(**cfg), JLimits(**lim))
        self.eng = SimEngine(_service(), SimConfig(**cfg), EnvLimits(**lim))
        self.jtopo = _line(True)
        self.topo = _line()
        for name in ("path_delay", "next_hop", "adj_edge_id", "edge_cap",
                     "edge_delay", "node_cap", "node_mask"):
            np.testing.assert_array_equal(
                np.asarray(getattr(self.jtopo, name)),
                getattr(self.topo, name).numpy(), err_msg=name)
        self.jtraffic = j_traffic(self.jeng.cfg, self.jeng.service,
                                  self.jtopo, episode_steps, seed)
        self.traffic = _to_port_traffic(self.jtraffic)
        self.key = jax.random.PRNGKey(0)

    def init(self):
        return self.jeng.init(self.key, self.jtopo), self.eng.init(1, "cpu")


def compare(js, ts, what):
    """A JAX state (unbatched) against the port's replica 0."""
    from test_torch_env import _compare

    _compare(js.flows, ts.flows, f"{what}.flows")
    _compare(js.metrics, ts.metrics, f"{what}.metrics")
    for f in STATE_FIELDS:
        _compare(getattr(js, f), getattr(ts, f), f"{what}.{f}")


def _pending_equal(jp, tp):
    assert len(jp) == len(tp)
    for name in ("slots", "node", "sfc", "position", "sf", "dr", "ttl",
                 "egress", "node_cap", "node_remaining", "edge_cap",
                 "edge_remaining", "sf_available", "path_delay"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=name)
    assert tp.t == jp.t
    assert tp.network_stats == jp.network_stats


# ------------------------------------------------------- tests/test_perflow
def test_flows_wait_without_decision():
    """Flows park in DECIDE until the algorithm decides."""
    from gsc_tpu.sim import PerFlowController as JCtrl

    p = Pair()
    jctrl = JCtrl(p.jeng, p.jtopo, p.jtraffic)
    ctrl = PerFlowController(p.eng, p.topo, p.traffic)
    js, ts = p.init()
    js, jp = jctrl.run_until_decision(js)
    ts, tp = ctrl.run_until_decision(ts)
    _pending_equal(jp, tp)
    assert len(tp) >= 1 and (tp.node == 0).all() and (tp.position == 0).all()
    compare(js, ts, "waiting")
    js = jctrl.decide(js, jp, np.full(len(jp), -1))
    ts = ctrl.decide(ts, tp, np.full(len(tp), -1))
    compare(js, ts, "parked")
    assert int((ts.flows.phase == PH_DECIDE).sum()) >= len(tp)


def _place_on_decision_run(p, writer_j=None, writer_t=None, rounds=200):
    """Decide every pending flow towards node 1 until the first flow
    departs, both packages in lockstep; returns the port's state."""
    from gsc_tpu.sim import PerFlowController as JCtrl

    jctrl = JCtrl(p.jeng, p.jtopo, p.jtraffic, writer=writer_j)
    ctrl = PerFlowController(p.eng, p.topo, p.traffic, writer=writer_t)
    js, ts = p.init()
    js, jp = jctrl.run_until_decision(js)
    ts, tp = ctrl.run_until_decision(ts)
    js = jctrl.decide(js, jp, np.full(len(jp), 1))
    ts = ctrl.decide(ts, tp, np.full(len(tp), 1))
    compare(js, ts, "decided")
    assert bool(ts.placed[0, 1, 0])        # SF a installed at node 1
    for i in range(rounds):
        js, jp = jctrl.run_until_decision(js, max_substeps=50)
        ts, tp = ctrl.run_until_decision(ts, max_substeps=50)
        _pending_equal(jp, tp)
        compare(js, ts, f"round {i}")
        if len(tp) == 0 and int(ts.metrics.processed[0]) > 0:
            break
        if len(tp):
            js = jctrl.decide(js, jp, np.full(len(jp), 1))
            ts = ctrl.decide(ts, tp, np.full(len(tp), 1))
    return ts


def test_place_on_decision_processes_flow():
    ts = _place_on_decision_run(Pair())
    assert int(ts.metrics.processed[0]) > 0
    assert int(ts.metrics.drop_reasons.sum()) == 0


def test_flow_actions_csv_byte_equal(tmp_path):
    """flow_actions.csv of the port's writer equals the JAX writer's, byte
    for byte, on the same decisions."""
    from gsc_tpu.utils.telemetry import TestModeWriter as JWriter

    from gsc_tpu_torch.utils.telemetry import TestModeWriter

    jw = JWriter(str(tmp_path / "jax"), write_flow_actions=True)
    tw = TestModeWriter(str(tmp_path / "port"), write_flow_actions=True)
    _place_on_decision_run(Pair(), jw, tw, rounds=20)
    jw.close()
    tw.close()
    got = (tmp_path / "port" / "flow_actions.csv").read_bytes()
    want = (tmp_path / "jax" / "flow_actions.csv").read_bytes()
    assert got == want
    rows = list(csv.reader(got.decode().splitlines()))
    assert rows[0][:4] == ["episode", "time", "flow_id", "flow_rem_ttl"]
    assert len(rows) > 1 and rows[1][6] == "1"


def test_apply_per_flow_matches_jax():
    """A policy on the device drives whole intervals (``apply_per_flow``);
    the run counters of an interval stay readable after it."""
    import jax
    import jax.numpy as jnp

    from gsc_tpu.sim.state import PH_DECIDE as J_DECIDE

    p = Pair()
    chain_len = p.eng.tables.chain_len

    def j_decide(st):
        f = st.flows
        cl = jnp.asarray(chain_len)[f.sfc]
        wants = (f.phase == J_DECIDE) & (f.position < cl)
        return jnp.where(wants, 1, -1).astype(jnp.int32)

    def t_decide(st):
        f = st.flows
        cl = torch.as_tensor(chain_len)[f.sfc.long()]
        wants = (f.phase == PH_DECIDE) & (f.position < cl)
        return torch.where(wants, 1, -1).to(torch.int32)

    js, ts = p.init()
    run = jax.jit(lambda s: p.jeng.apply_per_flow(s, p.jtopo, p.jtraffic,
                                                  j_decide))
    for i in range(2):
        js, jm = run(js)
        ts, tm = p.eng.apply_per_flow(ts, p.topo, p.traffic, t_decide)
        compare(js, ts, f"interval {i}")
        assert int(tm.run_generated[0]) == 10
    assert int(tm.generated[0]) == 20
    assert int(tm.processed[0]) >= 18
    assert int(tm.drop_reasons.sum()) == 0


def test_vnf_timeout_garbage_collection():
    """Idle instances placed on decision expire after vnf_timeout, every
    substep equal to the JAX engine's."""
    import jax.numpy as jnp

    from gsc_tpu.sim.state import PH_DECIDE as J_DECIDE

    p = Pair(episode_steps=4, controller="per_flow", vnf_timeout=30.0,
             inter_arrival_mean=1000.0)
    js, ts = p.init()
    placed_trace = []
    for k in range(100):
        jdec = jnp.where(js.flows.phase == J_DECIDE, js.flows.node, -1)
        js = p.jeng.apply_substep(js, p.jtopo, p.jtraffic, jdec)
        ts = p.eng.apply_substep(ts, p.topo, p.traffic, local_decisions(ts))
        compare(js, ts, f"substep {k}")
        placed_trace.append(bool(ts.placed.any()))
    assert any(placed_trace)
    assert not ts.placed.any() and not ts.sf_available.any()
    assert placed_trace.index(True) < len(placed_trace) - 1


def _uniform(eng, topo):
    nm = topo.node_mask.numpy()
    sched = np.zeros(eng.limits.scheduling_shape, np.float32)
    sched[:, :, :, nm] = 1.0 / nm.sum()
    place = np.broadcast_to(nm[:, None], (N, 3)).copy()
    return sched, place


def _apply_both(p, intervals):
    import jax.numpy as jnp

    sched, place = _uniform(p.eng, p.topo)
    js, ts = p.init()
    for i in range(intervals):
        js, _ = p.jeng.apply(js, p.jtopo, p.jtraffic, jnp.asarray(sched),
                             jnp.asarray(place))
        ts, _ = p.eng.apply(ts, p.topo, p.traffic,
                            torch.from_numpy(sched)[None],
                            torch.from_numpy(place)[None])
        compare(js, ts, f"interval {i}")
    return ts


@pytest.mark.parametrize("controller", ["duration", "per_flow"])
def test_apply_expiry_by_controller(controller):
    """The duration controller keeps idle placed instances; under a
    per-flow config a duration-style ``apply`` expires them as the JAX
    engine does (its substep runs the expiry under that controller)."""
    p = Pair(episode_steps=4, controller=controller, vnf_timeout=30.0,
             inter_arrival_mean=1000.0)
    ts = _apply_both(p, 4)
    nm = p.topo.node_mask.numpy()
    if controller == "duration":
        assert ts.placed[0].numpy()[nm].all()


def test_truncated_arrivals_surface():
    """Slot exhaustion delays arrivals; the counter and the invariant
    check report it in both packages."""
    from gsc_tpu_torch.utils.debug import check_invariants

    p = Pair(episode_steps=1, max_flows=2, inter_arrival_mean=1.0)
    ts = _apply_both(p, 1)
    assert int(ts.truncated_arrivals[0]) > 0
    errs = check_invariants(ts, p.topo, p.eng.tables.chain_len)
    assert any("admitted late" in e for e in errs)


def test_pending_network_view():
    """The pending record carries the network view: remaining capacities,
    placement, path delays and counters, equal to the JAX record's."""
    from gsc_tpu.sim import PerFlowController as JCtrl

    p = Pair()
    js, ts = p.init()
    _, jp = JCtrl(p.jeng, p.jtopo, p.jtraffic).run_until_decision(js)
    _, tp = PerFlowController(p.eng, p.topo, p.traffic).run_until_decision(ts)
    _pending_equal(jp, tp)
    assert tp.node_remaining.shape == (N,)
    assert tp.edge_remaining.shape == (E,)
    assert tp.sf_available.shape == (N, p.eng.P)
    assert tp.path_delay.shape == (N, N)
    assert not tp.sf_available.any()
    np.testing.assert_allclose(tp.node_remaining, tp.node_cap)
    assert (tp.sf == 0).all()
    assert tp.network_stats["in_network_flows"] == len(tp)


def test_spr_algorithm_end_to_end(tmp_path):
    """ShortestPathAlgo through PerFlowController for two intervals:
    every state and the flow-action CSV equal to the JAX run's."""
    from gsc_tpu.sim import PerFlowController as JCtrl
    from gsc_tpu.sim.spr import run_spr_episode as j_run
    from gsc_tpu.utils.telemetry import TestModeWriter as JWriter

    from gsc_tpu_torch.sim.spr import run_spr_episode
    from gsc_tpu_torch.utils.telemetry import TestModeWriter

    p = Pair()
    jw = JWriter(str(tmp_path / "jax"), write_flow_actions=True)
    tw = TestModeWriter(str(tmp_path / "port"), write_flow_actions=True)
    js, ts = p.init()
    js = j_run(JCtrl(p.jeng, p.jtopo, p.jtraffic, writer=jw), js,
               2 * p.eng.substeps)
    ts = run_spr_episode(PerFlowController(p.eng, p.topo, p.traffic,
                                           writer=tw), ts, 2 * p.eng.substeps)
    jw.close()
    tw.close()
    compare(js, ts, "spr")
    assert int(ts.metrics.processed[0]) > 0
    assert int(ts.metrics.drop_reasons.sum()) == 0
    assert bool(ts.placed[0, 0, 0])
    got = (tmp_path / "port" / "flow_actions.csv").read_bytes()
    assert got == (tmp_path / "jax" / "flow_actions.csv").read_bytes()
    assert len(got.splitlines()) > 1


def test_spr_prefers_running_instance():
    """A full current node sends the flow to the nearest node running the
    SF rather than the nearest empty one, as the JAX algorithm does."""
    from gsc_tpu.sim.perflow import PendingFlows as JPending
    from gsc_tpu.sim.spr import ShortestPathAlgo as JAlgo

    from gsc_tpu_torch.sim.perflow import PendingFlows
    from gsc_tpu_torch.sim.spr import ShortestPathAlgo

    pd = np.array([[0.0, 3.0, 6.0], [3.0, 0.0, 3.0], [6.0, 3.0, 0.0]],
                  np.float32)
    avail = np.zeros((3, 1), bool)
    avail[2, 0] = True
    kw = dict(slots=np.array([0]), node=np.array([0]), sfc=np.array([0]),
              position=np.array([0]), sf=np.array([0]),
              dr=np.array([1.0], np.float32),
              ttl=np.array([100.0], np.float32), egress=np.array([-1]),
              t=0.0, node_cap=np.array([1.0, 10.0, 10.0], np.float32),
              node_remaining=np.array([0.5, 10.0, 10.0], np.float32),
              edge_cap=np.zeros(2, np.float32),
              edge_remaining=np.zeros(2, np.float32), sf_available=avail,
              path_delay=pd, network_stats={})
    for rem0, want in ((0.5, (2, 1)), (5.0, (0, 0))):
        kw["node_remaining"] = np.array([rem0, 10.0, 10.0], np.float32)
        tp, jp = PendingFlows(**kw), JPending(**kw)
        got = (ShortestPathAlgo().decide(tp)[0],
               ShortestPathAlgo(prefer_running=False).decide(tp)[0])
        assert got == want
        assert got == (JAlgo().decide(jp)[0],
                       JAlgo(prefer_running=False).decide(jp)[0])


def _cli_configs(tmp_path):
    """tests/test_perflow.py:315-362's scenario: the port's init-configs
    simulator.yaml with ``controller: per_flow``, Abilene by the port's
    writer, service_abc.yaml."""
    import yaml

    from gsc_tpu_torch import cli
    from gsc_tpu_torch.topology.synthetic import abilene, write_graphml

    cfg = tmp_path / "cfg"
    cli.init_configs(str(cfg))
    net = str(tmp_path / "abilene.graphml")
    write_graphml(abilene(), net)
    c = yaml.safe_load(open(cfg / "simulator.yaml"))
    c["controller"] = "per_flow"
    yaml.safe_dump(c, open(cfg / "sim_perflow.yaml", "w"))
    return net, str(cfg / "service_abc.yaml"), str(cfg / "simulator.yaml"), \
        str(cfg / "sim_perflow.yaml")


def test_cli_simulate_per_flow_local_and_spr(tmp_path):
    """``cli simulate --per-flow-algo local|spr`` under a per-flow config
    prints the JAX CLI's JSON (integers equal, the delay within rtol
    1e-5); the three controllers give three outcomes, each per-flow run
    processes more than it drops, and spr under the duration controller
    is refused."""
    from click.testing import CliRunner

    from gsc_tpu.cli import cli as jcli
    from gsc_tpu_torch import cli

    net, svc, sim, sim_pf = _cli_configs(tmp_path)
    r = CliRunner()

    def both(config, algo):
        argv = ["-d", "300", "-n", net, "-sf", svc, "-c", config,
                "--per-flow-algo", algo]
        res = r.invoke(jcli, ["simulate", *argv])
        assert res.exit_code == 0, res.output[-1500:]
        want = json.loads(res.output.strip().splitlines()[-1])
        got = cli.run_simulate([*argv, "--device", "cpu"])
        for k in ("total_flows", "successful_flows", "dropped_flows",
                  "drop_reasons"):
            assert got[k] == want[k], (k, got, want)
        assert got["avg_end2end_delay"] == pytest.approx(
            want["avg_end2end_delay"], rel=RTOL, abs=ATOL)
        return got

    duration = both(sim, "local")
    local = both(sim_pf, "local")
    spr = both(sim_pf, "spr")
    sig = lambda m: (m["successful_flows"], m["dropped_flows"],
                     m["avg_end2end_delay"])
    assert sig(duration) != sig(local) != sig(spr) != sig(duration)
    for m in (local, spr):
        assert m["successful_flows"] > m["dropped_flows"], m
    with pytest.raises(SystemExit):
        cli.run_simulate(["-d", "300", "-n", net, "-sf", svc, "-c", sim,
                          "--per-flow-algo", "spr", "--device", "cpu"])


def test_loader_controller_keys(tmp_path):
    """``controller: per_flow`` and ``controller_class: FlowController``
    load, a bogus value and conflicting spellings raise, and
    ``substep_impl: pallas`` with per-flow control is refused as in the
    JAX package; ``vnf_timeout`` and ``prediction`` load as there."""
    import yaml

    from gsc_tpu.config.loader import load_sim as j_load

    from gsc_tpu_torch.config.loader import load_sim

    base = {"inter_arrival_mean": 10.0, "deterministic_arrival": True,
            "flow_dr_mean": 1.0, "flow_dr_stdev": 0.0,
            "flow_size_shape": 0.001, "deterministic_size": True,
            "ttl_choices": [100], "run_duration": 100}
    path = str(tmp_path / "sim.yaml")

    def load_both(extra):
        yaml.safe_dump({**base, **extra}, open(path, "w"))
        try:
            want = j_load(path)
        except ValueError as e:
            with pytest.raises(ValueError):
                load_sim(path)
            return str(e)
        got = load_sim(path)
        for k in ("controller", "vnf_timeout", "prediction",
                  "substep_impl"):
            assert getattr(got, k) == getattr(want, k), k
        return got

    assert load_both({"controller": "per_flow"}).controller == "per_flow"
    got = load_both({"controller_class": "FlowController",
                     "controller": "per_flow", "vnf_timeout": 30,
                     "prediction": True})
    assert (got.controller, got.vnf_timeout, got.prediction) == \
        ("per_flow", 30.0, True)
    assert "unknown controller" in load_both({"controller": "bogus"})
    assert "conflicting" in load_both({"controller_class": "FlowController",
                                       "controller": "duration"})
    assert "pallas" in load_both({"controller": "per_flow",
                                  "substep_impl": "pallas"})
    with pytest.raises(ValueError, match="pallas"):
        SimConfig(controller="per_flow", substep_impl="pallas")


# ------------------------------------------------------------------ oracle
def test_local_policy_meets_perflow_oracle():
    """The port's ``apply_per_flow`` with the local policy on line3-egress
    under tests/assets/perflow_config.yaml, 2000 ms at seed 1234: the
    frozen numbers of the reference's FlowController."""
    from gsc_tpu_torch.config.catalog import abc_service
    from gsc_tpu_torch.config.loader import load_sim
    from gsc_tpu_torch.sim.traffic import generate_traffic
    from gsc_tpu_torch.topology.compiler import load_topology

    svc = abc_service()
    sim_cfg = load_sim(os.path.join(REPO, "tests", "assets",
                                    "perflow_config.yaml"))
    assert sim_cfg.controller == "per_flow"
    limits = EnvLimits.for_service(svc, max_nodes=8, max_edges=8)
    topo = load_topology(os.path.join(REPO, "tests", "assets",
                                      "line3-egress.graphml"),
                         max_nodes=8, max_edges=8)
    steps = 2000 // int(sim_cfg.run_duration)
    traffic = generate_traffic(sim_cfg, svc, topo, steps, 1234)
    engine = SimEngine(svc, sim_cfg, limits)
    state = engine.init(1, "cpu")
    for _ in range(steps):
        state, m = engine.apply_per_flow(state, topo, traffic,
                                         local_decisions)
    assert abs(int(m.generated[0]) - ORACLE["generated"]) <= 2
    assert int(m.processed[0]) == ORACLE["processed"]
    assert int(m.dropped[0]) == ORACLE["dropped"]
    assert float(m.avg_e2e()[0]) == pytest.approx(ORACLE["avg_e2e"],
                                                  rel=1e-6)


# ---------------------------------------------------------------- wrapper
def test_wrapper_refuses_what_per_flow_mode_does_not_take():
    """The kernel's wrapper raises on CPU tensors (no fallback), on
    decisions of the wrong shape or dtype and on external decisions over
    more than one substep; the CPU dispatch runs the plain version."""
    case = cases.perflow_random_case(batch=2)
    eng = case.engine
    st = eng.init(case.batch, "cpu")
    topo = case.topo.expand(case.batch)
    traffic = case.traffic.expand(case.batch)
    cap = traffic.node_cap[:, 0]
    dec = torch.full((case.batch, eng.M), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        substep_megakernel.launch(eng, st, topo, traffic, cap,
                                  ext_decisions=dec)
    ctr = torch.zeros(1, dtype=torch.int64)
    for bad in (dec[:, :-1], dec.long()):
        with pytest.raises(ValueError, match="ext_decisions"):
            substep_megakernel._prepare(eng, st, topo, traffic, cap, None,
                                        None, ctr, None, bad)
    with pytest.raises(ValueError, match="one substep"):
        substep_megakernel._prepare(eng, st, topo, traffic, cap, None, 2,
                                    ctr, None, dec)
    before = substep_megakernel.perflow_launches
    got = substep_megakernel(eng, st, topo, traffic, cap, None, 1, dec)
    want = substep_plain(eng, st, topo, traffic, cap, None, 1, dec)
    assert cases.bit_equal(got, want)
    assert substep_megakernel.perflow_launches == before


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU "
                    "mode; its plain version is tested on the CPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["local_line3", "random_abilene"])
def test_perflow_kernel_bit_equal_to_plain(name):
    dev = _card()
    case = {"local_line3": lambda: cases.perflow_local_case(intervals=3),
            "random_abilene": lambda: cases.perflow_random_case(
                batch=16, substeps=150)}[name]()
    got = cases.run_perflow_case(case, dev)
    want = cases.run_perflow_case(case, "cpu", plain=True)
    for i, (g, w) in enumerate(zip(got, want)):
        assert cases.bit_equal(g.to("cpu"), w), f"{name} step {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 64])
def test_chained_launches_equal_one_interval(batch):
    dev = _card()
    case = cases.abilene_case(batch=batch, intervals=2, seed=3)
    one, chained = cases.chained_launches(case, dev)
    assert cases.bit_equal(one, chained)
