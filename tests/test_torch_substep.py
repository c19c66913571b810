"""The port's engine (whose intervals run through the megakernel's
wrapper) against the JAX package's engine with ``substep_impl="pallas"``.

On the CPU the port's megakernel wrapper runs its plain version (the
engine's plain substep) and the JAX package inlines the Pallas kernel's
body ``_substep_body`` (gsc_tpu/ops/pallas_substep.py:555-578), which is
how its own tests run it there.  The cases are the port's
(``gsc_tpu_torch.sim.cases``): the six scenarios of
tests/test_megakernel.py, the WRR-collision triangle, the saturated-link
line (built in code; here also checked against the JAX package's GraphML
asset and yaml), fractional data rates; and the seeded Abilene golden
trajectory, whose frozen numbers are copied below.  The JAX side's traffic
and processing-delay noise go into both engines.

Tolerances: integer and boolean state exact.  Float state rtol 1e-5, atol
1e-5: f32, where the port's scatter-adds and cumulative sums add in
another order (and the CPU cumsum accumulates in double) than XLA's
one-hot contractions and cumsum; on integer-valued data the two agree
exactly.  The golden average end-to-end delay within 0.1 of 34.75, the
tolerance of tests/test_debug_and_golden.py.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsc_tpu.config.loader import load_sim as j_load_sim
from gsc_tpu.config.schema import EnvLimits as JLimits
from gsc_tpu.config.schema import ServiceConfig as JService
from gsc_tpu.config.schema import ServiceFunction as JSF
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.sim import SimEngine as JEngine
from gsc_tpu.sim.traffic import generate_traffic as j_traffic
from gsc_tpu.topology.compiler import load_topology as j_load_topology

from gsc_tpu_torch.config.schema import SimConfig
from gsc_tpu_torch.ops.substep import SubstepMegakernel, substep_megakernel
from gsc_tpu_torch.sim import cases
from gsc_tpu_torch.sim.state import TrafficSchedule
from test_torch_env import _compare, _noise_stream, _to_port_traffic
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_debug_and_golden.py::test_golden_trajectory_abilene
GOLDEN = {"generated": 800, "processed": 658, "dropped": 133, "active": 9,
          "drop_reasons": [0, 0, 0, 133], "avg_e2e": 34.75}


def _jax_side(case):
    """The JAX engine, limits and topology matching a port case."""
    eng = case.engine
    svc = eng.service
    jsvc = JService(sfc_list=dict(svc.sfc_list), sf_list={
        k: JSF(**dataclasses.asdict(v)) for k, v in svc.sf_list.items()})
    kw = {f.name: getattr(eng.cfg, f.name)
          for f in dataclasses.fields(SimConfig)}
    jcfg = JSim(**{**kw, "substep_impl": "pallas"})
    jlim = JLimits(**dataclasses.asdict(eng.limits))
    return JEngine(jsvc, jcfg, jlim), jsvc, jcfg


def _jax_topology(case):
    """The case's topology as the JAX package's pytree (same arrays)."""
    from gsc_tpu.topology.compiler import Topology as JTopo
    return JTopo(**{f.name: jnp.asarray(getattr(case.topo, f.name).numpy())
                    for f in dataclasses.fields(JTopo)})


def _replica(tree, r):
    """Replica ``r`` of a port state tree, keeping a batch dim of 1."""
    return dataclasses.replace(tree, **{
        f.name: (_replica(v, r) if dataclasses.is_dataclass(v)
                 else v[r:r + 1] if isinstance(v, torch.Tensor) else v)
        for f in dataclasses.fields(tree)
        for v in [getattr(tree, f.name)]})


def _run_both(case, jtopo=None, jcfg_override=None):
    """Every replica of the case through the JAX engine (one at a time, on
    its own traffic seed, schedule and placement) and the whole batch
    through the port's engine; every state compared after each interval.
    Returns the port's final state."""
    jeng, jsvc, jcfg = _jax_side(case)
    if jcfg_override is not None:
        jcfg = jcfg_override
        jeng = JEngine(jsvc, jcfg, jeng.limits)
    assert jcfg.substep_impl == "pallas"
    jtopo = jtopo if jtopo is not None else _jax_topology(case)
    steps = int(case.traffic.node_cap.shape[1])
    jtraf = [j_traffic(jcfg, jsvc, jtopo, steps, seed=s) for s in case.seeds]
    ttraf = [_to_port_traffic(j) for j in jtraf]
    if jcfg.flow_dr_stdev == 0.0:
        # the port's own traffic of this case is byte-equal to the JAX
        # one (with random data rates the JAX package's native sampler
        # draws in another order than the numpy path the port copies)
        for r, t in enumerate(ttraf):
            for f in dataclasses.fields(t):
                np.testing.assert_array_equal(
                    getattr(case.traffic, f.name)[r].numpy(),
                    getattr(t, f.name).numpy(), err_msg=f.name)
    ttraf = TrafficSchedule(**{
        f: torch.stack([getattr(t, f) for t in ttraf])
        for f in TrafficSchedule._RANKS})
    key = jax.random.PRNGKey(0)
    jstates = [jeng.init(key, jtopo) for _ in case.seeds]
    tstate = case.engine.init(case.batch, "cpu")
    k_n = case.engine.substeps
    z = (None if case.engine.det_proc
         else _noise_stream(key, case.intervals * k_n, case.engine.M))
    for i in range(case.intervals):
        noise = (None if z is None else
                 torch.from_numpy(z[i * k_n:(i + 1) * k_n].copy())[None]
                 .expand(case.batch, -1, -1))
        tstate, _ = case.engine.apply(tstate, case.topo, ttraf,
                                      case.schedule, case.placement, noise)
        for r in range(case.batch):
            jstates[r], _ = jeng.apply(
                jstates[r], jtopo, jtraf[r],
                jnp.asarray(case.schedule[r].numpy()),
                jnp.asarray(case.placement[r].numpy()))
            js, ts = jstates[r], _replica(tstate, r)
            what = f"{case.name}.{i}.replica{r}"
            _compare(js.flows, ts.flows, f"{what}.flows")
            _compare(js.metrics, ts.metrics, f"{what}.metrics")
            for f in ("t", "cursor", "node_load", "sf_available",
                      "edge_used", "sf_last_active", "rel_node", "rel_edge",
                      "truncated_arrivals"):
                _compare(getattr(js, f), getattr(ts, f), f"{what}.{f}")
    return tstate


@pytest.mark.parametrize("name", sorted(cases._BATTERY))
def test_megakernel_scenarios_match_jax(name):
    case = cases.battery_case(name)
    tstate = _run_both(case)
    if name != "stochastic_startup":
        assert int(tstate.metrics.dropped[0]) > 0


def test_megakernel_wrr_collisions_match_jax():
    tstate = _run_both(cases.wrr_case())
    counts = tstate.metrics.run_flow_counts[0, 0, 0, 0].numpy()
    assert counts[1] == counts[2] > 0


def test_megakernel_saturated_link_matches_jax_asset():
    """The in-code saturated line equals the JAX package's GraphML asset
    and yaml, and the engines agree on it."""
    case = cases.linkcap_case()
    jcfg = dataclasses.replace(
        j_load_sim(os.path.join(REPO, "tests", "assets",
                                "linkcap_config.yaml")),
        substep_impl="pallas")
    jtopo = j_load_topology(os.path.join(REPO, "tests", "assets",
                                         "line3-linkcap2.graphml"),
                            max_nodes=8, max_edges=8)
    for f in ("node_cap", "edge_cap", "edge_delay", "adj_edge_id",
              "next_hop", "path_delay", "is_ingress", "is_egress"):
        np.testing.assert_array_equal(np.asarray(getattr(jtopo, f)),
                                      getattr(case.topo, f).numpy(),
                                      err_msg=f)
    tstate = _run_both(case, jtopo=jtopo, jcfg_override=jcfg)
    assert int(tstate.metrics.drop_reasons[0, 2]) > 0


def test_megakernel_fractional_rates_match_jax():
    case = cases.fractional_case(batch=1)
    tstate = _run_both(case)
    assert not np.allclose(case.traffic.arr_dr.numpy() % 1.0, 0.0)
    assert int(tstate.metrics.dropped[0]) > 0


def test_megakernel_golden_trajectory():
    """The seeded Abilene golden run through the megakernel's path (its
    plain version on the CPU) agrees with the JAX engine after every
    interval and gives the reference's frozen numbers."""
    tstate = _run_both(cases.golden_case())
    got = cases.check_golden(tstate)
    assert got["generated"] == GOLDEN["generated"]
    assert got["processed"] == GOLDEN["processed"]
    assert got["dropped"] == GOLDEN["dropped"]
    assert got["active"] == GOLDEN["active"]
    assert got["drop_reasons"] == GOLDEN["drop_reasons"]
    assert got["avg_e2e"] == pytest.approx(GOLDEN["avg_e2e"], abs=0.1)


def test_megakernel_abilene_nonuniform_matches_jax():
    """Abilene at the flagship widths (24 nodes, 37 edges, 128 flow slots)
    with two replicas, each on its own traffic seed, seeded non-uniform
    schedule and placement."""
    case = cases.abilene_case(batch=2, intervals=3, seed=0)
    tstate = _run_both(case)
    assert int(tstate.metrics.generated.min()) > 0
    assert not torch.equal(case.schedule[0], case.schedule[1])


def test_megakernel_abilene_200_slots_matches_jax():
    """Abilene under heavy traffic (an arrival every 1 ms per ingress) at
    200 flow slots, the battery case whose last warp the kernel fills only
    partly; more flows are in flight than two warps hold."""
    case = cases.abilene_case(batch=1, intervals=2, max_flows=200,
                              inter_arrival_mean=1.0)
    tstate = _run_both(case)
    assert int(tstate.metrics.active[0]) > 64
    assert int(tstate.metrics.dropped[0]) > 0


def test_pallas_with_per_flow_control_is_refused():
    with pytest.raises(ValueError, match="supports only controller"):
        SimConfig(substep_impl="pallas", controller="per_flow")
    with pytest.raises(ValueError, match="substep_impl"):
        SimConfig(substep_impl="mosaic")


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    case = cases.battery_case("link_cap")
    before = substep_megakernel.launches
    pallas = cases.run_case(case, "cpu")
    plain = cases.run_case(case, "cpu", plain=True)
    assert substep_megakernel.launches == before
    for a, b in zip(pallas, plain):
        assert cases.bit_equal(a, b)
    op = SubstepMegakernel()
    with pytest.raises(ValueError, match="CUDA"):
        op.launch(case.engine, case.engine.init(1, "cpu"), case.topo,
                  case.traffic, torch.zeros(1, 8))
    assert op.launches == 0
