"""The port's MMPP and trace traffic against the JAX package's host
generator, mirroring tests/test_traffic.py:44-86: the same configs and
seeds give byte-equal schedules, on the native sampler (both packages'
default) and on the numpy path (``GSC_TPU_NO_NATIVE=1`` in both).  With
deterministic arrivals and sizes both paths give the same bytes; with
random ones they draw in different orders, so each is compared with its
own counterpart (tests/test_torch_native_traffic.py has the native
stochastic cases).  Tolerance: none — every comparison is exact."""
import dataclasses

import numpy as np
import pytest

from gsc_tpu.config.schema import MMPPState as JMMPP
from gsc_tpu.config.schema import ServiceConfig as JService
from gsc_tpu.config.schema import ServiceFunction as JSF
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.sim.traffic import TraceEvents as JTrace
from gsc_tpu.sim.traffic import generate_traffic as j_traffic
from gsc_tpu.topology.compiler import NetworkSpec as JSpec
from gsc_tpu.topology.compiler import compile_topology as j_compile

from gsc_tpu_torch.config.loader import load_sim
from gsc_tpu_torch.config.schema import (MMPPState, ServiceConfig,
                                         ServiceFunction, SimConfig)
from gsc_tpu_torch.sim.state import TrafficSchedule
from gsc_tpu_torch.sim.traffic import TraceEvents, generate_traffic
from gsc_tpu_torch.topology.compiler import NetworkSpec, compile_topology
from torch_port_helpers import numpy_traffic_path
from torch_port_helpers import one_torch_thread  # noqa: F401

N, E = 8, 8
STATES = (("s0", 5.0, 0.5), ("s1", 50.0, 0.5))


def _services():
    return (JService(sfc_list={"sfc_1": ("a", "b")},
                     sf_list={n: JSF(name=n) for n in "ab"}),
            ServiceConfig(sfc_list={"sfc_1": ("a", "b")},
                          sf_list={n: ServiceFunction(name=n) for n in "ab"}))


def _topos(n_ingress=2, egress=False):
    types = (["Ingress"] * n_ingress + ["Normal"] * (3 - n_ingress))
    if egress:
        types[-1] = "Egress"
    kw = dict(node_caps=[10.0] * 3, node_types=types,
              edges=[(0, 1, 100.0, 1.0), (1, 2, 100.0, 1.0)])
    return (j_compile(JSpec(**kw), max_nodes=N, max_edges=E),
            compile_topology(NetworkSpec(**kw), max_nodes=N, max_edges=E))


def _cfgs(**kw):
    states = kw.pop("states", ())
    return (JSim(**kw, states=tuple(JMMPP(*s) for s in states)),
            SimConfig(**kw, states=tuple(MMPPState(*s) for s in states)))


def _assert_byte_equal(js, ts):
    for f in dataclasses.fields(TrafficSchedule):
        a = np.asarray(getattr(js, f.name))
        b = getattr(ts, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert a.tobytes() == b.tobytes(), f"{f.name} differs"


MMPP_CASES = {
    "fixed_start": dict(ttl_choices=(100.0,), use_states=True,
                        init_state="s0", states=STATES),
    "random_start": dict(ttl_choices=(100.0,), use_states=True,
                         init_state="s0", rand_init_state=True,
                         states=STATES),
}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", sorted(MMPP_CASES))
def test_mmpp_traffic_byte_equal(name, native, monkeypatch):
    """The two-state chain's per-interval means (tests/test_traffic.py:
    44-60), deterministic arrivals: byte-equal over 40 intervals, with
    both dense and sparse intervals."""
    if not native:
        numpy_traffic_path(monkeypatch)
    jcfg, tcfg = _cfgs(**MMPP_CASES[name])
    jsvc, tsvc = _services()
    jt, tt = _topos(2)
    js = j_traffic(jcfg, jsvc, jt, 40, seed=3)
    ts = generate_traffic(tcfg, tsvc, tt, 40, seed=3)
    _assert_byte_equal(js, ts)
    times = ts.arr_time.numpy()
    counts = np.histogram(times[np.isfinite(times)], bins=40,
                          range=(0, 4000))[0]
    assert counts.max() >= 15 and counts.min() <= 6


def test_mmpp_poisson_traffic_byte_equal_numpy_path(monkeypatch):
    """MMPP under Poisson arrivals, Pareto sizes and noisy rates, on both
    packages' numpy path: the chain and the flows draw from one generator
    in the same order."""
    numpy_traffic_path(monkeypatch)
    jcfg, tcfg = _cfgs(ttl_choices=(50.0, 100.0), use_states=True,
                       init_state="s1", rand_init_state=True,
                       states=STATES, deterministic_arrival=False,
                       deterministic_size=False, flow_size_shape=2.0,
                       flow_dr_stdev=0.3)
    jsvc, tsvc = _services()
    jt, tt = _topos(2, egress=True)
    _assert_byte_equal(j_traffic(jcfg, jsvc, jt, 12, seed=9),
                       generate_traffic(tcfg, tsvc, tt, 12, seed=9))


TRACE_ROWS = {
    # tests/test_traffic.py:63: ingress 0 off at t=200, ingress 1 denser
    # with a raised cap from t=300
    "off_and_cap": [(200.0, 0, None, None), (300.0, 1, 5.0, 99.0)],
    # off, then back at another mean (tests/test_traffic_device.py:103)
    "reactivate": [(200.0, 0, None, None), (400.0, 0, 10.0, 5000.0)],
    # a row for a node that is no ingress only raises its cap
    "normal_node_cap": [(100.0, 2, 3.0, 42.0), (250.0, 1, 20.0, None)],
}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", sorted(TRACE_ROWS))
def test_trace_traffic_byte_equal(name, native, monkeypatch):
    """Trace rows deactivate, reactivate and re-mean ingresses and raise
    node capacities from their interval on: byte-equal schedules."""
    if not native:
        numpy_traffic_path(monkeypatch)
    jcfg, tcfg = _cfgs(ttl_choices=(100.0,))
    jsvc, tsvc = _services()
    jt, tt = _topos(2)
    rows = TRACE_ROWS[name]
    js = j_traffic(jcfg, jsvc, jt, 6, seed=0, trace=JTrace(rows))
    ts = generate_traffic(tcfg, tsvc, tt, 6, seed=0, trace=TraceEvents(rows))
    _assert_byte_equal(js, ts)


def test_trace_semantics_of_the_port():
    """tests/test_traffic.py:63-86 on the port alone: no arrivals from
    node 0 after its deactivation, node 1 twice as dense after its row,
    the activity and cap tables follow the rows."""
    _, tcfg = _cfgs(ttl_choices=(100.0,))
    _, tsvc = _services()
    _, tt = _topos(2)
    tr = generate_traffic(tcfg, tsvc, tt, 5, seed=0,
                          trace=TraceEvents(TRACE_ROWS["off_and_cap"]))
    times, ing = tr.arr_time.numpy(), tr.arr_ingress.numpy()
    fin = np.isfinite(times)
    assert not ((ing == 0) & fin & (times >= 200.0)).any()
    assert ((ing == 0) & fin & (times < 200.0)).any()
    before = ((ing == 1) & fin & (times >= 100) & (times < 200)).sum()
    after = ((ing == 1) & fin & (times >= 300) & (times < 400)).sum()
    assert after >= 2 * before - 1
    active, caps = tr.ingress_active.numpy(), tr.node_cap.numpy()
    assert active[1, 0] and not active[2, 0]
    assert caps[2, 1] == 10.0 and caps[3, 1] == 99.0


def test_trace_csv_and_yaml_load_as_in_jax(tmp_path):
    """A trace CSV (the reference's 'popN' node names, 'None' means and an
    empty cap) parses to the JAX package's rows, and a simulator yaml with
    MMPP states and a trace_path loads to the same values; so does
    'prediction'."""
    from gsc_tpu.config.loader import load_sim as j_load_sim
    from gsc_tpu.env.driver import _node_index as j_node_index

    from gsc_tpu_torch.env.driver import _node_index

    csv_path = tmp_path / "trace.csv"
    csv_path.write_text("time,node,inter_arrival_mean,cap\n"
                        "0,pop0,12.5,\n200,pop1,None,\n350,2,4.0,77\n")
    want = JTrace.from_csv(str(csv_path), j_node_index).rows
    assert TraceEvents.from_csv(str(csv_path), _node_index).rows == want
    yml = tmp_path / "sim.yaml"
    yml.write_text(
        "inter_arrival_mean: 10.0\ndeterministic_arrival: true\n"
        "deterministic_size: true\nflow_dr_mean: 1.0\nflow_dr_stdev: 0.0\n"
        "flow_size_shape: 0.001\nrun_duration: 100\nttl_choices: [100]\n"
        "use_states: true\ninit_state: state_1\nrand_init_state: false\n"
        "states:\n  state_1: {inter_arr_mean: 10.0, switch_p: 0.1}\n"
        "  state_2: {inter_arr_mean: 2.0, switch_p: 0.3}\n"
        f"trace_path: {csv_path}\n")
    jcfg, tcfg = j_load_sim(str(yml)), load_sim(str(yml))
    for f in ("use_states", "init_state", "rand_init_state", "trace_path",
              "inter_arrival_mean"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert [dataclasses.astuple(s) for s in tcfg.states] == \
        [dataclasses.astuple(s) for s in jcfg.states]
    (tmp_path / "pred.yaml").write_text(yml.read_text()
                                        + "prediction: true\n")
    assert load_sim(str(tmp_path / "pred.yaml")).prediction \
        == j_load_sim(str(tmp_path / "pred.yaml")).prediction is True
    assert tcfg.prediction == jcfg.prediction is False
