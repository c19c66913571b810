"""The port's native traffic sampler (``gsc_tpu_torch.native``) and
``sim.traffic.generate_traffic`` against the JAX package's, on its
native path (both packages' default) and on its numpy path
(``GSC_TPU_NO_NATIVE=1`` in both).

Why byte-equality is the bar for the native path: both packages build the
same ``traffic_gen.cpp`` with the same ``g++ -O2 -shared -fPIC`` of this
machine.  ``std::mt19937_64`` is fixed by the C++ standard, and the
``std::`` distributions (normal, exponential, uniform real) are each one
algorithm of the standard library, not of the optimiser, so one
toolchain draws the same numbers in both libraries; the arithmetic after
the draws (durations, the float32 padding) is the same IEEE operations.
So every field of every schedule must have the same bytes.

- native against native: deterministic configs (the init-configs
  values), exponential arrivals, Pareto sizes, noisy data rates, several
  TTLs, SFCs and egress nodes, MMPP means (fixed and random start),
  trace-driven means with an ingress switched off and back on, a
  capacity that cuts the flows, and link faults (the edge table);
- numpy against numpy, with the switch set in both: the same bytes, and
  other bytes than the native path where rates are random (the switch
  really changes the path);
- no silent fallback: with g++ missing from ``PATH``, or a source that
  does not compile, ``generate_traffic`` raises ``NativeBuildError``
  carrying the compiler's message; the build and the load each report a
  ``compile`` event to the compile monitor.

Tolerance: none, every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest

import gsc_tpu.native as j_native
from gsc_tpu.config.catalog import abc_service as j_abc
from gsc_tpu.config.catalog import mixed_service as j_mixed
from gsc_tpu.config.schema import MMPPState as JMMPP
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.sim.traffic import TraceEvents as JTrace
from gsc_tpu.sim.traffic import generate_traffic as j_traffic
from gsc_tpu.topology import synthetic as jsyn
from gsc_tpu.topology.compiler import NetworkSpec as JSpec
from gsc_tpu.topology.compiler import compile_topology as j_compile
from gsc_tpu.topology.scenarios import parse_topo_faults as j_faults

import gsc_tpu_torch.native as native
from gsc_tpu_torch.analysis import CompileMonitor
from gsc_tpu_torch.config import abc_service, mixed_service
from gsc_tpu_torch.config.schema import MMPPState, SimConfig
from gsc_tpu_torch.sim.state import TrafficSchedule
from gsc_tpu_torch.sim.traffic import TraceEvents, generate_traffic
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import NetworkSpec, compile_topology
from gsc_tpu_torch.topology.scenarios import parse_topo_faults
from torch_port_helpers import numpy_traffic_path
from torch_port_helpers import one_torch_thread  # noqa: F401

STATES = (("s0", 5.0, 0.5), ("s1", 40.0, 0.3))
RANDOM = dict(deterministic_arrival=False, deterministic_size=False,
              flow_size_shape=2.0, flow_dr_stdev=0.3,
              ttl_choices=(50.0, 80.0, 100.0))
# init-configs' simulator.yaml values
DETERMINISTIC = dict(inter_arrival_mean=10.0, flow_dr_stdev=0.0,
                     flow_size_shape=0.001, ttl_choices=(100.0,))


def _spec_line5(mod):
    """Two ingresses, two egresses: every choice the sampler makes has
    more than one option."""
    return mod(node_caps=[10.0] * 5,
               node_types=["Ingress", "Ingress", "Normal", "Egress",
                           "Egress"],
               edges=[(i, i + 1, 100.0, 1.0) for i in range(4)])


# name -> (network, service, sim kwargs, steps, extra generate kwargs)
CASES = {
    "deterministic_abilene": ("abilene", "abc", DETERMINISTIC, 20, {}),
    "exponential_arrivals": ("line5", "abc",
                             dict(deterministic_arrival=False,
                                  ttl_choices=(100.0,)), 12, {}),
    "pareto_sizes": ("line5", "abc",
                     dict(deterministic_size=False, flow_size_shape=1.5,
                          ttl_choices=(100.0,)), 12, {}),
    "noisy_rates": ("line5", "abc",
                    dict(flow_dr_stdev=0.5, ttl_choices=(100.0,)), 12, {}),
    "random_mixed_chains": ("line5", "mixed", RANDOM, 12, {}),
    "random_abilene": ("abilene", "abc", RANDOM, 30, {}),
    "mmpp_fixed_start": ("line5", "abc",
                         dict(RANDOM, use_states=True, init_state="s0",
                              states=STATES), 20, {}),
    "mmpp_random_start": ("line5", "mixed",
                          dict(RANDOM, use_states=True, init_state="s1",
                               rand_init_state=True, states=STATES), 20, {}),
    "trace_off_and_back": ("line5", "abc", RANDOM, 8, dict(trace=[
        (200.0, 0, None, None), (500.0, 0, 4.0, None),
        (300.0, 1, 20.0, 99.0)])),
    "capacity_cut": ("line5", "abc", RANDOM, 12, dict(capacity=64)),
    "link_faults": ("abilene", "abc", RANDOM, 10,
                    dict(faults="link@0.3&node@0.6")),
}


def _pair(name):
    net, svc, kw, steps, extra = CASES[name]
    kw = dict(kw)
    states = kw.pop("states", ())
    jcfg = JSim(**kw, states=tuple(JMMPP(*s) for s in states))
    tcfg = SimConfig(**kw, states=tuple(MMPPState(*s) for s in states))
    if net == "line5":
        jt = j_compile(_spec_line5(JSpec), max_nodes=8, max_edges=8)
        tt = compile_topology(_spec_line5(NetworkSpec), max_nodes=8,
                              max_edges=8)
    else:
        jt, tt = j_compile(jsyn.abilene()), compile_topology(
            synthetic.abilene())
    jsvc, tsvc = ((j_abc(), abc_service()) if svc == "abc"
                  else (j_mixed(), mixed_service()))
    jx, tx = {}, {}
    if "trace" in extra:
        jx["trace"] = JTrace(extra["trace"])
        tx["trace"] = TraceEvents(extra["trace"])
    if "capacity" in extra:
        jx["capacity"] = tx["capacity"] = extra["capacity"]
    if "faults" in extra:
        jx["faults"] = j_faults(extra["faults"])
        tx["faults"] = parse_topo_faults(extra["faults"])
    return ((lambda seed: j_traffic(jcfg, jsvc, jt, steps, seed, **jx)),
            (lambda seed: generate_traffic(tcfg, tsvc, tt, steps, seed,
                                           **tx)))


def _fields(ts):
    out = {f: getattr(ts, f) for f in TrafficSchedule._RANKS}
    out["edge_cap_t"] = getattr(ts, "edge_cap_t", None)
    return out


def _assert_byte_equal(js, ts):
    jf, tf = _fields(js), _fields(ts)
    assert (jf["edge_cap_t"] is None) == (tf["edge_cap_t"] is None)
    for name, t in tf.items():
        if t is None:
            continue
        a, b = np.asarray(jf[name]), t.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), f"{name} differs"


def _flows(ts):
    return int(np.isfinite(ts.arr_time.numpy()).sum())


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_path_byte_equal_to_jax(name, monkeypatch):
    monkeypatch.delenv(native.SWITCH, raising=False)
    assert j_native.get_lib() is not None, "the JAX package's g++ build"
    j_gen, t_gen = _pair(name)
    for seed in (0, 7):
        ts = t_gen(seed)
        _assert_byte_equal(j_gen(seed), ts)
        assert _flows(ts) > 10
    if name == "capacity_cut":
        assert _flows(ts) == 64


@pytest.mark.parametrize("name", ["random_mixed_chains", "mmpp_random_start",
                                  "trace_off_and_back"])
def test_numpy_switch_byte_equal_to_jax_numpy_path(name, monkeypatch):
    monkeypatch.delenv(native.SWITCH, raising=False)
    j_gen, t_gen = _pair(name)
    on_native = t_gen(3)
    numpy_traffic_path(monkeypatch)
    ts = t_gen(3)
    _assert_byte_equal(j_gen(3), ts)
    assert ts.arr_time.numpy().tobytes() != \
        on_native.arr_time.numpy().tobytes()


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The sampler unloaded and its build directory empty (a new one)."""
    monkeypatch.delenv(native.SWITCH, raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path


def test_a_missing_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setenv("PATH", str(fresh_build))
    _, t_gen = _pair("random_abilene")
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ not found"):
        t_gen(0)
    assert native._lib is None
    # the switch, and only the switch, picks the numpy path
    monkeypatch.setenv(native.SWITCH, "1")
    assert _flows(t_gen(0)) > 10


def test_a_failed_build_raises_with_the_compilers_message(fresh_build,
                                                          monkeypatch):
    bad = fresh_build / "traffic_gen.cpp"
    bad.write_text('extern "C" int gsc_generate_flows( { nope }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    _, t_gen = _pair("deterministic_abilene")
    with pytest.raises(native.NativeBuildError) as err:
        t_gen(0)
    assert "g++ failed" in str(err.value) and "error" in str(err.value)
    assert not list((fresh_build / "_build").glob("*.so"))


def test_build_and_load_report_compile_events(fresh_build):
    with CompileMonitor(watch=["traffic_gen"]) as mon:
        lib = native.load_library()
        assert native.load_library() is lib
    so = native.library_path()
    assert so.parent == fresh_build / "_build" and so.exists()
    assert mon.snapshot() == {so.stem: (1, 1)}
    assert [e["stage"] for e in mon.events] == ["build", "load"]
    # a second process (here: a cleared cache) loads the file it finds
    native._lib = None
    with CompileMonitor(watch=["traffic_gen"]) as again:
        native.load_library()
    assert again.snapshot() == {so.stem: (0, 1)}
