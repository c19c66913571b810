"""The port's on-device traffic sampler (``DeviceTraffic``), run here on
the CPU, mirroring tests/test_traffic_device.py:16-138: bit-equal to the
host generator on deterministic configs (every draw degenerate, so the
random streams' difference cannot show), held by distribution on random
ones (torch's generator and JAX's threefry differ), MMPP density, trace
deactivation and capacity rows, the engine consuming a sampled schedule.
Two further checks hold the sampler against the JAX package's
``DeviceTraffic`` on deterministic configs, and the per-interval clock
steps (``renewal_stream``) on a block too short for an interval.

Tolerances: exact where stated bit-equal; the Poisson checks allow the
spread of 8 draws of Poisson(200) (mean count within 25, mean gap within
1.5 ms of 10), the Pareto(2) mean of ~100 sizes in (1.3, 3.5)."""

import jax
import numpy as np
import pytest
import torch

from gsc_tpu.config.schema import ServiceConfig as JService
from gsc_tpu.config.schema import ServiceFunction as JSF
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.sim.traffic import TraceEvents as JTrace
from gsc_tpu.sim.traffic_device import DeviceTraffic as JDeviceTraffic
from gsc_tpu.topology.compiler import NetworkSpec as JSpec
from gsc_tpu.topology.compiler import compile_topology as j_compile

from gsc_tpu_torch.config.schema import (EnvLimits, MMPPState, ServiceConfig,
                                         ServiceFunction, SimConfig)
from gsc_tpu_torch.sim.engine import SimEngine
from gsc_tpu_torch.sim.traffic import TraceEvents, generate_traffic
from gsc_tpu_torch.sim.traffic_device import DeviceTraffic
from gsc_tpu_torch.topology.compiler import NetworkSpec, compile_topology
from torch_port_helpers import one_torch_thread  # noqa: F401

N, E = 8, 8
FIELDS = ("arr_time", "arr_ingress", "arr_dr", "arr_duration", "arr_ttl",
          "arr_sfc", "arr_egress", "ingress_active", "node_cap")
MMPP = dict(ttl_choices=(100.0,), deterministic_arrival=True,
            use_states=True, init_state="s0", rand_init_state=False,
            states=(MMPPState("s0", 5.0, 0.5), MMPPState("s1", 50.0, 0.5)))


def service():
    return ServiceConfig(sfc_list={"sfc_1": ("a", "b")},
                         sf_list={n: ServiceFunction(name=n) for n in "ab"})


def _spec(n_ingress=2, egress=False):
    types = ["Ingress"] * n_ingress + ["Normal"] * (3 - n_ingress)
    if egress:
        types[-1] = "Egress"
    return dict(node_caps=[10.0] * 3, node_types=types,
                edges=[(0, 1, 100.0, 1.0), (1, 2, 100.0, 1.0)])


def topo(n_ingress=2, egress=False):
    return compile_topology(NetworkSpec(**_spec(n_ingress, egress)),
                            max_nodes=N, max_edges=E)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def _finite(t):
    t = t.numpy()
    return t[np.isfinite(t)]


DETERMINISTIC = {
    "two_ingress": (dict(ttl_choices=(100.0,), inter_arrival_mean=10.0),
                    2, False, None, 5),
    "non_dyadic_mean": (dict(ttl_choices=(100.0,), inter_arrival_mean=7.0,
                             run_duration=50.0), 2, True, None, 6),
    "trace_off_on_cap": (dict(ttl_choices=(100.0,), inter_arrival_mean=10.0),
                         1, False, [(200.0, 0, None, None),
                                    (400.0, 0, 10.0, 5000.0)], 6),
    "trace_re_mean": (dict(ttl_choices=(100.0,), inter_arrival_mean=10.0),
                      2, False, [(150.0, 1, 3.0, None),
                                 (300.0, 0, 25.0, 12.0)], 5),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_bitwise_matches_host(name):
    """Deterministic arrivals, sizes and rates: the sampler reproduces
    the host schedule bit for bit, traces included."""
    kw, n_ing, egress, rows, steps = DETERMINISTIC[name]
    cfg = SimConfig(**kw)
    tp = topo(n_ing, egress)
    trace = TraceEvents(rows) if rows else None
    host = generate_traffic(cfg, service(), tp, steps, seed=0, trace=trace)
    dev = DeviceTraffic(cfg, service(), tp, steps, trace=trace)
    got = dev.sample(gen(0))
    if egress:   # the one egress node is every flow's
        real = int(torch.isfinite(got.arr_time).sum())
        assert set(got.arr_egress[:real].tolist()) == {2}
    for f in FIELDS:
        a, b = getattr(host, f).numpy(), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", ["two_ingress", "trace_off_on_cap"])
def test_deterministic_matches_jax_device_traffic(name):
    """The same deterministic scenarios through the JAX package's
    ``DeviceTraffic``: the same schedule bit for bit."""
    kw, n_ing, egress, rows, steps = DETERMINISTIC[name]
    jsvc = JService(sfc_list={"sfc_1": ("a", "b")},
                    sf_list={n: JSF(name=n) for n in "ab"})
    jt = j_compile(JSpec(**_spec(n_ing, egress)), max_nodes=N, max_edges=E)
    jtrace = JTrace(rows) if rows else None
    want = jax.jit(JDeviceTraffic(JSim(**kw), jsvc, jt, steps,
                                  trace=jtrace).sample)(
        jax.random.PRNGKey(0))
    got = DeviceTraffic(SimConfig(**kw), service(), topo(n_ing, egress),
                        steps, trace=TraceEvents(rows) if rows else None
                        ).sample(gen(1))
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)


def test_poisson_rates_match_host_distribution():
    cfg = SimConfig(ttl_choices=(100.0,), deterministic_arrival=False,
                    inter_arrival_mean=10.0)
    dt = DeviceTraffic(cfg, service(), topo(1), episode_steps=20)
    counts, gaps = [], []
    for s in range(8):
        t = np.sort(_finite(dt.sample(gen(s)).arr_time))
        counts.append(len(t))
        gaps.append(np.diff(t))
    # horizon / mean = 200 expected arrivals
    assert abs(np.mean(counts) - 200) < 25
    assert abs(np.concatenate(gaps).mean() - 10.0) < 1.5
    assert counts[0] != counts[1] or not np.array_equal(gaps[0], gaps[1])


def test_pareto_sizes_and_dr_rejection():
    cfg = SimConfig(ttl_choices=(100.0,), deterministic_size=False,
                    flow_size_shape=2.0, flow_dr_mean=1.0, flow_dr_stdev=0.3)
    tr = DeviceTraffic(cfg, service(), topo(1), episode_steps=10).sample(
        gen(0))
    fin = np.isfinite(tr.arr_time.numpy())
    dr = tr.arr_dr.numpy()[fin]
    sizes = tr.arr_duration.numpy()[fin] * dr / 1000.0
    assert (dr >= 0).all()
    assert (sizes >= 1.0 - 1e-5).all()          # Pareto support
    assert 1.3 < sizes.mean() < 3.5             # Pareto(2) mean 2


def test_mmpp_density_and_interval_means():
    dt = DeviceTraffic(SimConfig(**MMPP), service(), topo(1),
                       episode_steps=40)
    t = _finite(dt.sample(gen(7)).arr_time)
    counts = np.histogram(t, bins=40, range=(0, 4000))[0]
    # both dense (~20/interval) and sparse (~2/interval) states visited
    assert counts.max() >= 15 and counts.min() <= 3
    assert not np.array_equal(t, _finite(dt.sample(gen(8)).arr_time))


def test_trace_deactivation_and_caps():
    rows = [(200.0, 0, None, None), (400.0, 0, 10.0, 5000.0)]
    cfg = SimConfig(ttl_choices=(100.0,), inter_arrival_mean=10.0)
    dev = DeviceTraffic(cfg, service(), topo(1), 6,
                        trace=TraceEvents(rows)).sample(gen(0))
    t = _finite(dev.arr_time)
    assert not ((t >= 200.0) & (t < 400.0)).any()   # silent window
    assert (t >= 400.0).any()                        # reactivated
    assert dev.node_cap.numpy()[4:, 0].max() == 5000.0


def test_trace_overrides_mmpp_means():
    """Trace rows override the chain from their time on: the window is
    silent whatever state the chain is in, and after it the row's fixed
    mean applies."""
    trace = TraceEvents([(500.0, 0, None, None), (1500.0, 0, 5.0, None)])
    dt = DeviceTraffic(SimConfig(**MMPP), service(), topo(1), 20,
                       trace=trace)
    t = _finite(dt.sample(gen(3)).arr_time)
    assert not ((t >= 500.0) & (t < 1500.0)).any()
    assert (t < 500.0).any() and (t >= 1500.0).any()
    assert np.allclose(np.diff(np.sort(t[t >= 1500.0])), 5.0)


def test_engine_consumes_device_traffic():
    cfg = SimConfig(ttl_choices=(100.0,), inter_arrival_mean=10.0,
                    max_flows=32)
    limits = EnvLimits(max_nodes=N, max_edges=E, num_sfcs=1, max_sfs=2)
    tp = topo(2)
    traffic = DeviceTraffic(cfg, service(), tp, 3).sample_batch(gen(0), 2)
    engine = SimEngine(service(), cfg, limits)
    nm = tp.node_mask.numpy()
    sched = np.zeros((2,) + limits.scheduling_shape, np.float32)
    sched[..., nm] = 1.0 / nm.sum()
    place = torch.from_numpy(np.broadcast_to(nm[:, None], (2, N, 2)).copy())
    state = engine.init(2, "cpu")
    for i in range(3):
        state, m = engine.apply(state, tp, traffic, torch.from_numpy(sched),
                                place, engine.draw_noise(2, gen(i), "cpu"))
    assert (m.generated > 0).all()
    assert torch.equal(m.generated, m.processed + m.dropped + m.active)


def test_batch_sampling_shapes_and_divergence():
    cfg = SimConfig(ttl_choices=(100.0,), deterministic_arrival=False)
    dt = DeviceTraffic(cfg, service(), topo(2), episode_steps=4)
    b = dt.sample_batch(gen(0), 4)
    assert b.arr_time.shape == (4, dt.capacity)
    assert b.ingress_active.shape == (4, 4, N)
    assert not torch.equal(b.arr_time[0], b.arr_time[1])


def test_short_blocks_only_cost_steps(monkeypatch):
    """Blocks of gaps shorter than an interval's arrivals (the clocks
    continue in the next step) give the same deterministic schedule."""
    import gsc_tpu_torch.sim.traffic_device as td

    cfg = SimConfig(ttl_choices=(100.0,), inter_arrival_mean=3.0)
    dt = DeviceTraffic(cfg, service(), topo(2), 5)
    want = dt.sample(gen(0))
    monkeypatch.setattr(td, "block_size", lambda cfg, mean: 2)
    got = dt.sample(gen(0))
    for f in FIELDS:
        assert torch.equal(getattr(want, f), getattr(got, f)), f
    host = generate_traffic(cfg, service(), topo(2), 5, seed=0)
    assert torch.equal(host.arr_time, got.arr_time)
