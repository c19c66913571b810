"""The port's topology compiler and traffic generator against the JAX
package's: byte-equal arrays (same dtype, same bits) for the same specs
and seeds.  Tolerance: none — every comparison is exact."""
import dataclasses

import numpy as np
import pytest

from gsc_tpu.config.schema import SimConfig as JSimConfig
from gsc_tpu.config.catalog import abc_service as j_abc_service
from gsc_tpu.sim.traffic import generate_traffic as j_generate_traffic
from gsc_tpu.topology import synthetic as jsyn
from gsc_tpu.topology.compiler import compile_topology as j_compile

from gsc_tpu_torch.config import abc_service, init_configs_sim
from gsc_tpu_torch.config.schema import SimConfig
from gsc_tpu_torch.sim.traffic import generate_traffic
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import Topology, compile_topology
from torch_port_helpers import numpy_traffic_path
from torch_port_helpers import one_torch_thread  # noqa: F401

SPECS = {
    "abilene": lambda s: s.abilene(),
    "abilene_seed3": lambda s: s.abilene(seed=3),
    "bteurope": lambda s: s.bteurope(),
    "bteurope_randcap": lambda s: s.bteurope(node_cap_range=(1, 3)),
    "line3": lambda s: s.line(3),
    "triangle": lambda s: s.triangle(),
}


def _assert_same(j_arr, t_arr, name):
    a = np.asarray(j_arr)
    b = t_arr.numpy()
    assert a.dtype == b.dtype, f"{name}: {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{name}: {a.shape} vs {b.shape}"
    assert a.tobytes() == b.tobytes(), f"{name} differs"


@pytest.mark.parametrize("name", sorted(SPECS))
def test_compile_topology_byte_equal(name):
    jt = j_compile(SPECS[name](jsyn))
    tt = compile_topology(SPECS[name](synthetic))
    for f in dataclasses.fields(Topology):
        _assert_same(getattr(jt, f.name), getattr(tt, f.name), f.name)


def test_next_hop_ties_follow_insertion_order():
    """A 4-cycle with equal weights: both 2-hop paths 0->2 tie, and the
    first found (via node 1, the first inserted neighbour) must win, as
    networkx's Johnson keeps it."""
    from gsc_tpu.topology.compiler import NetworkSpec as JSpec
    from gsc_tpu_torch.topology.compiler import NetworkSpec

    edges = [(0, 1, 100.0, 1.0), (0, 3, 100.0, 1.0), (1, 2, 100.0, 1.0),
             (3, 2, 100.0, 1.0)]
    kw = dict(node_caps=[1.0] * 4, node_types=["Ingress"] + ["Normal"] * 3,
              edges=edges)
    jt = j_compile(JSpec(**kw), max_nodes=6, max_edges=6)
    tt = compile_topology(NetworkSpec(**kw), max_nodes=6, max_edges=6)
    _assert_same(jt.next_hop, tt.next_hop, "next_hop")
    assert int(tt.next_hop[0, 2]) == 1


@pytest.mark.parametrize("topo_name", ["abilene", "bteurope"])
def test_traffic_byte_equal_init_configs(topo_name):
    """The deterministic init-configs simulator.yaml values (where the JAX
    package's native and numpy generators agree): the whole 200-step
    episode schedule is byte-equal."""
    jcfg = JSimConfig(inter_arrival_mean=10.0, deterministic_arrival=True,
                      flow_dr_mean=1.0, flow_dr_stdev=0.0,
                      flow_size_shape=0.001, deterministic_size=True,
                      run_duration=100.0, ttl_choices=(100.0,))
    jt = j_compile(SPECS[topo_name](jsyn))
    tt = compile_topology(SPECS[topo_name](synthetic))
    js = j_generate_traffic(jcfg, j_abc_service(), jt, 200, seed=0)
    ts = generate_traffic(init_configs_sim(), abc_service(), tt, 200, seed=0)
    for f in dataclasses.fields(ts):
        _assert_same(getattr(js, f.name), getattr(ts, f.name), f.name)


def test_traffic_byte_equal_stochastic_numpy_path(monkeypatch):
    """Poisson arrivals, Pareto sizes, noisy rates and two TTLs on both
    packages' numpy path (``GSC_TPU_NO_NATIVE=1``): the port draws in the
    same order, so the bytes agree."""
    numpy_traffic_path(monkeypatch)
    kw = dict(inter_arrival_mean=7.0, deterministic_arrival=False,
              flow_dr_mean=1.0, flow_dr_stdev=0.3, flow_size_shape=2.0,
              deterministic_size=False, run_duration=100.0,
              ttl_choices=(50.0, 100.0))
    jt = j_compile(jsyn.abilene())
    tt = compile_topology(synthetic.abilene())
    js = j_generate_traffic(JSimConfig(**kw), j_abc_service(), jt, 12, seed=5)
    ts = generate_traffic(SimConfig(**kw), abc_service(), tt, 12, seed=5)
    for f in dataclasses.fields(ts):
        _assert_same(getattr(js, f.name), getattr(ts, f.name), f.name)
