"""The port's scenario factory and TD curriculum against the JAX
package's (gsc_tpu/topology/factory.py, gsc_tpu/env/curriculum.py),
mirroring tests/test_scenario_factory.py:82-445.

- grammar and build validation: the same mixes parse and are refused,
  with the JAX package's messages;
- 32 sampled topologies per check are valid compiled topologies (masks,
  ids, adjacency, path conventions), and on the fixed families (line,
  star, ring at pinned n, unique shortest paths) the factory's
  Floyd-Warshall equals the port's and the JAX package's host compilers
  and the JAX factory, exactly;
- sampled traffic follows the deterministic renewal grid with shapes
  off, shapes modulate it, a fault zeroes exactly one real element from
  its interval on;
- the curriculum's EWMAs and weights equal JAX ``Curriculum`` on the same
  TD sums to rtol 1e-12 (the same float64 arithmetic), hand-computed
  cases included; the driver's factory wiring.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsc_tpu.config.catalog import abc_service as j_abc
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.env.curriculum import Curriculum as JCurriculum
from gsc_tpu.env.curriculum import CurriculumConfig as JCurriculumConfig
from gsc_tpu.topology.compiler import compile_topology as j_compile
from gsc_tpu.topology.factory import ScenarioFactory as JFactory
from gsc_tpu.topology.factory import parse_factory as j_parse
from gsc_tpu.topology.synthetic import line as j_line
from gsc_tpu.topology.synthetic import ring as j_ring
from gsc_tpu.topology.synthetic import star as j_star

from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import SchedulerConfig, SimConfig
from gsc_tpu_torch.env.curriculum import Curriculum, CurriculumConfig
from gsc_tpu_torch.env.driver import EpisodeDriver
from gsc_tpu_torch.topology.compiler import INF_DELAY, compile_topology
from gsc_tpu_torch.topology.factory import (FAMILIES, ScenarioFactory,
                                            is_factory_mix, parse_factory)
from gsc_tpu_torch.topology.scenarios import validate_mix
from gsc_tpu_torch.topology.synthetic import line, ring, star, triangle
from torch_port_helpers import one_torch_thread  # noqa: F401

MIX = "factory:star-ring-line-random+shapes~faults"
N = E = 8
SIM = dict(ttl_choices=(100.0,), max_flows=32)


def _factory(mix=MIX, steps=2, **over):
    spec = parse_factory(mix)
    if over:
        spec = dataclasses.replace(spec, **over)
    return ScenarioFactory(spec, SimConfig(**SIM), abc_service(), steps,
                           max_nodes=N, max_edges=E)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _uniform(k):
    return torch.full((k,), 1.0 / k)


# ------------------------------------------------------------------ grammar
@pytest.mark.parametrize("mix", ["factory:all", "factory:star-ring+shapes"
                                 "~faults", "factory:line~faults",
                                 "factory:random-line+shapes"])
def test_factory_grammar_parses_as_jax(mix):
    assert dataclasses.astuple(parse_factory(mix)) == \
        dataclasses.astuple(j_parse(mix))
    assert validate_mix(mix) == parse_factory(mix)


@pytest.mark.parametrize("mix", ["factory:", "factory:warp",
                                 "factory:star-star", "factory:star,abilene",
                                 "factory:star+warp", "abilene", ""])
def test_factory_grammar_refuses_as_jax(mix):
    with pytest.raises(ValueError) as jerr:
        j_parse(mix)
    with pytest.raises(ValueError) as terr:
        parse_factory(mix)
    assert str(terr.value) == str(jerr.value)
    assert is_factory_mix("factory:all") and not is_factory_mix("abilene")
    assert not is_factory_mix(None) and not is_factory_mix("")


@pytest.mark.parametrize("over, match", [(dict(n_min=2), "n_min"),
                                         (dict(n_max=8), "edges")])
def test_factory_build_validation(over, match):
    with pytest.raises(ValueError, match=match) as terr:
        _factory(**over)
    spec = dataclasses.replace(j_parse(MIX), **over)
    with pytest.raises(ValueError) as jerr:
        JFactory(spec, JSim(**SIM), j_abc(), 2, max_nodes=N, max_edges=E)
    assert str(terr.value) == str(jerr.value)
    mmpp = type("MMPPCfg", (), {"use_states": True})()
    with pytest.raises(ValueError, match="use_states"):
        ScenarioFactory(parse_factory("factory:line"), mmpp, abc_service(),
                        2, max_nodes=N, max_edges=E)


# ------------------------------------------------------------- topologies
def test_factory_sampling_deterministic_per_generator():
    a = _factory().sample_batch(_gen(3), _uniform(4), 4)
    b = _factory().sample_batch(_gen(3), _uniform(4), 4)
    c = _factory().sample_batch(_gen(4), _uniform(4), 4)
    same = lambda x, y: all(torch.equal(u, v) for u, v in zip(
        dataclasses.astuple(x[0]), dataclasses.astuple(y[0])))
    assert same(a, b) and not same(a, c)
    assert torch.equal(a[1].arr_time, b[1].arr_time)


@pytest.mark.parametrize("seed", [9, 10])
def test_factory_topologies_valid_over_many_draws(seed):
    f = _factory()
    topo, _ = f.sample_batch(_gen(seed), _uniform(4), 32)
    for r in range(32):
        t = topo.map(lambda x: x[r])
        n, e = int(t.n_nodes), int(t.n_edges)
        assert f.spec.n_min <= n <= f.n_max
        assert torch.equal(t.node_mask, torch.arange(N) < n)
        assert torch.equal(t.edge_mask, torch.arange(E) < e)
        assert 0 <= int(t.topo_id) < 4
        assert t.is_ingress.sum() >= 1 and not t.is_egress.any()
        assert (t.node_cap[:n] >= 1).all() and (t.node_cap[n:] == 0).all()
        eu, ev = t.edge_u[:e], t.edge_v[:e]
        assert (eu < n).all() and (ev < n).all() and (eu != ev).all()
        for i in range(e):
            assert t.adj_edge_id[eu[i], ev[i]] == i
            assert t.adj_edge_id[ev[i], eu[i]] == i
        pd, nh = t.path_delay.numpy(), t.next_hop.numpy()
        assert (pd[:n, :n] < INF_DELAY).all()
        assert (np.diag(pd)[:n] == 0).all()
        assert (np.diag(nh)[:n] == np.arange(n)).all()
        off = ~np.eye(n, dtype=bool)
        assert ((nh[:n, :n] >= 0) & (nh[:n, :n] < n))[off].all()
        assert (pd[n:] == INF_DELAY).all() and (pd[:, n:] == INF_DELAY).all()
        assert (nh[n:] == -1).all() and (nh[:, n:] == -1).all()


@pytest.mark.parametrize("fam, n", [("line", 5), ("star", 5), ("ring", 5),
                                    ("line", 8), ("star", 7), ("ring", 7)])
def test_fixed_families_equal_the_compilers(fam, n):
    """At pinned (family, n) the factory's matrices equal the port's host
    compiler, the JAX package's host compiler and the JAX factory."""
    builders = {"line": (line, j_line), "star": (star, j_star),
                "ring": (ring, j_ring)}
    f = _factory(mix=f"factory:{fam}", n_min=n, n_max=n)
    topo, _ = f.sample_batch(_gen(1), torch.ones(1), 1)
    t = topo.map(lambda x: x[0])
    host = compile_topology(builders[fam][0](n), max_nodes=N, max_edges=E)
    jhost = j_compile(builders[fam][1](n), max_nodes=N, max_edges=E)
    jf = JFactory(dataclasses.replace(j_parse(f"factory:{fam}"), n_min=n,
                                      n_max=n), JSim(**SIM), j_abc(), 2,
                  max_nodes=N, max_edges=E)
    jt, _ = jf.sample_batch(jax.random.PRNGKey(1), jnp.ones((1,)), 1)
    for k in ("path_delay", "next_hop", "adj_edge_id", "edge_u", "edge_v",
              "edge_mask", "node_mask", "diameter"):
        want = getattr(host, k)
        assert torch.equal(getattr(t, k), want), k
        np.testing.assert_array_equal(np.asarray(getattr(jhost, k)),
                                      want.numpy(), err_msg=k)
        np.testing.assert_array_equal(np.asarray(getattr(jt, k))[0],
                                      want.numpy(), err_msg=k)


# ------------------------------------------------------- traffic + faults
def test_factory_traffic_deterministic_gaps_without_shapes():
    f = _factory(mix="factory:star-ring-line-random", steps=3)
    topo, tr = f.sample_batch(_gen(2), _uniform(4), 8)
    assert tr.edge_cap_t is None
    mean = SIM.get("inter_arrival_mean", 10.0)
    for r in range(8):
        times = tr.arr_time[r].numpy()
        real = times[np.isfinite(times)]
        n_ing = int((topo.is_ingress[r] & topo.node_mask[r]).sum())
        assert (np.diff(real) >= 0).all()
        assert np.isinf(times[len(real):]).all()
        assert len(real) == n_ing * int(np.ceil(f.horizon / mean))
        assert set(tr.arr_ingress[r, :len(real)].tolist()) == set(
            range(n_ing))
        np.testing.assert_allclose(sorted(set(real.tolist())),
                                   np.arange(0, f.horizon, mean))


def test_factory_fault_tables_zero_real_elements():
    f = _factory(mix="factory:star-ring-line-random~faults", steps=4,
                 fault_rate=1.0)
    topo, tr = f.sample_batch(_gen(11), _uniform(4), 16)
    saw_node = saw_link = False
    for r in range(16):
        n, e = int(topo.n_nodes[r]), int(topo.n_edges[r])
        ncap, ecap = tr.node_cap[r].numpy(), tr.edge_cap_t[r].numpy()
        node_cols = [v for v in range(n)
                     if ncap[0, v] > 0 and (ncap[:, v] == 0).any()]
        link_cols = [i for i in range(e) if (ecap[:, i] == 0).any()]
        assert len(node_cols) + len(link_cols) == 1, (r, node_cols,
                                                      link_cols)
        col, table = ((node_cols[0], ncap) if node_cols
                      else (link_cols[0], ecap))
        zeroed = table[:, col] == 0
        k0 = int(np.argmax(zeroed))
        assert k0 >= 1 and zeroed[k0:].all() and not zeroed[:k0].any()
        assert (ncap[:, n:] == 0).all() and (ecap[:, e:] == 0).all()
        saw_node |= bool(node_cols)
        saw_link |= bool(link_cols)
    assert saw_node and saw_link


def test_factory_shapes_modulate_sampled_means():
    f = _factory(mix="factory:line+shapes", steps=8)
    _, tr = f.sample_batch(_gen(4), torch.ones(1), 16)
    gaps = set()
    for r in range(16):
        t = tr.arr_time[r].numpy()
        t = t[np.isfinite(t)]
        if len(t) > 1:
            gaps.add(round(float(t[1] - t[0]), 3))
    assert len(gaps) > 1, gaps


# --------------------------------------------------------------- curriculum
TD_STREAMS = {
    "hand": (dict(alpha=0.5, floor=0.0, temperature=1.0), 2,
             [([12.0, 0.0], [4.0, 0.0]), ([4.0, 8.0], [4.0, 2.0]),
              ([10.0, 0.0], [10.0, 0.0])]),
    "skew_floor": (dict(floor=0.2, temperature=1.0), 4,
                   [([1e4, 0.1, 0.1, 0.1], [1.0, 1.0, 1.0, 1.0])]),
    "poisoned": (dict(alpha=0.5, floor=0.1), 2,
                 [([2.0, 4.0], [1.0, 1.0]), ([np.nan, np.inf], [1.0, 1.0]),
                  ([1.0, np.nan], [1.0, np.nan])]),
    "random": (dict(floor=0.25, temperature=0.7, alpha=0.3), 4, None),
}


@pytest.mark.parametrize("name", sorted(TD_STREAMS))
def test_curriculum_equals_jax(name):
    """The same TD sums into both curricula: EWMAs, weights and the
    emitted weights event equal (rtol 1e-12)."""
    from gsc_tpu.obs.hub import MetricsHub as JHub

    from gsc_tpu_torch.obs.hub import MetricsHub

    kw, k, stream = TD_STREAMS[name]
    if stream is None:
        rng = np.random.default_rng(3)
        stream = [(rng.uniform(0, 5, k) * (rng.uniform(size=k) < 0.8),
                   rng.integers(0, 20, k).astype(float)) for _ in range(6)]
    names = [f"f{i}" for i in range(k)]
    t, j = Curriculum(names, CurriculumConfig(**kw)), \
        JCurriculum(names, JCurriculumConfig(**kw))
    np.testing.assert_array_equal(t.weights(), j.weights())
    for sums, counts in stream:
        np.testing.assert_allclose(t.fold_td(sums, counts),
                                   j.fold_td(sums, counts), rtol=1e-12)
        w = t.weights()
        np.testing.assert_allclose(w, j.weights(), rtol=1e-12)
        assert w.sum() == pytest.approx(1.0)
        assert (w >= kw.get("floor", 0.25) / k - 1e-12).all()
    ev_t = t.emit_weights(MetricsHub(), 5)
    ev_j = j.emit_weights(JHub(), 5)
    for key in ("weights", "td_ewma", "updates", "episode"):
        assert ev_t[key] == ev_j[key], key


def test_curriculum_hand_computed():
    c = Curriculum(["a", "b"], CurriculumConfig(alpha=0.5, floor=0.0))
    np.testing.assert_allclose(c.weights(), [0.5, 0.5])
    c.fold_td([12.0, 0.0], [4.0, 0.0])
    np.testing.assert_allclose(c.ewma, [3.0, 0.0])
    np.testing.assert_allclose(c.weights(), [0.5, 0.5])   # optimism
    c.fold_td([4.0, 8.0], [4.0, 2.0])
    np.testing.assert_allclose(c.ewma, [2.0, 4.0])
    e2 = np.exp(2.0)
    np.testing.assert_allclose(c.weights(), [1 / (1 + e2), e2 / (1 + e2)],
                               rtol=1e-12)
    with pytest.raises(ValueError, match="families"):
        c.fold_td([1.0], [1.0])


@pytest.mark.parametrize("bad", [dict(floor=-0.1), dict(floor=1.5),
                                 dict(temperature=0.0),
                                 dict(temperature=-1.0), dict(alpha=0.0),
                                 dict(alpha=1.5)])
def test_curriculum_config_validation(bad):
    with pytest.raises(ValueError):
        CurriculumConfig(**bad)
    with pytest.raises(ValueError):
        JCurriculumConfig(**bad)
    with pytest.raises(ValueError):
        Curriculum([], CurriculumConfig())


# ------------------------------------------------------------------ driver
def test_driver_factory_wiring():
    tA = compile_topology(triangle(), max_nodes=N, max_edges=E)
    sched = SchedulerConfig(training_network_files=("a.graphml",),
                            inference_network="a.graphml", period=1)
    cfg, svc = SimConfig(**SIM), abc_service()
    driver = EpisodeDriver(sched, cfg, svc, 2, max_nodes=N, max_edges=E,
                           topologies=[tA], inference_topology=tA,
                           topo_mix="factory:star-ring-line")
    assert driver.factory_spec is not None
    assert driver.num_topo_ids == 3
    assert driver.topo_id_names == ["star", "ring", "line"]
    with pytest.raises(ValueError, match="MixPlan"):
        driver.mix_plan(4)
    f = driver.scenario_factory
    assert f is driver.factory_on("cpu") and f.family_names == \
        ["star", "ring", "line"]
    reg = EpisodeDriver(sched, cfg, svc, 2, max_nodes=N, max_edges=E,
                        topologies=[tA], inference_topology=tA,
                        topo_mix="schedule,line3")
    assert reg.factory_spec is None and reg.scenario_factory is None
    assert reg.num_topo_ids == 2 and reg.topo_id_names == ["a.graphml",
                                                           "line3"]
    assert list(FAMILIES) == ["star", "ring", "line", "random"]
