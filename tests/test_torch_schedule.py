"""The port's GraphML reader and writer, scheduler loader and topology
schedule against the JAX package's, and the loader's handling of
service, controller and capacity-override options.

- ``load_topology`` of GraphML files that the JAX package's
  ``write_graphml`` (networkx) wrote from the abilene, bteurope (caps in
  1-2), claranet, compuserve, triangle and line(3) builders, and of the
  two files in tests/assets/, with and without the capacity overrides:
  every ``Topology`` field byte-equal (the compiled topology of the same
  network is byte-equal, tests/test_torch_topology_traffic.py, and
  parsing adds no arithmetic);
- the port's ``write_graphml`` read back by the JAX package's
  ``read_graphml`` gives what the JAX package's own file gives, field for
  field (exact);
- node orders and edge orders of random multigraphs written by networkx,
  parallel edges and self-loops included: exact;
- ``load_scheduler`` resolves the same paths; the driver's
  ``topology_for`` picks the same networks over 7 episodes (period 2,
  three networks, and test mode) and ``traffic_for`` samples byte-equal
  traffic (both packages' native sampler).

Tolerance: none, every comparison is exact.
"""
import dataclasses
import logging
import os
import random

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest

from gsc_tpu.config.catalog import abc_service as j_abc
from gsc_tpu.config.loader import load_scheduler as j_load_scheduler
from gsc_tpu.config.loader import load_sim as j_load_sim
from gsc_tpu.config.schema import SchedulerConfig as JSched
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.env.driver import EpisodeDriver as JDriver
from gsc_tpu.topology import synthetic as jsyn
from gsc_tpu.topology.compiler import load_topology as j_load
from gsc_tpu.topology.compiler import read_graphml as j_read

from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.loader import (load_scheduler, load_service,
                                         load_sim)
from gsc_tpu_torch.config.schema import SchedulerConfig, SimConfig
from gsc_tpu_torch.env.driver import EpisodeDriver
from gsc_tpu_torch.sim.state import TrafficSchedule
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import (Topology, check_dt_quantization,
                                             load_topology,
                                             load_topology_cached,
                                             read_graphml)
from torch_port_helpers import one_torch_thread  # noqa: F401

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
BUILDERS = {
    "abilene": lambda s: s.abilene(),
    "bteurope_randcap": lambda s: s.bteurope(node_cap_range=(1, 3)),
    "claranet": lambda s: s.claranet(),
    "compuserve": lambda s: s.compuserve(),
    "triangle": lambda s: s.triangle(),
    "line3": lambda s: s.line(3),
}
FILES = sorted(BUILDERS) + ["line3-egress.graphml", "line3-linkcap2.graphml"]
CAPS = {"plain": {}, "forced": {"force_link_cap": 7.0,
                                "force_node_cap": (1.0, 4.0)}}


def _graphml(name, tmp_path):
    """A GraphML file: an asset, or the JAX package's writer's output."""
    if name.endswith(".graphml"):
        return os.path.join(ASSETS, name)
    path = str(tmp_path / f"{name}.graphml")
    jsyn.write_graphml(BUILDERS[name](jsyn), path)
    return path


def _assert_topology(jt, tt):
    for f in dataclasses.fields(Topology):
        a, b = np.asarray(getattr(jt, f.name)), getattr(tt, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert a.tobytes() == b.tobytes(), f.name


@pytest.mark.parametrize("caps", sorted(CAPS))
@pytest.mark.parametrize("name", FILES)
def test_load_topology_matches_jax(name, caps, tmp_path):
    path = _graphml(name, tmp_path)
    kw = dict(CAPS[caps], seed=5)
    _assert_topology(j_load(path, **kw), load_topology(path, **kw))


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_write_graphml_round_trips_through_jax(name, tmp_path):
    spec = BUILDERS[name](synthetic)
    assert vars(spec) == vars(BUILDERS[name](jsyn))
    ours, theirs = str(tmp_path / "port.graphml"), _graphml(name, tmp_path)
    synthetic.write_graphml(spec, ours)
    for kw in ({}, {"force_node_cap": (1, 3), "force_link_cap": 0.0}):
        want = j_read(theirs, rng=np.random.default_rng(2), **kw)
        got = j_read(ours, rng=np.random.default_rng(2), **kw)
        assert vars(got) == vars(want)
        assert vars(read_graphml(ours, rng=np.random.default_rng(2),
                                 **kw)) == vars(want)


@pytest.mark.parametrize("seed", range(4))
def test_graphml_orders_match_networkx(seed, tmp_path):
    """Random graphs (every third a multigraph) with shuffled node
    declarations, repeated pairs and self-loops, written by networkx:
    the port parses the nodes and edges networkx does, in its order."""
    for trial in range(25):
        rng = random.Random(100 * seed + trial)
        n = rng.randint(2, 9)
        g = nx.MultiGraph() if trial % 3 == 0 else nx.Graph()
        order = list(range(n))
        rng.shuffle(order)
        for i in order:
            g.add_node(i, NodeCap=float(rng.randint(1, 5)),
                       NodeType=rng.choice(["Ingress", "Normal", "Egress"]))
        for _ in range(rng.randint(1, 12)):
            g.add_edge(rng.randrange(n), rng.randrange(n),
                       LinkFwdCap=float(rng.randint(1, 9)),
                       LinkDelay=float(rng.randint(0, 9)))
        path = str(tmp_path / f"r{trial}.graphml")
        nx.write_graphml(g, path)
        assert vars(read_graphml(path)) == vars(j_read(path))


def test_forced_node_caps_draw_as_jax(tmp_path):
    """``force_node_cap`` draws the same caps from the same seed, and
    different seeds differ."""
    path = _graphml("bteurope_randcap", tmp_path)
    caps = []
    for seed in (0, 1):
        want = j_read(path, force_node_cap=(1, 5),
                      rng=np.random.default_rng(seed)).node_caps
        got = read_graphml(path, force_node_cap=(1, 5),
                           rng=np.random.default_rng(seed)).node_caps
        assert got == want
        caps.append(got)
    assert caps[0] != caps[1] and set(caps[0]) <= {1.0, 2.0, 3.0, 4.0}


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def test_load_scheduler_resolves_paths_as_jax(tmp_path, monkeypatch):
    """Paths as written, relative to the yaml's directory, and relative to
    one of its ancestors (a repository-root-relative path)."""
    root = tmp_path / "exp"
    (root / "configs" / "networks").mkdir(parents=True)
    (root / "configs" / "config").mkdir()
    for name in ("a", "b", "c"):
        synthetic.write_graphml(synthetic.triangle(),
                                str(root / "configs" / "networks"
                                    / f"{name}.graphml"))
    absolute = str(root / "configs" / "networks" / "c.graphml")
    sched = _write(root / "configs" / "config" / "scheduler.yaml",
                   "training_network_files:\n"
                   "  - configs/networks/a.graphml\n"
                   "  - ../networks/b.graphml\n"
                   f"inference_network: {absolute}\nperiod: 3\n")
    monkeypatch.chdir(tmp_path)
    want, got = j_load_scheduler(sched), load_scheduler(sched)
    assert got.training_network_files == want.training_network_files
    assert got.inference_network == want.inference_network == absolute
    assert got.period == want.period == 3
    assert all(os.path.exists(p) for p in got.training_network_files)
    _write(sched, "training_network_files: [a.graphml]\n"
           "inference_network: a.graphml\n")
    assert load_scheduler(sched).period == JSched(("x",), "y").period == 10
    with pytest.raises(ValueError, match="period"):
        SchedulerConfig(training_network_files=("a",),
                        inference_network="b", period=0)
    with pytest.raises(ValueError, match="must not be empty"):
        SchedulerConfig(training_network_files=(), inference_network="b")


SIM_KW = dict(inter_arrival_mean=5.0, run_duration=10.0,
              ttl_choices=(100.0,))


def _drivers(tmp_path, period=2):
    files = [_graphml(n, tmp_path) for n in ("triangle", "line3", "abilene")]
    infer = _graphml("compuserve", tmp_path)
    jd = JDriver(JSched(tuple(files), infer, period), JSim(**SIM_KW),
                 j_abc(), 4, max_nodes=16, max_edges=20, base_seed=7)
    td = EpisodeDriver(SchedulerConfig(tuple(files), infer, period),
                       SimConfig(**SIM_KW), abc_service(), 4, max_nodes=16,
                       max_edges=20, base_seed=7)
    return jd, td


def test_schedule_driver_matches_jax(tmp_path):
    jd, td = _drivers(tmp_path)
    assert td.capacity == jd.capacity
    for ep in range(7):
        for test_mode in (False, True):
            jt = jd.topology_for(ep, test_mode)
            tt = td.topology_for(ep, test_mode)
            _assert_topology(jt, tt)
            assert td.topology_name_for(ep, test_mode) == \
                jd.topology_name_for(ep, test_mode)
            jtop, jtr = jd.episode(ep, test_mode)
            ttop, ttr = td.episode(ep, test_mode)
            for f in dataclasses.fields(TrafficSchedule):
                a = np.asarray(getattr(jtr, f.name))
                b = getattr(ttr, f.name).numpy()
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
                    (ep, test_mode, f.name)
    # period 2 over three networks: 0 0 1 1 2 2 0, each stamped with its
    # schedule position
    picks = [int(td.topology_for(ep).topo_id) for ep in range(7)]
    assert picks == [0, 0, 1, 1, 2, 2, 0]
    assert td.topology_name_for(3) == "line3.graphml"
    assert td.topology_name_for(0, True) == "compuserve.graphml"


def test_schedule_driver_from_topology_lists(tmp_path):
    """Topologies given directly are stamped with their position; a
    one-network schedule trains and infers on the same network."""
    jd, td = _drivers(tmp_path, period=1)
    topos = [load_topology(_graphml(n, tmp_path), max_nodes=16,
                           max_edges=20) for n in ("triangle", "line3")]
    d = EpisodeDriver(SchedulerConfig(("x", "y"), "z", 1),
                      SimConfig(**SIM_KW), abc_service(), 4,
                      topologies=topos, inference_topology=topos[0])
    assert [int(t.topo_id) for t in d.topologies] == [0, 1]
    assert d.topology_for(3) is d.topologies[1]
    assert d.topology_name_for(1) == "y"
    one = EpisodeDriver.single(topos[1], SimConfig(**SIM_KW), abc_service(),
                               4, "line3")
    assert one.topology_for(5) is one.topology_for(0, True) is topos[1]
    assert one.topology_name_for(2) == "line3"
    stacked = one.replica_traffic(2, 3)
    for r in range(3):
        single = one.traffic_for(2, topos[1], seed=1000 * 2 + r)
        assert all(torch_equal(getattr(stacked, f)[r], getattr(single, f))
                   for f in TrafficSchedule._RANKS)


def torch_equal(a, b):
    return a.shape == b.shape and bool((a == b).all())


def test_load_topology_cached_returns_one_object(tmp_path):
    path = _graphml("triangle", tmp_path)
    a = load_topology_cached(path, max_nodes=8, max_edges=8, topo_id=2)
    b = load_topology_cached(path, max_nodes=8, max_edges=8, topo_id=2)
    c = load_topology_cached(path, max_nodes=8, max_edges=8, topo_id=0)
    assert a is b and a is not c
    assert int(a.topo_id) == 2 and int(c.topo_id) == 0


def test_dt_quantization_warns_as_jax(tmp_path):
    """Fractional delays at dt=1 warn (and name a dt that fits); integer
    delays do not."""
    spec = synthetic.line(3, link_delay=2.5)
    path = str(tmp_path / "frac.graphml")
    synthetic.write_graphml(spec, path)
    topo = load_topology(path, max_nodes=8, max_edges=8)
    with pytest.warns(UserWarning, match="consider dt=0.5"):
        assert check_dt_quantization(topo, 1.0, name="frac")
    assert not check_dt_quantization(topo, 0.5)
    from gsc_tpu.topology.compiler import check_dt_quantization as j_check
    with pytest.warns(UserWarning):
        assert j_check(j_load(path, max_nodes=8, max_edges=8), 1.0)


# ---- the loader's repairs ----------------------------------------------
SIM_YAML = ("inter_arrival_mean: 10.0\ndeterministic_arrival: true\n"
            "deterministic_size: true\nflow_dr_mean: 1.0\n"
            "flow_dr_stdev: 0.0\nflow_size_shape: 0.001\n"
            "run_duration: 10\nttl_choices: [100]\n")


def test_unknown_resource_function_falls_back_to_default(tmp_path, caplog):
    """The JAX package's rule (tests/test_config_schema.py): an SF naming
    an unknown resource function runs the default one, with a warning."""
    path = _write(tmp_path / "svc.yaml",
                  "sfc_list: {c: [a]}\n"
                  "sf_list:\n  a: {resource_function_id: nope}\n")
    with caplog.at_level(logging.WARNING):
        svc = load_service(path)
    assert svc.sf_list["a"].resource_function_id == "default"
    assert "nope" in caplog.text


@pytest.mark.parametrize("cls,name", [("FlowController", "duration"),
                                      ("DurationController", "per_flow")])
def test_conflicting_controller_spellings_raise(tmp_path, cls, name):
    """``controller_class`` and ``controller`` naming different
    controllers is refused, as the JAX package refuses it, whichever the
    port runs; the same controller in both spellings loads."""
    bad = _write(tmp_path / "bad.yaml", SIM_YAML + f"controller_class: "
                 f"{cls}\ncontroller: {name}\n")
    with pytest.raises(ValueError, match="conflicting"):
        j_load_sim(bad)
    with pytest.raises(ValueError, match="conflicting"):
        load_sim(bad)
    same = _write(tmp_path / "same.yaml", SIM_YAML + "controller_class: "
                  "DurationController\ncontroller: duration\n")
    assert load_sim(same).controller == j_load_sim(same).controller \
        == "duration"


@pytest.mark.parametrize("link_cap", [0, 3])
def test_force_caps_are_applied(tmp_path, link_cap):
    """``force_link_cap`` and ``force_node_cap`` reach the config and the
    networks a driver loads; a link cap of 0 is applied, not dropped."""
    path = _write(tmp_path / "sim.yaml", SIM_YAML
                  + f"force_link_cap: {link_cap}\nforce_node_cap: [2, 4]\n")
    cfg, jcfg = load_sim(path), j_load_sim(path)
    assert cfg.force_link_cap == jcfg.force_link_cap == float(link_cap)
    assert cfg.force_node_cap == jcfg.force_node_cap == (2.0, 4.0)
    net = _graphml("abilene", tmp_path)
    td = EpisodeDriver(SchedulerConfig((net,), net), cfg, abc_service(), 4,
                       base_seed=3)
    jd = JDriver(JSched((net,), net), jcfg, j_abc(), 4, base_seed=3)
    _assert_topology(jd.topology_for(0), td.topology_for(0))
    topo = td.topology_for(0)
    assert bool((topo.edge_cap[topo.edge_mask] == link_cap).all())
    caps = topo.node_cap[topo.node_mask]
    assert bool(((caps >= 2) & (caps < 4)).all())


@pytest.mark.parametrize("caps", ["force_link_cap: 0\n",
                                  "force_node_cap: [2, 4]\n"])
def test_force_caps_are_refused_on_a_builtin_network(tmp_path, caps):
    """Forced capacities apply where a GraphML network is read; ``train``
    and ``infer`` on a built-in ``--network``, and serving (whose network
    is a built-in one), refuse them instead of dropping them."""
    from gsc_tpu_torch import cli
    from gsc_tpu_torch.serve import run_serve

    path = _write(tmp_path / "sim.yaml", SIM_YAML + caps)
    sim = ["--device", "cpu", "--simulator-config", path]
    with pytest.raises(SystemExit, match="forced capacities"):
        cli.run_train([*sim, "--network", "abilene", "--episodes", "1"])
    with pytest.raises(SystemExit, match="forced capacities"):
        cli.run_infer([*sim, "--network", "claranet", "--checkpoint",
                       str(tmp_path / "none")])
    with pytest.raises(SystemExit, match="forced capacities"):
        cli.main(["serve", *sim, "--requests", "1"])
    with pytest.raises(ValueError, match="forced capacities"):
        run_serve(sim_cfg=load_sim(path), device="cpu", requests=1)
