"""The port's scenario registry, fault plans, traffic shapes and mixed
batches against the JAX package's (gsc_tpu/topology/scenarios.py),
mirroring tests/test_mixtopo.py:79-343.

- grammar: the same entries parse and the same ones are refused;
- registry topologies, fault tables (``edge_cap_t``, ``node_cap``),
  shape traces, ``plan_mix`` and ``mix_traffic_host``: byte-equal to the
  JAX package's (its numpy traffic path);
- a mixed batch [A, B, A, B] bit-equal, row for row, to homogeneous runs
  of A and B through the port's replica rollout, and a stacked [A, A]
  bit-equal to the shared topology;
- a dead link drops flows under LINK_CAP, its control none;
- engine intervals of a mixed batch with a link fault against the JAX
  engine run replica by replica on the same traffic: integers exact,
  floats rtol 1e-5 / atol 1e-5 (tests/test_torch_env.py's tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsc_tpu.config.catalog import abc_service as j_abc
from gsc_tpu.config.schema import EnvLimits as JLimits
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.sim.engine import SimEngine as JEngine
from gsc_tpu.sim.traffic import generate_traffic as j_traffic
from gsc_tpu.topology import DEFAULT_REGISTRY as J_REGISTRY
from gsc_tpu.topology import TopologyBucket as JBucket
from gsc_tpu.topology import build_mix_entries as j_build
from gsc_tpu.topology import parse_topo_faults as j_faults
from gsc_tpu.topology import plan_mix as j_plan
from gsc_tpu.topology.scenarios import TRAFFIC_SHAPES as J_SHAPES
from gsc_tpu.topology.scenarios import mix_traffic_host as j_mix_traffic
from gsc_tpu.topology.scenarios import shape_trace as j_shape_trace
from gsc_tpu.topology.synthetic import line as j_line

from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import AgentConfig, EnvLimits, SimConfig
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.parallel.dp import ParallelDDPG
from gsc_tpu_torch.sim.state import (DROP_LINK_CAP, TrafficSchedule,
                                     attach_edge_cap, stack_traffic)
from gsc_tpu_torch.sim.traffic import generate_traffic
from gsc_tpu_torch.topology.compiler import (Topology, TopologyBucket,
                                             compile_topology,
                                             stack_topologies)
from gsc_tpu_torch.topology.scenarios import (DEFAULT_REGISTRY,
                                              TRAFFIC_SHAPES,
                                              build_mix_entries,
                                              mix_traffic_host,
                                              parse_topo_faults, plan_mix,
                                              shape_trace, validate_mix)
from gsc_tpu_torch.topology.synthetic import line, triangle
from test_torch_env import _compare
import torch_port_helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

N = E = 8
SIM = dict(ttl_choices=(100.0,), max_flows=32)
AGENT = dict(episode_steps=2, gnn_features=4, gnn_num_layers=1,
             gnn_num_iter=1, actor_hidden_layer_nodes=(8,),
             critic_hidden_layer_nodes=(8,), batch_size=4, mem_limit=16,
             nb_steps_warmup_critic=2, objective="prio-flow",
             rand_sigma=0.0, rand_mu=0.0)


@pytest.fixture(autouse=True)
def numpy_traffic_path(monkeypatch):
    """Both packages' numpy traffic path (the plain path, byte-equal
    between them as the native one is)."""
    torch_port_helpers.numpy_traffic_path(monkeypatch)


def _bytes_equal(a, b, name):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    assert a.tobytes() == b.tobytes(), f"{name} differs"


def _topo_equal(jt, tt, what=""):
    for f in dataclasses.fields(Topology):
        _bytes_equal(getattr(jt, f.name), getattr(tt, f.name),
                     f"{what}{f.name}")


def _traffic_equal(js, ts, what=""):
    for f in TrafficSchedule._RANKS:
        _bytes_equal(getattr(js, f), getattr(ts, f), f"{what}{f}")
    assert (js.edge_cap_t is None) == (ts.edge_cap_t is None)
    if ts.edge_cap_t is not None:
        _bytes_equal(js.edge_cap_t, ts.edge_cap_t, f"{what}edge_cap_t")


GOOD = ["schedule,abilene,random12:7", "abilene+bursty",
        "abilene~link@3.2&node@5.0,random8:11", "triangle,line3",
        "star12~link@3.0", "ring10+flash_crowd~node@2", "line6+diurnal"]
BAD = ["", "nope_topology", "abilene+warp", "abilene~link@x",
       "abilene:notanint", "triangle~frob@1", "star8:1", "triangle:2",
       "claranet:1", "abilene~", "factory:warp", "factory:star,abilene"]


@pytest.mark.parametrize("mix", GOOD)
def test_mix_grammar_parses_as_jax(mix):
    got = [e if e == "schedule" else dataclasses.astuple(e)
           for e in validate_mix(mix)]
    want = [e if e == "schedule" else dataclasses.astuple(e)
            for e in J_REGISTRY.parse_mix(mix)]
    assert repr(got) == repr(want)


@pytest.mark.parametrize("mix", BAD)
def test_mix_grammar_refuses_as_jax(mix):
    from gsc_tpu.topology.scenarios import validate_mix as j_validate

    with pytest.raises(ValueError) as jerr:
        j_validate(mix)
    with pytest.raises(ValueError) as terr:
        validate_mix(mix)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("name, seed", [("random12", 7), ("abilene", 3),
                                        ("ring6", 0), ("star12", 0),
                                        ("line6", 0), ("bteurope", 1)])
def test_registry_topologies_byte_equal(name, seed):
    tt = TopologyBucket(24, 37).compile((name, seed),
                                        DEFAULT_REGISTRY.spec(name, seed))
    jt = JBucket(24, 37).compile((name, seed), J_REGISTRY.spec(name, seed))
    _topo_equal(jt, tt)


def test_bucket_memoizes_compiles_and_stacks():
    bucket = TopologyBucket(N, E)
    t1 = bucket.compile(("triangle", 0), triangle())
    assert bucket.compile(("triangle", 0), triangle()) is t1
    t2 = bucket.compile(("line3", 0), line(3), topo_id=1)
    s1 = bucket.stack([t1, t2, t1])
    assert bucket.stack([t1, t2, t1]) is s1
    assert s1.topo_id.tolist() == [0, 1, 0]
    with pytest.raises(ValueError, match="does not fit bucket"):
        bucket.compile(("ring64", 0), DEFAULT_REGISTRY.spec("ring64"))


@pytest.mark.parametrize("faults", ["link@1.0&node@2.1", "link@0.1",
                                    "node@3.2&node@1.0"])
def test_fault_tables_byte_equal(faults):
    """generate_traffic with a fault plan: node_cap rows and the
    edge_cap_t table (present iff a link fault) equal the JAX ones."""
    jt = j_compile_line()
    tt = compile_topology(line(3), max_nodes=N, max_edges=E)
    js = j_traffic(JSim(**SIM), j_abc(), jt, 4, seed=0,
                   faults=j_faults(faults))
    ts = generate_traffic(SimConfig(**SIM), abc_service(), tt, 4, seed=0,
                          faults=parse_topo_faults(faults))
    _traffic_equal(js, ts)


def j_compile_line():
    from gsc_tpu.topology.compiler import compile_topology as j_compile
    return j_compile(j_line(3), max_nodes=N, max_edges=E)


def test_fault_indices_must_name_real_elements():
    tt = compile_topology(line(3), max_nodes=N, max_edges=E)
    for spec in ("node@1.5", "link@1.3"):
        with pytest.raises(ValueError, match="out of range"):
            generate_traffic(SimConfig(**SIM), abc_service(), tt, 4, seed=0,
                             faults=parse_topo_faults(spec))
    with pytest.raises(ValueError, match="out of range"):
        build_mix_entries("line3~node@1.5", DEFAULT_REGISTRY,
                          TopologyBucket(N, E))
    plain = generate_traffic(SimConfig(**SIM), abc_service(), tt, 4, seed=0)
    assert plain.edge_cap_t is None and type(plain) is TrafficSchedule


@pytest.mark.parametrize("shape", sorted(TRAFFIC_SHAPES))
def test_traffic_shapes_equal_jax(shape):
    for steps in (8, 13):
        np.testing.assert_array_equal(TRAFFIC_SHAPES[shape][0](steps),
                                      J_SHAPES[shape][0](steps))
    assert TRAFFIC_SHAPES[shape][1] == J_SHAPES[shape][1]
    jt = JBucket(N, E).compile(("triangle", 0), J_REGISTRY.spec("triangle"))
    tt = TopologyBucket(N, E).compile(("triangle", 0),
                                      DEFAULT_REGISTRY.spec("triangle"))
    assert shape_trace(shape, SimConfig(**SIM), tt, 8).rows == \
        j_shape_trace(shape, JSim(**SIM), jt, 8).rows


@pytest.mark.parametrize("mix, replicas", [
    ("triangle,line3~link@1.0", 4),
    ("triangle+bursty,line3~node@1.1,ring5:0", 5),
    ("schedule,ring5+flash_crowd,line4~link@0.2", 6)])
def test_plan_and_host_mix_traffic_equal_jax(mix, replicas):
    """plan_mix (assignment, names, counts, gather index, capacity, the
    stacked topology) and mix_traffic_host's [B] schedules, byte-equal."""
    jb, tb = JBucket(N, E), TopologyBucket(N, E)
    sched_j = [jb.compile(("tri", 0), J_REGISTRY.spec("triangle"))]
    sched_t = [tb.compile(("tri", 0), DEFAULT_REGISTRY.spec("triangle"))]
    jplan = j_plan(j_build(mix, J_REGISTRY, jb, schedule_topos=sched_j),
                   replicas, jb, JSim(**SIM), 3)
    tplan = plan_mix(build_mix_entries(mix, DEFAULT_REGISTRY, tb,
                                       schedule_topos=sched_t),
                     replicas, tb, SimConfig(**SIM), 3)
    for f in ("assignment", "counts", "inv"):
        np.testing.assert_array_equal(getattr(tplan, f), getattr(jplan, f))
    assert (tplan.names, tplan.capacity, tplan.has_link_faults) == \
        (jplan.names, jplan.capacity, jplan.has_link_faults)
    _topo_equal(jplan.topo, tplan.topo)
    js = j_mix_traffic(jplan, JSim(**SIM), j_abc(), 3,
                       seed_for=lambda r: 7 + r)
    ts = mix_traffic_host(tplan, SimConfig(**SIM), abc_service(), 3,
                          seed_for=lambda r: 7 + r)
    _traffic_equal(js, ts)


def test_plan_refuses_fewer_replicas_than_entries():
    bucket = TopologyBucket(N, E)
    entries = build_mix_entries("triangle,line3,ring5", DEFAULT_REGISTRY,
                                bucket)
    with pytest.raises(ValueError, match="round-robin"):
        plan_mix(entries, 2, bucket, SimConfig(**SIM), 2)


# ------------------------------------------------------ row independence
def _rollout(topo, traffic, batch):
    service = abc_service()
    limits = EnvLimits.for_service(service, max_nodes=N, max_edges=E)
    env = ServiceCoordEnv(service, SimConfig(**SIM), AgentConfig(**AGENT),
                          limits)
    pddpg = ParallelDDPG(env, env.agent, batch, device="cpu")
    env_states, obs = pddpg.reset_all(topo, traffic)
    state = pddpg.init(torch.Generator().manual_seed(1))
    buffers = pddpg.init_buffers(obs.map(lambda x: x[0]))
    # far past the warm-up: the deterministic policy (no noise)
    state, buffers, env_states, obs, stats = pddpg.rollout_episodes(
        state, buffers, env_states, obs, topo, traffic, 10 ** 6, 2)
    return buffers, obs, stats


def test_mixed_batch_bit_equals_homogeneous_runs():
    """[A, B, A, B] == homogeneous B=2 runs of A and B row for row:
    replay rows (the stored topo_idx too), final obs, per-replica
    returns."""
    tA = compile_topology(triangle(), max_nodes=N, max_edges=E, topo_id=0)
    tB = compile_topology(line(4), max_nodes=N, max_edges=E, topo_id=1)
    cfg = SimConfig(**SIM)
    tr = lambda t, s: generate_traffic(cfg, abc_service(), t, 2, seed=s,
                                       capacity=128)
    mbuf, mobs, mstats = _rollout(
        stack_topologies([tA, tB, tA, tB]),
        stack_traffic([tr(tA, 0), tr(tB, 10), tr(tA, 1), tr(tB, 11)]), 4)
    for topo, seeds, rows in ((tA, (0, 1), [0, 2]), (tB, (10, 11), [1, 3])):
        hbuf, hobs, hstats = _rollout(
            stack_topologies([topo, topo]),
            stack_traffic([tr(topo, s) for s in seeds]), 2)
        for k, v in hbuf.data.items():
            assert torch.equal(mbuf.data[k][rows, :2], v[:, :2]), k
        for k in ("nodes", "node_mask", "edge_index", "edge_mask", "mask"):
            assert torch.equal(getattr(mobs, k)[rows], getattr(hobs, k)), k
        assert torch.equal(mstats["per_replica_return"][rows],
                           hstats["per_replica_return"])
    assert mbuf.data["topo_idx"][:, 0].tolist() == [0, 1, 0, 1]


def test_stacked_topology_bit_equals_shared():
    tA = compile_topology(triangle(), max_nodes=N, max_edges=E)
    traffic = stack_traffic([generate_traffic(SimConfig(**SIM),
                                              abc_service(), tA, 2, seed=s)
                             for s in (0, 1)])
    pbuf, pobs, pstats = _rollout(stack_topologies([tA, tA]), traffic, 2)
    ubuf, uobs, ustats = _rollout(tA, traffic, 2)
    for k, v in ubuf.data.items():
        assert torch.equal(pbuf.data[k], v), k
    assert torch.equal(pstats["per_replica_return"],
                       ustats["per_replica_return"])


# ---------------------------------------------------------- engine intervals
def test_link_fault_drops_flows_with_linkcap_taxonomy():
    """A dead link on line3's ingress-adjacent edge from interval 0: no
    flow is processed and the drops are LINK_CAP; the control processes
    traffic and drops none for links."""
    service = abc_service()
    limits = EnvLimits.for_service(service, max_nodes=N, max_edges=E)
    from gsc_tpu_torch.sim.engine import SimEngine
    engine = SimEngine(service, SimConfig(**SIM), limits)
    topo = compile_topology(line(3, num_ingress=1), max_nodes=N, max_edges=E)
    nm = topo.node_mask.numpy()
    sched = np.zeros((1,) + limits.scheduling_shape, np.float32)
    sched[..., 1] = 1.0        # every flow crosses edge 0
    place = torch.from_numpy(np.broadcast_to(
        nm[:, None], (1, N, limits.sf_pool)).copy())

    def run(faults):
        tr = generate_traffic(engine.cfg, service, topo, 4, seed=0,
                              faults=faults)
        st = engine.init(1, "cpu")
        for _ in range(4):
            st, m = engine.apply(st, topo, tr, torch.from_numpy(sched),
                                 place)
        return m

    ok, dead = run(()), run(parse_topo_faults("link@0.0"))
    assert int(ok.processed[0]) > 0
    assert int(ok.drop_reasons[0, DROP_LINK_CAP]) == 0
    assert int(dead.processed[0]) == 0
    assert int(dead.drop_reasons[0, DROP_LINK_CAP]) > 0


def test_mixed_batch_engine_matches_jax():
    """Three intervals of a mixed batch (triangle, a line with link 0
    dead from interval 1, ring5) through the port's engine at once and
    through the JAX engine replica by replica, on the same host traffic
    and seeded schedules: every state equal (integers exact, floats
    rtol 1e-5 / atol 1e-5)."""
    mix, b, steps = "triangle,line3~link@1.0,ring5", 3, 3
    jb, tb = JBucket(N, E), TopologyBucket(N, E)
    jplan = j_plan(j_build(mix, J_REGISTRY, jb), b, jb, JSim(**SIM), steps)
    tplan = plan_mix(build_mix_entries(mix, DEFAULT_REGISTRY, tb), b, tb,
                     SimConfig(**SIM), steps)
    js = j_mix_traffic(jplan, JSim(**SIM), j_abc(), steps,
                       seed_for=lambda r: 3 + r)
    ts = mix_traffic_host(tplan, SimConfig(**SIM), abc_service(), steps,
                          seed_for=lambda r: 3 + r)
    service = abc_service()
    limits = EnvLimits.for_service(service, max_nodes=N, max_edges=E)
    from gsc_tpu_torch.sim.engine import SimEngine
    from gsc_tpu_torch.sim.cases import _seeded_tables
    engine = SimEngine(service, SimConfig(**SIM), limits)
    jeng = JEngine(j_abc(), JSim(**SIM),
                   JLimits(**dataclasses.asdict(limits)))
    sched, place = _seeded_tables(limits, tplan.topo.node_mask.numpy(), b,
                                  seed=4)
    tstate = engine.init(b, "cpu")
    pick = lambda tree, r: jax.tree_util.tree_map(lambda x: x[r], tree)
    jstates = [jeng.init(jax.random.PRNGKey(0), pick(jplan.topo, r))
               for r in range(b)]
    for i in range(steps):
        tstate, _ = engine.apply(tstate, tplan.topo, ts,
                                 torch.from_numpy(sched),
                                 torch.from_numpy(place))
        for r in range(b):
            jstates[r], _ = jeng.apply(
                jstates[r], pick(jplan.topo, r), pick(js, r),
                jnp.asarray(sched[r]), jnp.asarray(place[r]))
            one = tstate.map(lambda x: x[r:r + 1])
            for f in ("flows", "metrics", "t", "cursor", "node_load",
                      "edge_used", "rel_node", "rel_edge"):
                _compare(getattr(jstates[r], f), getattr(one, f),
                         f"interval{i}.replica{r}.{f}")
    # the dead link of replica 1 dropped flows for link capacity
    assert int(tstate.metrics.drop_reasons[1, DROP_LINK_CAP]) > 0
    assert isinstance(attach_edge_cap(ts, ts.edge_cap_t), type(ts))
