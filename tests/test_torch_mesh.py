"""The port's mesh grammar and partition rule books against the JAX
package, with no rank spawned.

- ``gsc_tpu_torch.meshspec`` gives ``gsc_tpu.meshspec``'s results and
  error texts over a list of specs;
- for the flagship agent and the factored heads, each book's plan
  (``sharded``, ``tp``, ``replicated``, clamped on 1x1, 2x2, 1x4, 1x8
  and 8x1) matches, leaf for leaf, JAX's ``match_partition_rules`` +
  ``clamp_specs_to_mesh`` on the flax trees (conftest's 8 virtual
  devices), each flax leaf mapped to the port's name and layout through
  ``utils/convert.py``'s ``_map_leaf`` (a transposed kernel's spec
  reversed); the Polyak targets and both Adam moments carry their
  parameter's spec;
- the rule-matching and clamping cases of ``tests/test_multichip.py`` on
  the same names and shapes, ``spec_summary`` on the same specs,
  ``ring_shard_rows`` and ``actor_shard_assignment`` are equal;
- the ``local`` sampler's replica layout on a buffer that encodes
  (replica, slot) matches ``gsc_tpu.parallel.dp``'s ``_sample_local``;
- ``ParallelDDPG`` refuses 6 replicas on 4 ranks ("divisible") and the
  ``tp`` book.

Everything is exact: these are tables and index layouts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import gsc_tpu.meshspec as jspec
from gsc_tpu.config.schema import AgentConfig as JAgent
from gsc_tpu.models.nets import Actor as JActor
from gsc_tpu.models.nets import QNetwork as JQ
from gsc_tpu.parallel import partition as jpart

from gsc_tpu_torch import meshspec
from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import AgentConfig, EnvLimits, SimConfig
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.models.nets import Actor, QNetwork
from gsc_tpu_torch.parallel import partition
from gsc_tpu_torch.parallel.dp import ParallelDDPG
from gsc_tpu_torch.parallel.mesh import Mesh
from gsc_tpu_torch.utils.convert import _map_leaf
from torch_port_helpers import one_torch_thread  # noqa: F401

SPECS = ["8x1", "4X2", "3", " 2x4 ", "1x1", "0x2", "2x0", "2x", "ax1", "",
         "2x2x2", "-1", "x2", "16x1", 8, "04x02"]
MESHES = ["1x1", "2x2", "1x4", "1x8", "8x1"]
BOOKS = ["sharded", "tp", "replicated"]
FLAGSHIP = dict(graph_mode=True, episode_steps=200, objective="prio-flow",
                gnn_features=22, gnn_num_layers=2, gnn_num_iter=2,
                gnn_aggr="mean", actor_hidden_layer_nodes=(256,),
                critic_hidden_layer_nodes=(64,))
FACTORED = dict(gnn_features=6, gnn_num_layers=2, gnn_num_iter=2,
                actor_hidden_layer_nodes=(8,), critic_hidden_layer_nodes=(8,),
                factored_head=True, factored_key_dim=4)


def _outcome(fn, arg):
    try:
        return ("ok", fn(arg))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_mesh_grammar_matches_jax(spec):
    for name in ("parse_mesh_shape", "canonical_mesh"):
        assert _outcome(getattr(meshspec, name), spec) == \
            _outcome(getattr(jspec, name), spec), name


@pytest.mark.parametrize("book", ["replicated", "sharded", "tp", " tp ",
                                  "zigzag", "Sharded", ""])
def test_rulebook_names_match_jax(book):
    assert meshspec.PARTITION_RULEBOOKS == jspec.PARTITION_RULEBOOKS
    assert _outcome(meshspec.validate_partition_rules, book) == \
        _outcome(jspec.validate_partition_rules, book)
    assert tuple(partition.NAMED_RULEBOOKS) == tuple(jpart.NAMED_RULEBOOKS)


# ------------------------------------------------------- the rule books
def _flax_trees(kw, n, e):
    """(actor params, critic params) of the flax networks as shape trees
    (``jax.eval_shape``: no compute), and the port's networks."""
    service = abc_service()
    lim = EnvLimits.for_service(service, max_nodes=n, max_edges=e)
    jagent, tagent = JAgent(**kw), AgentConfig(**kw)
    a_dim, sched = lim.action_dim, lim.scheduling_shape
    from gsc_tpu.env.observations import GraphObs as JObs
    obs = JObs(nodes=jnp.zeros((1, n, 3)),
               node_mask=jnp.ones((1, n), bool),
               edge_index=jnp.zeros((1, 2, 2 * e), jnp.int32),
               edge_mask=jnp.ones((1, 2 * e), bool),
               mask=jnp.ones((1, a_dim)))
    jactor = JActor(agent=jagent, action_dim=a_dim, sched_shape=sched)
    jq = JQ(agent=jagent, action_dim=a_dim, sched_shape=sched)
    key = jax.random.PRNGKey(0)
    ap = jax.eval_shape(jactor.init, key, obs)["params"]
    qp = jax.eval_shape(jq.init, key, obs, jnp.zeros((1, a_dim)))["params"]
    return ap, qp, (Actor(tagent, a_dim, sched_shape=sched),
                    QNetwork(tagent, a_dim, sched_shape=sched))


def _port_spec(jspec_, transpose: bool, flax_rank: int):
    """A flax leaf's spec in the port's layout: a transposed kernel's
    entries reversed, a flax ``att [F, 1]`` (the port's ``att [F]``) whose
    spec must be replicated."""
    spec = tuple(jspec_)
    if not spec:
        return ()
    spec = spec + (None,) * (flax_rank - len(spec))
    return tuple(reversed(spec)) if transpose else spec


@pytest.mark.parametrize("nets", ["flagship", "factored"])
@pytest.mark.parametrize("book", BOOKS)
def test_rulebook_plans_match_jax_leaf_for_leaf(nets, book):
    kw, n, e = (FLAGSHIP, 24, 37) if nets == "flagship" else (FACTORED, 16,
                                                              32)
    ap, qp, (actor, critic) = _flax_trees(kw, n, e)
    shapes = partition.learner_state_shapes(actor, critic)
    checked = 0
    for mesh in MESHES:
        dp, mp = meshspec.parse_mesh_shape(mesh)
        jmesh = jpart.make_train_mesh(dp, mp)
        plan = partition.ShardingPlan(Mesh.layout(dp, mp), book)
        got = plan.specs(shapes)
        for part, tree in (("actor", ap), ("critic", qp)):
            specs = jpart.match_partition_rules(
                jpart.NAMED_RULEBOOKS[book](), tree)
            specs, _ = jpart.clamp_specs_to_mesh(specs, tree, jmesh)
            flat, _ = jax.tree_util.tree_flatten_with_path(tree)
            jflat = jax.tree_util.tree_leaves(
                specs, is_leaf=lambda x: isinstance(x, P))
            for (path, leaf), js in zip(flat, jflat):
                names = tuple(getattr(k, "key", str(k)) for k in path)
                mod, key, transpose = _map_leaf(names)
                want = _port_spec(js, transpose, len(leaf.shape))
                for where in (part, f"target_{part}",
                              f"{part}_opt/exp_avg", f"{part}_opt/exp_avg_sq"):
                    assert got[f"{where}/{key}"] == want, (mesh, where, key)
                assert got[f"{part}_opt/step/{key}"] == ()
                checked += 1
    assert checked > 0
    if book == "replicated":
        assert all(s == () for s in got.values())


def _small_tree():
    """test_multichip's rule-matching tree, as names and shapes."""
    return {"actor/MLP_0/kernel": (4, 8), "actor/MLP_0/bias": (8,),
            "gnn/w_l": (4, 8), "gnn/att": (8, 1), "step": ()}


def test_rule_matching_and_clamping_match_jax():
    """The JAX books and the port's matcher and clamp on the same names
    and shapes give the same specs, clamp counts and summaries."""
    sds = lambda s: jax.ShapeDtypeStruct(s, jnp.float32)
    tree = _small_tree()
    jtree = {k: sds(s) for k, s in tree.items()}
    for book in BOOKS:
        rules = jpart.NAMED_RULEBOOKS[book]()
        port_rules = [(r, tuple(s)) for r, s in rules]
        for mesh in ("4x2", "1x8", "8x1"):
            dp, mp = meshspec.parse_mesh_shape(mesh)
            js = jpart.match_partition_rules(rules, jtree)
            js, jn = jpart.clamp_specs_to_mesh(js, jtree,
                                               jpart.make_train_mesh(dp, mp))
            ps = partition.match_partition_rules(port_rules, tree)
            ps, pn = partition.clamp_specs_to_mesh(ps, tree,
                                                   Mesh.layout(dp, mp))
            assert {k: tuple(v) for k, v in js.items()} == ps, (book, mesh)
            assert jn == pn
            assert partition.spec_summary(ps) == jpart.spec_summary(js)
    with pytest.raises(ValueError, match="no partition rule"):
        partition.match_partition_rules([(r"kernel$", ("mp", None))],
                                        {"other": (2, 2)})
    with pytest.raises(ValueError, match="no partition rule"):
        jpart.match_partition_rules(((r"kernel$", P(None, "mp")),),
                                    {"other": jnp.zeros((2, 2))})


def test_clamp_of_indivisible_widths_matches_jax():
    tree = {"wide/kernel": (4, 8), "narrow/kernel": (4, 7), "vec/kernel": (6,)}
    jtree = {k: jnp.zeros(s) for k, s in tree.items()}
    js = jpart.match_partition_rules(jpart.sharded_rules(), jtree)
    js, jn = jpart.clamp_specs_to_mesh(js, jtree, jpart.make_train_mesh(4, 2))
    rules = [(r, tuple(s)) for r, s in jpart.sharded_rules()]
    ps, pn = partition.clamp_specs_to_mesh(
        partition.match_partition_rules(rules, tree), tree,
        Mesh.layout(4, 2))
    assert {k: tuple(v) for k, v in js.items()} == ps
    assert jn == pn == 2
    assert partition.spec_summary(ps) == jpart.spec_summary(js) == {
        "PartitionSpec()": 2, "PartitionSpec(None, 'mp')": 1}


@pytest.mark.parametrize("b,n", [(8, 1), (8, 2), (8, 4), (64, 8), (6, 4),
                                 (6, 0), (12, 3)])
def test_ring_shard_rows_matches_jax(b, n):
    assert _outcome(lambda a: partition.ring_shard_rows(*a), (b, n)) == \
        _outcome(lambda a: jpart.ring_shard_rows(*a), (b, n))


@pytest.mark.parametrize("a,n", [(1, 1), (4, 2), (5, 3), (3, 0), (0, 2)])
def test_actor_shard_assignment_matches_jax(a, n):
    assert partition.actor_shard_assignment(a, n) == \
        jpart.actor_shard_assignment(a, n)


def test_plan_predicates():
    assert not partition.ShardingPlan.from_spec("4x2",
                                                "replicated").is_sharded
    assert partition.ShardingPlan.from_spec("4x2", "sharded").is_sharded
    assert not partition.ShardingPlan.from_spec("8x1", "sharded").is_sharded
    assert partition.ShardingPlan.from_spec("2x2", "tp").resident_sharded
    with pytest.raises(ValueError, match="unknown rulebook"):
        partition.ShardingPlan.from_spec("4x2", "zigzag")
    plan = partition.ShardingPlan.from_spec("2X4")
    assert (plan.describe(), plan.n_devices) == ("2x4", 8)


# ------------------------------------------------------------ samplers
def _port_env(batch, b):
    agent = AgentConfig(graph_mode=True, episode_steps=2, batch_size=batch,
                        mem_limit=b * 4)
    service = abc_service()
    lim = EnvLimits.for_service(service, max_nodes=8, max_edges=8)
    return ServiceCoordEnv(service, SimConfig(max_flows=32), agent, lim), \
        agent


@pytest.mark.parametrize("batch,b", [(10, 4), (3, 4), (16, 8)])
def test_local_sampler_layout_matches_jax(batch, b):
    """A buffer whose one leaf encodes (replica, slot) as replica * 1000 +
    slot: the port's shard-local batch takes the replicas in the order
    and counts ``_sample_local`` does, each slot among the filled ones."""
    from gsc_tpu.agents.buffer import ReplayBuffer as JBuffer
    from gsc_tpu.parallel.dp import ParallelDDPG as JParallel

    from gsc_tpu_torch.agents.buffer import ReplayBuffer

    cap, filled = 4, 3
    code = (np.arange(b)[:, None] * 1000 + np.arange(cap)[None, :]).astype(
        np.float32)
    size = np.full(b, filled, np.int32)
    jb = JBuffer(data={"x": jnp.asarray(code)}, pos=jnp.asarray(size),
                 size=jnp.asarray(size), shapes=None)
    jself = JParallel.__new__(JParallel)
    jself.agent, jself.B = JAgent(batch_size=batch), b
    want = np.asarray(JParallel._sample_local(jself, jb,
                                              jax.random.PRNGKey(3))["x"])
    env, agent = _port_env(batch, b)
    pddpg = ParallelDDPG(env, agent, b, device="cpu", sample_mode="local")
    tb = ReplayBuffer(data={"x": torch.from_numpy(code)},
                      pos=torch.from_numpy(size), size=torch.from_numpy(size),
                      shapes={"x": None})
    got = pddpg.sample_local(tb)["x"].numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got // 1000, want // 1000)
    assert ((got % 1000) < filled).all() and ((want % 1000) < filled).all()


def test_parallel_ddpg_refusals():
    env, agent = _port_env(4, 6)
    with pytest.raises(ValueError, match="divisible"):
        ParallelDDPG(env, agent, 6, device="cpu",
                     plan=partition.ShardingPlan.from_spec("2x2"))
    with pytest.raises(ValueError, match="next slice"):
        ParallelDDPG(env, agent, 8, device="cpu",
                     plan=partition.ShardingPlan.from_spec("2x2", "tp"))
    with pytest.raises(ValueError, match="unknown sample_mode"):
        ParallelDDPG(env, agent, 4, device="cpu", sample_mode="zigzag")


def test_residency_slices_on_a_layout_mesh():
    """Each mp index's slice of a learner state's split leaves (dim 0 of
    a torch weight), and the whole leaf back from the slices."""
    env, agent = _port_env(4, 4)
    pddpg = ParallelDDPG(env, agent, 4, device="cpu")
    state = pddpg.init(torch.Generator().manual_seed(0))
    full = {k: v.detach().clone()
            for k, v in partition.state_leaves(state).items()}
    for mp in (2, 4):
        plan = partition.ShardingPlan(Mesh.layout(1, mp), "sharded")
        specs = plan.specs(full)
        split = [k for k, s in specs.items() if s == ("mp", None)]
        assert split and all(k.endswith(".weight") for k in split)
        for k in split:
            parts = [partition.shard_leaf(full[k], specs[k],
                                          Mesh.layout(1, mp, rank=j))
                     for j in range(mp)]
            assert torch.equal(torch.cat(parts), full[k])
            assert parts[0].shape[0] * mp == full[k].shape[0]
