"""The port's GNNEmbedder, Actor and greedy policy against the JAX
package's, with the flax parameters carried across by
``actor_params_from_jax``.

Both sides run ``gnn_impl="pallas"``: the JAX Actor reaches the Pallas
kernel in interpret mode, the port's (CPU tensors) the kernel's plain
version.  Inputs are numpy-seeded graph observations on Abilene's padded
24-node / 37-edge graph, at a small width (hidden 8, actor (16,)) and at
the flagship width (hidden 22, actor (256,), action dim 1728).

Tolerances: embeddings and actor outputs rtol 1e-5, atol 1e-5 (f32 with
another summation order).  ``greedy_action`` thresholds at 0.1 and
renormalises twice: an entry counts as ambiguous when the JAX side's value
before either threshold lies within 1e-5 of 0.1; every destination row
without an ambiguous entry must zero exactly the same entries on both
sides, and its values agree within rtol 1e-5, atol 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from gsc_tpu.agents.ddpg import DDPG as JDDPG
from gsc_tpu.config.catalog import abc_service as j_abc
from gsc_tpu.config.schema import AgentConfig as JAgent
from gsc_tpu.config.schema import EnvLimits as JLimits
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.env.env import ServiceCoordEnv as JEnv
from gsc_tpu.env.observations import GraphObs as JObs
from gsc_tpu.models.gnn import GNNEmbedder as JEmbedder
from gsc_tpu.models.nets import Actor as JActor
from gsc_tpu.topology import synthetic as jsyn
from gsc_tpu.topology.compiler import compile_topology as j_compile

from gsc_tpu_torch.agents.ddpg import DDPG
from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import AgentConfig, EnvLimits, SimConfig
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.env.observations import GraphObs
from gsc_tpu_torch.models.nets import Actor
from gsc_tpu_torch.utils.convert import actor_params_from_jax
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-5
THRESH_TOL = 1e-5
WIDTHS = {"small": dict(gnn_features=8, actor_hidden_layer_nodes=(16,)),
          "flagship": dict(gnn_features=22, actor_hidden_layer_nodes=(256,))}


def make_obs(batch, seed=0):
    """Numpy-seeded observations on Abilene's padded graph: random node
    features on real nodes, the real directed edge list and action mask."""
    topo = j_compile(jsyn.abilene())
    ei, em = topo.directed_edge_index()
    nm = np.asarray(topo.node_mask)
    from gsc_tpu.env.actions import action_mask
    mask = np.asarray(action_mask(topo.node_mask, 1, 3))
    rng = np.random.default_rng(seed)
    nodes = rng.uniform(size=(batch, 24, 3)).astype(np.float32) * nm[:, None]
    rep = lambda x: np.broadcast_to(np.asarray(x), (batch,) + np.shape(x)).copy()
    return dict(nodes=nodes, node_mask=rep(nm), edge_index=rep(ei),
                edge_mask=rep(em), mask=rep(mask))


def _jobs(o):
    return JObs(**o)


def _tobs(o):
    return GraphObs(**{k: torch.from_numpy(v) for k, v in o.items()})


def _actors(width):
    kw = dict(WIDTHS[width], gnn_impl="pallas")
    jagent, tagent = JAgent(**kw), AgentConfig(**kw)
    a_dim = 24 * 1 * 3 * 24
    jactor = JActor(agent=jagent, action_dim=a_dim, gnn_impl="pallas")
    obs = make_obs(2)
    params = jactor.init(jax.random.PRNGKey(1), _jobs(obs))
    tactor = Actor(tagent, a_dim, gnn_impl="pallas")
    tactor.load_state_dict(actor_params_from_jax(jax.device_get(params),
                                                 tactor))
    return jagent, tagent, jactor, params, tactor


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_embedder_and_actor_match_jax(width):
    jagent, _, jactor, params, tactor = _actors(width)
    obs = make_obs(3, seed=5)
    emb_j = JEmbedder(hidden=jagent.gnn_features, num_layers=2, num_iter=2,
                      impl="pallas").apply(
        {"params": params["params"]["GNNEmbedder_0"]}, obs["nodes"],
        obs["edge_index"], obs["edge_mask"], obs["node_mask"])
    t = _tobs(obs)
    with torch.no_grad():
        emb_t = tactor.embedder(t.nodes, t.edge_index, t.edge_mask,
                                t.node_mask)
        out_t = tactor(t).numpy()
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), rtol=RTOL,
                               atol=ATOL)
    out_j = np.asarray(jactor.apply(params, _jobs(obs)))
    assert out_t.shape == out_j.shape == (3, 1728)
    np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=ATOL)
    # masked (padded src/dst) entries are exactly zero
    assert np.all(out_t[obs["mask"] == 0] == 0.0)
    # weight tying: one encoder and one process conv, shared across iters
    convs = {k.split(".")[1] for k in tactor.state_dict()
             if k.startswith("embedder.")}
    assert convs == {"encoder", "process"}
    assert len(tactor.embedder.process) == 1


def _ambiguous_rows(pre, n_dst=24, thr=0.1):
    """Rows whose JAX value before the first or second threshold lies
    within THRESH_TOL of the threshold."""
    rows = np.clip(pre, 0.0, 1.0).reshape(pre.shape[:-1] + (-1, n_dst))
    amb = np.zeros(rows.shape[:-1], bool)
    for _ in range(2):
        amb |= (np.abs(rows - thr) < THRESH_TOL).any(-1)
        kept = np.where(rows >= thr, rows, 0.0)
        total = kept.sum(-1, keepdims=True)
        rows = np.where(total > 0, kept / np.maximum(total, 1e-30), 1.0 / n_dst)
    return amb


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_greedy_action_matches_jax(width):
    jagent, tagent, jactor, params, tactor = _actors(width)
    jl = JLimits.for_service(j_abc())
    jenv = JEnv(j_abc(), JSim(), jagent, jl)
    jddpg = JDDPG(jenv, jagent, gnn_impl="pallas")
    tenv = ServiceCoordEnv(abc_service(), SimConfig(), tagent,
                           EnvLimits.for_service(abc_service()))
    tddpg = DDPG(tenv, tagent, device="cpu")
    tddpg.actor = tactor
    obs = make_obs(4, seed=9)
    got = tddpg.greedy_action(_tobs(obs)).numpy()
    want = np.asarray(jax.vmap(jddpg.greedy_action, in_axes=(None, 0))(
        params, _jobs(obs)))
    pre = np.asarray(jactor.apply(params, _jobs(obs)))
    amb = _ambiguous_rows(pre)
    g = got.reshape(4, -1, 24)[~amb]
    w = want.reshape(4, -1, 24)[~amb]
    assert g.shape[0] > 0.9 * amb.size
    np.testing.assert_array_equal(g == 0, w == 0)
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    # the post-processing invariant: every destination row sums to 1
    np.testing.assert_allclose(got.reshape(4, -1, 24).sum(-1), 1.0,
                               rtol=1e-5)


def test_converter_raises_on_unused_and_missing_leaves():
    _, tagent, _, params, tactor = _actors("small")
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    extra = {"params": dict(tree["params"], Stray_0={"kernel": np.zeros(3)})}
    with pytest.raises(ValueError, match="unused"):
        actor_params_from_jax(extra, tactor)
    missing = {"params": {k: dict(v) for k, v in tree["params"].items()}}
    enc = dict(missing["params"]["GNNEmbedder_0"]["encoder"])
    del enc["att"]
    missing["params"]["GNNEmbedder_0"] = dict(
        missing["params"]["GNNEmbedder_0"], encoder=enc)
    with pytest.raises(ValueError, match="lacks"):
        actor_params_from_jax(missing, tactor)
    # a layer the port's Actor does not have is refused as well
    deeper = Actor(AgentConfig(gnn_features=8,
                               actor_hidden_layer_nodes=(16, 16)), 1728)
    with pytest.raises(ValueError):
        actor_params_from_jax(tree, deeper)
