"""The port's ``shuffle_nodes`` protocol against the JAX package's
permutation ops (gsc_tpu/env/permutation.py), mirroring
tests/test_permutation.py: every op with the same permutation passed in
from outside (drawn with numpy), unbatched and per replica, and the
shuffled rollout and training on both trainers.  Tolerance: none — the
ops move values, so every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsc_tpu.env.observations import GraphObs as JObs
from gsc_tpu.env.permutation import (inverse_permutation as j_inverse,
                                     permute_flat_obs as j_flat,
                                     permute_graph_obs as j_graph,
                                     reverse_action_permutation as j_reverse)

from gsc_tpu_torch.config.schema import AgentConfig, EnvLimits
from gsc_tpu_torch.env.observations import GraphObs
from gsc_tpu_torch.env.permutation import (ShuffleOps, inverse_permutation,
                                           permute_flat_obs,
                                           permute_graph_obs,
                                           random_permutation,
                                           reverse_action_permutation)
from torch_port_helpers import one_torch_thread  # noqa: F401

N, C, S = 6, 1, 2
SHAPE = (N, C, S, N)


def _perm(seed, batch=None):
    rng = np.random.default_rng(seed)
    if batch is None:
        return rng.permutation(N)
    return np.stack([rng.permutation(N) for _ in range(batch)])


def _graph_obs(seed, batch=None):
    """A seeded graph observation (edges over real nodes, a float mask so
    every entry is told apart)."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return dict(
        nodes=rng.uniform(size=lead + (N, 3)).astype(np.float32),
        node_mask=rng.uniform(size=lead + (N,)) < 0.8,
        edge_index=rng.integers(0, N, size=lead + (2, 7)).astype(np.int32),
        edge_mask=rng.uniform(size=lead + (7,)) < 0.9,
        mask=rng.uniform(size=lead + (N * C * S * N,)).astype(np.float32))


def test_perm_inverse_composition():
    perm = random_permutation(torch.Generator().manual_seed(0), N)
    assert sorted(perm.tolist()) == list(range(N))
    inv = inverse_permutation(perm)
    assert torch.equal(perm[inv], torch.arange(N))
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(j_inverse(jnp.asarray(perm.numpy()))))


@pytest.mark.parametrize("batch", [None, 3])
def test_flat_obs_matches_jax(batch):
    lead = () if batch is None else (batch,)
    obs = np.random.default_rng(1).uniform(size=lead + (3 * N,)).astype(
        np.float32)
    perm = _perm(2, batch)
    got = permute_flat_obs(torch.from_numpy(obs), torch.from_numpy(perm))
    rows = [j_flat(jnp.asarray(o), jnp.asarray(p)) for o, p in
            (zip(obs, perm) if batch else [(obs, perm)])]
    want = np.stack(rows) if batch else np.asarray(rows[0])
    np.testing.assert_array_equal(got.numpy(), want)
    back = permute_flat_obs(got, inverse_permutation(torch.from_numpy(perm)))
    np.testing.assert_array_equal(back.numpy(), obs)


@pytest.mark.parametrize("batch", [None, 3])
def test_action_roundtrip_matches_jax(batch):
    """An action in the permuted frame maps back to the simulator's frame
    as the JAX package maps it, and a permuted action reverses to the
    original (the reference's test_permutations.py property)."""
    lead = () if batch is None else (batch,)
    a = np.random.default_rng(3).uniform(size=lead + (N * C * S * N,))
    a = a.astype(np.float32)
    perm = _perm(4, batch)
    got = reverse_action_permutation(torch.from_numpy(a),
                                     torch.from_numpy(perm), SHAPE)
    pairs = zip(a, perm) if batch else [(a, perm)]
    want = [np.asarray(j_reverse(jnp.asarray(x), jnp.asarray(p), SHAPE))
            for x, p in pairs]
    np.testing.assert_array_equal(got.numpy(),
                                  np.stack(want) if batch else want[0])
    for r in range(batch or 1):
        p = perm[r] if batch else perm
        x = a[r] if batch else a
        a_perm = x.reshape(SHAPE)[p][..., p].reshape(-1)
        back = reverse_action_permutation(torch.from_numpy(a_perm),
                                          torch.from_numpy(p), SHAPE)
        np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("batch", [None, 3])
def test_graph_obs_matches_jax(batch):
    """Node rows, node mask, relabelled edges and the action mask permuted
    on both node axes, as the JAX package permutes them."""
    obs = _graph_obs(5, batch)
    perm = _perm(6, batch)
    got = permute_graph_obs(GraphObs(**{k: torch.from_numpy(v)
                                        for k, v in obs.items()}),
                            torch.from_numpy(perm), C, S)
    for r in range(batch or 1):
        pick = (lambda v: v[r]) if batch else (lambda v: v)
        want = j_graph(JObs(**{k: jnp.asarray(pick(v))
                               for k, v in obs.items()}),
                       jnp.asarray(pick(perm)), C, S)
        for f in ("nodes", "node_mask", "edge_index", "edge_mask", "mask"):
            np.testing.assert_array_equal(pick(getattr(got, f).numpy()),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)


def test_shuffle_ops_protocol():
    """On: [B, N] permutations from the generator handed in, observations
    permuted and actions mapped back; off: the identity throughout."""
    limits = EnvLimits(max_nodes=N, max_edges=7, num_sfcs=C, max_sfs=S)
    on = ShuffleOps(AgentConfig(shuffle_nodes=True), limits)
    off = ShuffleOps(AgentConfig(), limits)
    gen = torch.Generator().manual_seed(7)
    perm = on.init_perm(3, "cpu", gen)
    assert perm.shape == (3, N)
    assert all(sorted(p) == list(range(N)) for p in perm.tolist())
    assert torch.equal(off.init_perm(3, "cpu"),
                       torch.arange(N).expand(3, N))
    obs = GraphObs(**{k: torch.from_numpy(v)
                      for k, v in _graph_obs(8, 3).items()})
    assert off.permute_obs(obs, perm) is obs
    p_obs = on.permute_obs(obs, perm)
    assert torch.equal(on.step_mask(p_obs, None, perm), p_obs.mask)
    a = torch.rand(3, N * C * S * N, generator=gen)
    assert torch.equal(on.env_action(a, perm),
                       reverse_action_permutation(a, perm, SHAPE))
    nxt, nperm = on.advance(obs, perm, gen)
    assert not torch.equal(nperm, perm)
    assert torch.equal(nxt.nodes, permute_graph_obs(obs, nperm, C, S).nodes)


@pytest.mark.parametrize("replicas", [1, 2])
def test_shuffled_training_on_both_trainers(tmp_path, replicas):
    """``shuffle_nodes: true`` from the agent yaml trains on the single
    env and on the replicas (tests/test_permutation.py:80): finite
    returns and losses, a full replay, non-zero gradients."""
    from gsc_tpu_torch import cli

    (tmp_path / "agent.yaml").write_text(
        "GNN_features: 4\nGNN_num_layers: 1\nGNN_num_iter: 1\n"
        "episode_steps: 3\nactor_hidden_layer_nodes: [8]\n"
        "critic_hidden_layer_nodes: [8]\nbatch_size: 4\nmem_limit: 12\n"
        "nb_steps_warmup_critic: 2\ngnn_impl: pallas\nshuffle_nodes: true\n")
    (tmp_path / "sim.yaml").write_text(
        "inter_arrival_mean: 10.0\ndeterministic_arrival: true\n"
        "deterministic_size: true\nflow_dr_mean: 1.0\nflow_dr_stdev: 0.0\n"
        "flow_size_shape: 0.001\nrun_duration: 10\nttl_choices: [100]\n")
    out = cli.run_train([
        "--device", "cpu", "--agent-config", str(tmp_path / "agent.yaml"),
        "--simulator-config", str(tmp_path / "sim.yaml"), "--network",
        "abilene", "--replicas", str(replicas), "--chunk", "3",
        "--episodes", "2", "--no-obs"])
    trainer = out["trainer"]
    assert trainer.agent_cfg.shuffle_nodes
    assert all(np.isfinite(h["episodic_return"]) for h in trainer.history)
    assert np.isfinite(trainer.history[-1]["critic_loss"])
    assert int(out["buffers"].size.sum()) == 6 * replicas
    last = trainer.history[-1]
    assert last["actor_grad_norm"] > 0 and last["critic_grad_norm"] > 0
