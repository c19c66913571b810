"""The port's bf16 precision policy against the JAX package's, on the CPU.

Inputs are numpy-seeded at small sizes (N = 8 graphs with F = 16, the
gradient cases of tests/test_torch_gat_backward.py, and the training
stack of tests/test_torch_train.py: a triangle padded to 8 nodes, GATv2
4 x 1 x 1, hidden (8,)).  The JAX side runs as its own tests run it:
``gatv2_pallas`` in interpret mode, ``jax.vjp``, flax ``apply`` with the
parameters carried across by ``utils.convert``.

Tolerances, per tensor, with their reasons:

- ``project`` in bf16: within one bf16 ulp of each entry.  Both sides add
  exact products in f32 (other orders) and round once.
- attention forward: ``max|port - jax| <= 2^-7 max|jax|`` (one to two
  bf16 ulps at the largest entry).  Both sides round at the same points;
  an f32 sum taken in another order can put a weight alpha or an output
  on the other side of a bf16 rounding boundary.  Measured: bit-equal.
- attention gradient on unit-normal inputs: ``2^-6 max|jax|``.  The JAX
  VJP rounds dalpha, de and d_att to bf16 on the way (the cotangents of
  its bf16 intermediates); the port computes in f32 and rounds d_xl and
  d_xr once.  Measured up to 1.1e-2 of the largest entry (d_xr, lead
  (2, 3), N = 40, mean).  Against a float64 evaluation at the same
  rounding points (``attention_backward_wide``) the port must be no
  further than the JAX gradient, up to the final rounding that neither
  escapes: half a bf16 ulp (2^-8 of the largest entry) for d_xl and
  d_xr, 2^-20 of the largest entry (f32 summation) for d_att and d_bias.
- where the softmax saturates (logits 8-16 apart) the JAX VJP stops the
  gradient at the row max and cancels to its rounding (d_xr entries of
  ~1e-6 where the true values are ~1e-11, d_att 1e-2 off): there the port
  is held to the float64 evaluation only, no further from it than JAX.
- actor and critic in bf16: ``2^-5`` of the largest output (the heads
  round activations to bf16 between layers).  Measured: bit-equal.
- the learn burst's losses in bf16: relative 2^-5 on the first gradient
  step's losses (the same bf16 rounding points on both sides, f32 sums in
  other orders), 2^-3 after the 4-step burst (Adam's first steps move
  every parameter by ~lr whatever the gradient's size, so rounding
  differences of small gradient entries turn into whole steps).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsc_tpu.agents.buffer import buffer_nbytes as j_buffer_nbytes
from gsc_tpu.agents.ddpg import DDPG as JDDPG
from gsc_tpu.config.catalog import abc_service as j_abc
from gsc_tpu.config.schema import AgentConfig as JAgent
from gsc_tpu.config.schema import EnvLimits as JLimits
from gsc_tpu.config.schema import SimConfig as JSim
from gsc_tpu.env.env import ServiceCoordEnv as JEnv
from gsc_tpu.models.nets import Actor as JActor
from gsc_tpu.models.nets import QNetwork as JQ
from gsc_tpu.ops.gat import project as j_project
from gsc_tpu.ops.pallas_gat import gatv2_pallas
from gsc_tpu.parallel.dp import ParallelDDPG as JParallel
from gsc_tpu.sim.traffic import generate_traffic as j_traffic

from gsc_tpu_torch.agents.buffer import buffer_init, buffer_nbytes
from gsc_tpu_torch.agents.ddpg import DDPG
from gsc_tpu_torch.config import abc_service
from gsc_tpu_torch.config.schema import (PRECISION_POLICIES, AgentConfig,
                                         EnvLimits, PrecisionPolicy,
                                         SimConfig, precision_policy)
from gsc_tpu_torch.env.env import ServiceCoordEnv
from gsc_tpu_torch.env.observations import GraphObs
from gsc_tpu_torch.models.nets import Actor, QNetwork
from gsc_tpu_torch.ops.gat import attention_dense, project
from gsc_tpu_torch.ops.gat_attention import (attention_backward_plain,
                                             attention_backward_wide)
from gsc_tpu_torch.parallel.dp import ParallelDDPG
from gsc_tpu_torch.sim.state import TrafficSchedule
from gsc_tpu_torch.utils.convert import (learner_state_from_jax,
                                         params_from_jax)
from test_torch_kernels import (BWD_CASES, make_backward_inputs,
                                make_saturated_inputs)
from test_torch_models import make_obs
from test_torch_train import (AGENT_KW, CHUNK, SIM_KW, B, E, N, _batch,
                              _Draws, _jobs, _obs, _state_tree, _tbatch,
                              _tobs, _topos)
from torch_port_helpers import one_torch_thread  # noqa: F401

FWD_REL = 2.0 ** -7
BWD_REL = 2.0 ** -6
NET_REL = 2.0 ** -5
LOSS_REL, BURST_REL = 2.0 ** -5, 2.0 ** -3
NAMES = ("d_xl", "d_xr", "d_att", "d_bias")
BF = torch.bfloat16


def _jbf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ------------------------------------------------------------------ policy
def test_policy_registry_and_validation():
    assert AgentConfig().precision == "f32"
    assert not PRECISION_POLICIES["f32"].mixed
    bf16 = precision_policy("bf16")
    assert bf16.mixed
    assert bf16.param_dtype == "float32"
    assert (bf16.gnn_dtype, bf16.mlp_dtype, bf16.replay_cast_dtype) == \
        ("bfloat16", "bfloat16", "bfloat16")
    f32 = precision_policy("f32")
    assert (f32.gnn_dtype, f32.mlp_dtype, f32.replay_cast_dtype) == \
        (None, None, None)
    assert AgentConfig(precision="bf16").precision_policy is bf16
    with pytest.raises(ValueError, match="unknown precision"):
        AgentConfig(precision="fp8")
    with pytest.raises(ValueError, match="unknown precision"):
        precision_policy("fp8")
    with pytest.raises(ValueError, match="param_dtype"):
        PrecisionPolicy(name="bad", param_dtype="bfloat16")
    with pytest.raises(ValueError, match="gnn_compute"):
        PrecisionPolicy(name="bad", gnn_compute="float16")


def test_loader_parses_precision(tmp_path):
    from gsc_tpu_torch.config.loader import load_agent
    p = tmp_path / "agent.yaml"
    p.write_text("graph_mode: true\nprecision: bf16\n")
    assert load_agent(str(p)).precision == "bf16"
    assert load_agent(str(p), precision="f32").precision == "f32"


# ------------------------------------------------------------ plain ops
def test_project_bf16_matches_jax_and_f32_is_verbatim():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, 3)).astype(np.float32)
    w = rng.normal(size=(3, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    want = _f32(j_project(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          "bfloat16"))
    t = torch.from_numpy
    got = project(t(x), t(w.T.copy()), t(b), "bfloat16")
    assert got.dtype == BF
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert np.all(np.abs(got - want) <= ulp)
    f32 = project(t(x), t(w.T.copy()), t(b), None)
    assert torch.equal(f32, torch.nn.functional.linear(t(x), t(w.T.copy()),
                                                       t(b)))


def test_bf16_leaky_slope_is_jax_weak_typed_constant():
    """JAX multiplies a bf16 tensor by the weak-typed 0.2 as bf16(0.2) =
    LEAKY_SLOPE_BF16; PyTorch's ``0.2 * bf16`` multiplies by 0.2 in f32
    and rounds, which differs.  The port's bf16 LeakyReLU
    (``bf16_pairwise``, with xr = 0) matches JAX on every entry."""
    from gsc_tpu_torch.ops.gat import LEAKY_SLOPE_BF16, bf16_pairwise
    assert LEAKY_SLOPE_BF16 == float(jnp.asarray(0.2, jnp.bfloat16))
    e = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    want = _f32(jax.jit(lambda x: jnp.where(x >= 0, x, 0.2 * x))(_jbf(e)))
    te = torch.from_numpy(e).to(BF)
    # xl [4096, 1] (one feature), xr [1, 1] of 0: e_ij = xl_j
    act, _ = bf16_pairwise(te.reshape(-1, 1), torch.zeros(1, 1, dtype=BF))
    np.testing.assert_array_equal(act.float().numpy().reshape(e.shape),
                                  want)
    naive = torch.where(te >= 0, te, 0.2 * te).float().numpy()
    differ = int((naive != want).sum())
    assert differ > 0, differ


def _attn_inputs(seed, batch=5, n=8, f=16):
    rng = np.random.default_rng(seed)
    xl = rng.normal(size=(batch, n, f)).astype(np.float32)
    xr = rng.normal(size=(batch, n, f)).astype(np.float32)
    att = rng.normal(size=(f,)).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    adj = rng.uniform(size=(batch, n, n)) < 0.4
    adj[:, np.arange(n - 1), np.arange(n - 1)] = True
    adj[:, n - 1, :] = False                 # a padded node
    adj[:, :, n - 1] = False
    adj[:, 0, :] = False                     # a row without a neighbour
    return xl, xr, att, bias, adj


@pytest.mark.parametrize("mean", [True, False])
def test_attention_bf16_matches_pallas_interpret(mean):
    xl, xr, att, bias, adj = _attn_inputs(3)
    want = _f32(gatv2_pallas(_jbf(xl), _jbf(xr), jnp.asarray(att),
                             jnp.asarray(bias), jnp.asarray(adj), mean,
                             None, True))
    t = torch.from_numpy
    got = attention_dense(t(xl).to(BF), t(xr).to(BF), t(att), t(bias),
                          t(adj), mean)
    assert got.dtype == BF
    got = got.float().numpy()
    differ = int((got != want).sum())
    err = float(np.abs(got - want).max())
    assert err <= FWD_REL * float(np.abs(want).max()), \
        f"{differ} of {got.size} entries differ, by up to {err}"
    assert np.all(got[~adj.any(-1)] == 0.0)


def _jax_vjp(xl, xr, att, bias, adj, grad, mean):
    adj_j = jnp.asarray(adj)
    _, vjp = jax.vjp(lambda a, b, c, d: gatv2_pallas(a, b, c, d, adj_j, mean,
                                                     None, True),
                     _jbf(xl), _jbf(xr), jnp.asarray(att), jnp.asarray(bias))
    return [_f32(g).astype(np.float64) for g in vjp(_jbf(grad))]


def _port_grads(xl, xr, att, adj, grad, mean):
    t = torch.from_numpy
    args = (t(grad).to(BF), t(xl).to(BF), t(xr).to(BF), t(att), t(adj))
    got = attention_backward_plain(*args, mean)
    ref = attention_backward_wide(*args, mean, torch.float64)
    return got, [r.numpy() for r in ref]


def _floor(k, ref):
    """The final rounding's own error: half a bf16 ulp at the largest
    entry for d_xl/d_xr, f32 summation for d_att/d_bias."""
    return (2.0 ** -8 if k < 2 else 2.0 ** -20) * float(np.abs(ref).max())


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("lead,n,f", BWD_CASES)
def test_attention_backward_bf16_matches_jax_vjp(lead, n, f, mean):
    xl, xr, att, bias, adj, grad = make_backward_inputs(lead, n, f,
                                                        seed=n * 31 + f)
    jax_grads = _jax_vjp(xl, xr, att, bias, adj, grad, mean)
    got, ref = _port_grads(xl, xr, att, adj, grad, mean)
    assert [g.dtype for g in got] == [BF, BF, torch.float32, torch.float32]
    for k, (name, g, j, r) in enumerate(zip(NAMES, got, jax_grads, ref)):
        g = g.double().numpy()
        assert g.shape == j.shape, name
        err = float(np.abs(g - j).max())
        assert err <= BWD_REL * float(np.abs(j).max()), (name, err)
        ours, theirs = np.abs(g - r).max(), np.abs(j - r).max()
        assert ours <= max(theirs, _floor(k, r)), (name, ours, theirs)
    empty = ~adj.any(axis=-1)
    assert np.all(got[1].float().numpy()[empty] == 0.0)


@pytest.mark.parametrize("gap", [8.0, 12.0, 16.0])
@pytest.mark.parametrize("lead,n,f", [((100,), 24, 22), ((3,), 40, 22)])
def test_attention_backward_bf16_saturated_softmax(lead, n, f, gap):
    xl, xr, att, bias, adj, grad = make_saturated_inputs(lead, n, f, seed=5,
                                                         gap=gap)
    jax_grads = _jax_vjp(xl, xr, att, bias, adj, grad, True)
    got, ref = _port_grads(xl, xr, att, adj, grad, True)
    for k, (name, g, j, r) in enumerate(zip(NAMES, got, jax_grads, ref)):
        ours = np.abs(g.double().numpy() - r).max()
        theirs = np.abs(j - r).max()
        assert ours <= max(theirs, _floor(k, r)), (name, ours, theirs)


# ------------------------------------------------------- actor and critic
WIDTHS = {"small": dict(gnn_features=8, actor_hidden_layer_nodes=(16,)),
          "flagship": dict(gnn_features=22, actor_hidden_layer_nodes=(256,))}


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_bf16_actor_and_critic_match_flax(width):
    kw = dict(WIDTHS[width], gnn_impl="pallas", precision="bf16")
    jagent, tagent = JAgent(**kw), AgentConfig(**kw)
    a_dim = 24 * 3 * 24
    obs = make_obs(3, seed=5)
    jobs = _jobs(obs)
    jactor = JActor(agent=jagent, action_dim=a_dim, gnn_impl="pallas")
    params = jactor.init(jax.random.PRNGKey(1), jobs)
    tactor = Actor(tagent, a_dim, gnn_impl="pallas")
    tactor.load_state_dict(params_from_jax(jax.device_get(params), tactor))
    act = np.random.default_rng(1).uniform(size=(3, a_dim)).astype(
        np.float32)
    jq = JQ(agent=jagent, gnn_impl="pallas", action_dim=a_dim)
    qparams = jq.init(jax.random.PRNGKey(2), jobs, jnp.asarray(act))
    tq = QNetwork(tagent, a_dim, gnn_impl="pallas")
    tq.load_state_dict(params_from_jax(jax.device_get(qparams), tq))
    with torch.no_grad():
        out = tactor(_tobs(obs))
        q = tq(_tobs(obs), torch.from_numpy(act))
    assert out.dtype == q.dtype == torch.float32
    for got, want in ((out.numpy(), np.asarray(jactor.apply(params, jobs))),
                      (q.numpy(), np.asarray(jq.apply(qparams, jobs,
                                                      jnp.asarray(act))))):
        assert got.shape == want.shape
        err = float(np.abs(got - want).max())
        assert err <= NET_REL * float(np.abs(want).max()), err
    assert not out.numpy()[obs["mask"] == 0].any()
    for net in (tactor, tq):
        assert all(p.dtype == torch.float32 for p in net.parameters())


def test_convert_gives_f32_masters_whatever_the_policy():
    """Flax keeps f32 parameters under "bf16"; the converter makes f32
    masters of them, and of any leaf stored in another float dtype."""
    kw = dict(WIDTHS["small"], gnn_impl="pallas", precision="bf16")
    obs = _jobs(make_obs(2))
    params = JActor(agent=JAgent(**kw), action_dim=1728,
                    gnn_impl="pallas").init(jax.random.PRNGKey(1), obs)
    tree = jax.device_get(params)
    assert all(np.asarray(l).dtype == np.float32
               for l in jax.tree_util.tree_leaves(tree))
    actor = Actor(AgentConfig(**kw), 1728, gnn_impl="pallas")
    sd = params_from_jax(tree, actor)
    assert all(v.dtype == torch.float32 for v in sd.values())
    low = jax.tree_util.tree_map(lambda x: np.asarray(x).astype(
        jnp.bfloat16), tree)
    sd16 = params_from_jax(low, actor)
    for k, v in sd16.items():
        assert v.dtype == torch.float32
        assert torch.equal(v, sd[k].to(BF).float()), k


# ---------------------------------------------------------------- training
BF_AGENT = dict(AGENT_KW, precision="bf16")


def _bf16_envs(agent_kw=BF_AGENT):
    jagent = JAgent(**agent_kw, gnn_impl="pallas")
    tagent = AgentConfig(**agent_kw, gnn_impl="pallas")
    jenv = JEnv(j_abc(), JSim(**SIM_KW), jagent,
                JLimits.for_service(j_abc(), max_nodes=N, max_edges=E))
    tenv = ServiceCoordEnv(abc_service(), SimConfig(**SIM_KW), tagent,
                           EnvLimits.for_service(abc_service(), max_nodes=N,
                                                 max_edges=E))
    return jenv, tenv


def _bf16_learners():
    jenv, tenv = _bf16_envs()
    jd = JDDPG(jenv, jenv.agent)
    td = DDPG(tenv, tenv.agent, device="cpu")
    one = {k: v[0] for k, v in _obs(1, 0).items()}
    jstate = jd.init(jax.random.PRNGKey(3), _jobs(one))
    tstate = td.init_state(torch.Generator().manual_seed(0))
    learner_state_from_jax(_state_tree(jstate), tstate)
    return jd, td, jstate, tstate, one


def _assert_f32_state(tstate):
    for net in (tstate.actor, tstate.critic, tstate.target_actor,
                tstate.target_critic):
        assert all(p.dtype == torch.float32 for p in net.parameters())
    for opt in (tstate.actor_opt, tstate.critic_opt):
        for st in opt.state.values():
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == \
                torch.float32


def _close(got, want, rel, what):
    assert math.isfinite(got), what
    assert abs(got - want) <= rel * max(abs(want), 1e-3), (what, got, want)


def test_bf16_replay_storage_and_nbytes():
    jd, td, _, _, one = _bf16_learners()
    j32 = JDDPG(JEnv(j_abc(), JSim(**SIM_KW), JAgent(**AGENT_KW),
                     JLimits.for_service(j_abc(), max_nodes=N,
                                         max_edges=E)), JAgent(**AGENT_KW))
    tone = GraphObs(**{k: torch.from_numpy(np.asarray(v))
                       for k, v in one.items()})
    t32 = DDPG(ServiceCoordEnv(abc_service(), SimConfig(**SIM_KW),
                               AgentConfig(**AGENT_KW), td.env.limits),
               AgentConfig(**AGENT_KW), device="cpu")
    buf16 = buffer_init(td.example_transition(tone), 6)
    buf32 = buffer_init(t32.example_transition(tone), 6)
    assert buf16.data["reward"].dtype == buf16.data["done"].dtype == \
        torch.float32
    assert buf16.data["action"].dtype == BF
    assert buf16.data["obs.nodes"].dtype == BF
    assert buf16.data["obs.mask"].dtype == BF
    assert buf16.data["obs.node_mask"].dtype == torch.bool
    assert buf16.data["obs.edge_index"].dtype == \
        buf32.data["obs.edge_index"].dtype
    assert buf16.data["topo_idx"].dtype == torch.int32
    for buf in (buf16, buf32):
        assert buffer_nbytes(buf) == sum(d.numel() * d.element_size()
                                         for d in buf.data.values())
    assert buffer_nbytes(buf16) < buffer_nbytes(buf32)
    # the same accounting as the JAX package's, leaf dtype by leaf dtype
    jone = _jobs(one)
    from gsc_tpu.agents.buffer import buffer_init as j_buffer_init
    for j, t in ((jd, buf16), (j32, buf32)):
        jbuf = j_buffer_init(j.example_transition(jone), 6)
        jb = j_buffer_nbytes(jbuf)
        # the port keeps edge_index in torch's int64 where JAX has int32
        extra = sum(d.numel() * (d.element_size() - 4)
                    for k, d in t.data.items() if d.dtype == torch.int64)
        assert buffer_nbytes(t) - extra == jb
    mixed = buffer_init({"a": torch.zeros(4, dtype=BF),
                         "b": torch.zeros(4)}, capacity=8)
    assert buffer_nbytes(mixed) == 8 * (4 * 2 + 4 * 4)


def test_bf16_masters_f32_outputs_and_masking():
    jd, td, jstate, tstate, _ = _bf16_learners()
    _assert_f32_state(tstate)
    o = _tobs(_obs(2, 3))
    with torch.no_grad():
        a = tstate.actor(o)
        q = tstate.critic(o, a)
    assert a.dtype == q.dtype == torch.float32
    assert not a[o.mask == 0].any()
    tstate, m = td.gradient_step_on_batch(tstate, _tbatch(_batch(21)))
    _assert_f32_state(tstate)
    assert all(math.isfinite(float(v)) for v in m.values())


def test_bf16_losses_and_learn_burst_match_jax():
    """The critic and actor losses on one batch (replayed in bf16, as the
    replay stores it), one gradient step, then a 4-step learn burst on the
    same batches on both sides."""
    jd, td, jstate, tstate, _ = _bf16_learners()

    def replayed(b):
        # the bf16 replay's view of a batch: float leaves rounded to bf16
        r = lambda x: x.astype(jnp.bfloat16) if x.dtype == np.float32 else x
        out = dict(b)
        for k in ("obs", "next_obs"):
            out[k] = {f: r(v) for f, v in b[k].items()}
        out["action"] = r(b["action"])
        return out

    def t_of(b):
        def conv(x):
            x = jnp.asarray(x)
            low = x.dtype == jnp.bfloat16
            t = torch.from_numpy(np.array(x.astype(jnp.float32) if low
                                          else x))
            return t.to(BF) if low else t
        return {k: (GraphObs(**{f: conv(x) for f, x in v.items()})
                    if isinstance(v, dict) else conv(v))
                for k, v in b.items()}

    b = replayed(_batch(11))
    jb = {k: ({f: jnp.asarray(x) for f, x in v.items()}
              if isinstance(v, dict) else jnp.asarray(v))
          for k, v in b.items()}
    from gsc_tpu.env.observations import GraphObs as JObs
    jb = {k: (JObs(**v) if isinstance(v, dict) else v)
          for k, v in jb.items()}
    tb = t_of(b)
    assert tb["obs"].nodes.dtype == BF and tb["reward"].dtype == torch.float32
    (jcl, _), _ = jax.value_and_grad(jd._critic_loss, has_aux=True)(
        jstate.critic_params, jstate, jb)
    tcl, _ = td.critic_loss(tstate, tb)
    _close(float(tcl.detach()), float(jcl), LOSS_REL, "critic loss")
    jal = jd._actor_loss(jstate.actor_params, jstate.critic_params, jb)
    tal = td.actor_loss(tstate, tb)
    _close(float(tal.detach()), float(jal), LOSS_REL, "actor loss")

    jstate, jm = jd.gradient_step_on_batch(jstate, jb)
    tstate, tm = td.gradient_step_on_batch(tstate, tb)
    for k in ("critic_loss", "actor_loss"):
        _close(float(tm[k]), float(jm[k]), LOSS_REL, k)
    pool = replayed(_batch(31, size=16))
    jpool = {k: (JObs(**{f: jnp.asarray(x) for f, x in v.items()})
                 if isinstance(v, dict) else jnp.asarray(v))
             for k, v in pool.items()}
    tpool = t_of(pool)
    bs = 4
    sample = lambda k: jax.tree_util.tree_map(
        lambda x: x[jax.random.randint(k, (bs,), 0, 16)], jpool)
    _, sub = jax.random.split(jstate.rng)
    idx = [np.asarray(jax.random.randint(jax.random.fold_in(sub, i), (bs,),
                                         0, 16)) for i in range(4)]
    jstate, jm = jax.jit(lambda s: jd._learn_burst(s, sample, steps=4))(
        jstate)
    it = iter(idx)

    def tsample():
        i = torch.from_numpy(np.array(next(it))).long()
        return {k: (GraphObs(**{f: getattr(v, f)[i] for f in vars(v)})
                    if isinstance(v, GraphObs) else v[i])
                for k, v in tpool.items()}

    tstate, tm = td.learn_burst(tstate, tsample, steps=4)
    for k in ("critic_loss", "actor_loss"):
        _close(float(tm[k]), float(jm[k]), BURST_REL, f"burst {k}")
    _assert_f32_state(tstate)


def test_bf16_episode_matches_jax():
    """One episode of the bf16 ``ParallelDDPG`` (two rollout chunks of
    warm-up steps, the final one carrying the learn burst) against the
    JAX package's on the same traffic and draws: the bf16 replay (its
    float leaves the same f32 transitions rounded once, so within one bf16
    ulp), and the burst's losses within BURST_REL."""
    kw = dict(BF_AGENT, nb_steps_warmup_critic=8)
    jenv, tenv = _bf16_envs(kw)
    jtopo, ttopo = _topos()
    jp = JParallel(jenv, jenv.agent, num_replicas=B)
    tp = ParallelDDPG(tenv, tenv.agent, B, device="cpu")
    jtr = [j_traffic(jenv.sim_cfg, jenv.service, jtopo, 4, seed=1000 + r)
           for r in range(B)]
    jtraffic = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jtr)
    ttraffic = TrafficSchedule(**{
        f.name: torch.from_numpy(np.array(getattr(jtraffic, f.name)))
        for f in dataclasses.fields(TrafficSchedule)})
    one = {k: v[0] for k, v in _obs(1, 0).items()}
    jstate = jp.init(jax.random.PRNGKey(4), _jobs(one))
    jbuf = jp.init_buffers(_jobs(one))
    es, obs = jp.reset_all(jax.random.PRNGKey(5), jtopo, jtraffic)
    a_dim = jp.ddpg.action_dim
    steps, rng = [], jstate.rng
    for c in range(2):
        rng, sub = jax.random.split(rng)
        sub, _ = jax.random.split(sub)
        for i in range(CHUNK):
            keys = jax.random.split(jax.random.fold_in(sub, i), B)
            pairs = [jax.random.split(k) for k in keys]
            steps.append((
                np.stack([np.asarray(jax.random.uniform(p[0], (a_dim,)))
                          for p in pairs]),
                np.stack([np.asarray(jax.random.normal(p[1], (a_dim,)))
                          for p in pairs])))
    for c in range(2):
        jstate, jbuf, es, obs, _ = jp.rollout_episodes(
            jstate, jbuf, es, obs, jtopo, jtraffic, jnp.int32(c * CHUNK),
            CHUNK)
    _, sub = jax.random.split(jstate.rng)
    batches = []
    for i in range(4):
        kb, ks = jax.random.split(jax.random.fold_in(sub, i))
        bidx = jax.random.randint(kb, (4,), 0, B)
        sidx = jax.random.randint(ks, (4,), 0,
                                  jnp.maximum(jbuf.size[bidx], 1))
        batches.append((np.asarray(bidx), np.asarray(sidx)))
    jlearn_in = jstate
    jstate, jm = jp.learn_burst(jstate, jbuf)

    tp.draws = _Draws(steps, batches)
    tstate = tp.ddpg.init_state(torch.Generator().manual_seed(0))
    learner_state_from_jax(_state_tree(jlearn_in), tstate)
    tbuf = tp.init_buffers(GraphObs(**{k: torch.from_numpy(np.asarray(v))
                                       for k, v in one.items()}))
    tes, tobs = tp.reset_all(ttopo, ttraffic)
    metrics = None
    for c in range(2):
        tstate, tbuf, tes, tobs, _, metrics = tp.chunk_step(
            tstate, tbuf, tes, tobs, ttopo, ttraffic, c * CHUNK, CHUNK,
            learn=(c == 1))
    assert not tp.draws.steps and not tp.draws.batches
    jleaves = dict(zip(
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(jbuf.data)[0]],
        jax.tree_util.tree_leaves(jbuf.data)))
    for name, t in tbuf.data.items():
        path = "".join(f"['{p}']" if i == 0 else f".{p}"
                       for i, p in enumerate(name.split(".")))
        want = jleaves[path]
        if want.dtype == jnp.bfloat16:
            assert t.dtype == BF, name
            w = _f32(want)
            g = t.float().numpy()
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
                          - 7)
            assert np.all(np.abs(g - w) <= ulp), name
        elif np.asarray(want).dtype.kind in "biu":
            np.testing.assert_array_equal(t.numpy(), np.asarray(want).astype(
                t.numpy().dtype), err_msg=name)
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    for k in ("critic_loss", "actor_loss"):
        _close(float(metrics[k]), float(jm[k]), BURST_REL, f"episode {k}")
    _assert_f32_state(tstate)


# ------------------------------------------------- the f32 policy verbatim
def _f32_reference_actor(actor, obs):
    """The f32 actor as the port computed it before the precision policy:
    F.linear projections, the f32 attention, ReLU, the f32 pool, nn.Linear
    layers and the mask product."""
    from gsc_tpu_torch.ops.gat import dense_adj
    F_ = torch.nn.functional
    emb = actor.embedder
    adj = dense_adj(obs.edge_index, obs.edge_mask, obs.node_mask)

    def conv(c, x):
        xl = F_.linear(x, c.lin_l.weight, c.lin_l.bias)
        xr = F_.linear(x, c.lin_r.weight, c.lin_r.bias)
        return attention_dense(xl, xr, c.att, c.bias, adj, c.mean_aggr)

    x = torch.relu(conv(emb.encoder, obs.nodes))
    for it in range(emb.num_iter):
        for i, c in enumerate(emb.process):
            x = conv(c, x)
            if not (i == emb.num_layers - 2 and it == emb.num_iter - 1):
                x = torch.relu(x)
    m = obs.node_mask.to(x.dtype)[..., None]
    pooled = (x * m).sum(dim=-2) / m.sum(dim=-2).clamp(min=1.0)
    h = torch.cat([pooled, obs.mask.to(pooled.dtype)], dim=-1)
    for i, lin in enumerate(actor.mlp.layers):
        h = lin(h)
        if i < len(actor.mlp.layers) - 1:
            h = torch.relu(h)
    return h * obs.mask


def test_f32_policy_is_the_f32_code_verbatim():
    """The "f32" policy takes the f32 code unchanged: the actor bit for bit
    equal to the pre-policy expressions, f32 replay leaves, and f32
    intermediate dtypes throughout."""
    agent = AgentConfig(**dict(WIDTHS["flagship"], gnn_impl="pallas"))
    assert agent.precision == "f32"
    actor = Actor(agent, 1728, gnn_impl="pallas")
    actor.reset_parameters(torch.Generator().manual_seed(0))
    o = _tobs(make_obs(3, seed=9))
    with torch.no_grad():
        assert torch.equal(actor(o), _f32_reference_actor(actor, o))
    assert actor.mlp.dtype is None
    assert actor.embedder.encoder.compute_dtype is None
    _, tenv = _bf16_envs(dict(AGENT_KW))
    td = DDPG(tenv, tenv.agent, device="cpu")
    one = GraphObs(**{k: torch.from_numpy(np.asarray(v[0]))
                      for k, v in _obs(1, 0).items()})
    ex = td.example_transition(one)
    assert ex["obs"] is one and ex["action"].dtype == torch.float32
