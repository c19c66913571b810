"""The port at bench.py's large networks (interroute: 128 nodes, rung 5:
256), on the CPU, against the JAX package.

- Every builder the port copied (``interroute``, ``tinet``, ``chinanet``,
  ``star``, ``ring``, ``two_node``, the numpy-seeded ``random_network``,
  ``mutate_caps``, ``set_ingress``) and the ``mixed_service`` catalog give
  the JAX package's values exactly, and interroute and rung 5 compile to
  the JAX package's padded tables exactly.
- The plain attention (the kernels' plain version, what CPU tensors run)
  at N = 128 and 256 against ``gatv2_pallas`` in interpret mode, forward
  and VJP: rtol 1e-5 and an atol of 1e-5 times the largest entry of each
  output.  An output sums up to N weighted rows, a gradient entry up to
  N F products (d_att and d_bias over every row of both graphs), each side
  in its own f32 order, so an entry that cancels to near 0 differs by the
  rounding of its terms, not of itself (measured: one forward entry of
  5,632 at N = 128, sum aggregation, 1.6e-6 apart, 3e-5 relative).
- Python mirrors of the kernels' shared-memory layouts (``layout_for`` of
  csrc/substep_megakernel.cu, ``layout`` of csrc/gat_attention.cu and
  csrc/gat_attention_backward.cu, byte for byte) show that interroute and
  rung 5 fit one CTA's 232,448 bytes, and that the flagship's layouts did
  not grow.
- The whole-slot sums (path credits, processing delays, end-to-end
  delays) of the plain engine add in slot order, as kernel #2 does: equal
  to a sequential float32 sum bit for bit where a vectorised sum is not,
  on a battery case with three or more fractional processing delays in
  one substep, which also holds its parity with the JAX engine.
- ``cli train`` and ``cli serve`` take these networks: a built-in name or
  a GraphML file, padded to ``--max-nodes``/``--max-edges``; a factored
  actor trains and serves through them.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from gsc_tpu.config.catalog import mixed_service as j_mixed_service
from gsc_tpu.ops.pallas_gat import gatv2_pallas
from gsc_tpu.topology import synthetic as jsyn
from gsc_tpu.topology.compiler import compile_topology as j_compile

from gsc_tpu_torch import cli
from gsc_tpu_torch.config import mixed_service
from gsc_tpu_torch.ops.build import MAX_SMEM_BYTES
from gsc_tpu_torch.ops.gat_attention import (attention_backward_plain,
                                             attention_plain)
from gsc_tpu_torch.sim import cases
from gsc_tpu_torch.sim.engine import slot_order_sum
from gsc_tpu_torch.topology import synthetic
from gsc_tpu_torch.topology.compiler import compile_topology
from test_torch_kernels import make_backward_inputs
from test_torch_substep import _run_both
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL, ATOL_REL = 1e-5, 1e-5
NAMES = ("d_xl", "d_xr", "d_att", "d_bias")

BUILDERS = [
    ("interroute", (), {}),
    ("interroute", (), dict(num_ingress=8, node_cap_range=(1, 4), seed=3)),
    ("tinet", (), {}),
    ("chinanet", (), dict(node_cap_range=None)),
    ("star", (), dict(n=5)),
    ("ring", (), dict(n=7, num_ingress=2)),
    ("two_node", (), {}),
    ("random_network", (200,), dict(num_ingress=8, seed=11)),
    ("random_network", (64,), dict(seed=7)),
]


@pytest.mark.parametrize("name,args,kw", BUILDERS,
                         ids=[f"{b[0]}{i}" for i, b in enumerate(BUILDERS)])
def test_builders_match_jax(name, args, kw):
    got = getattr(synthetic, name)(*args, **kw)
    want = getattr(jsyn, name)(*args, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_mutate_caps_and_set_ingress_match_jax():
    got = synthetic.set_ingress(
        synthetic.mutate_caps(synthetic.interroute(), (1, 5), seed=3),
        [0, 5, 9])
    want = jsyn.set_ingress(
        jsyn.mutate_caps(jsyn.interroute(), (1, 5), seed=3), [0, 5, 9])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.node_types.count("Ingress") == 4 + 3 - 1   # 0 was one


@pytest.mark.parametrize("spec,n,e", [
    ("interroute", 128, 192), ("rung5", 256, 384)])
def test_large_networks_compile_like_jax(spec, n, e):
    build = {"interroute": lambda s: s.interroute(),
             "rung5": lambda s: s.random_network(200, num_ingress=8,
                                                 seed=11)}[spec]
    got = compile_topology(build(synthetic), max_nodes=n, max_edges=e)
    want = j_compile(build(jsyn), max_nodes=n, max_edges=e)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if hasattr(w, "shape"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f.name)


def test_mixed_service_matches_jax():
    got, want = mixed_service(), j_mixed_service()
    assert dict(got.sfc_list) == dict(want.sfc_list)
    assert {k: dataclasses.asdict(v) for k, v in got.sf_list.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.sf_list.items()}


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("n", [128, 256])
def test_plain_attention_matches_pallas_at_large_n(n, mean):
    xl, xr, att, bias, adj, grad = make_backward_inputs((2,), n, 22,
                                                        seed=n + 5)
    pal = np.asarray(gatv2_pallas(xl, xr, att, bias, adj, mean_aggr=mean,
                                  interpret=True))
    t = torch.from_numpy
    out = attention_plain(t(xl), t(xr), t(att), t(bias), t(adj),
                          mean).numpy()
    np.testing.assert_allclose(out, pal, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(pal).max()))
    assert np.all(out[~adj.any(axis=-1)] == 0.0)
    adj_j = jax.numpy.asarray(adj)
    _, vjp = jax.vjp(lambda a, b, c, d: gatv2_pallas(a, b, c, d, adj_j, mean,
                                                     None, True),
                     xl, xr, att, bias)
    want = [np.asarray(g) for g in vjp(grad)]
    got = [g.numpy() for g in attention_backward_plain(
        t(grad), t(xl), t(xr), t(att), t(adj), mean)]
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(
            g, w, rtol=RTOL, atol=ATOL_REL * float(np.abs(w).max()),
            err_msg=name)


# ------------------------------------------------------ the kernels' layouts
def _r16(x):
    return (x + 15) // 16 * 16


def megakernel_smem(m, n, c, s, p, e):
    """csrc/substep_megakernel.cu ``layout_for``: per-slot arrays (17 int,
    13 float, the region shared by lifetimes: max(7, 5 + P), the (edge,
    node) keys), warp totals, the Scalars struct, the per-replica tables
    and the warp ballots."""
    scalars = 448
    slots = _r16(8 * m) + _r16(4 * 17 * m) + _r16(4 * 13 * m) \
        + _r16(4 * max(7, 5 + p) * m)
    tables = _r16(4 * 6 * n * p) + _r16(16 * e) + _r16(16 * n) \
        + _r16(4 * n * c * s) + _r16(4 * (c + c * s + 4 * p))
    return _r16(8 * 32 * (p + 1)) + _r16(scalars) + slots + tables \
        + _r16(4 * 8 * 32)


def tile_rows(n):
    return min(n, 32)


def attention_smem(n, f, bf16):
    """csrc/gat_attention.cu ``layout``: one CTA's tile of r rows."""
    r, np_ = tile_rows(n), (n + 3) // 4 * 4
    o = _r16(np_ * f * 4) + _r16(r * f * 4) + _r16(r * n) + 2 * _r16(f * 4)
    o += r * np_ * 4 + _r16(r * 4)
    if bf16:
        o += _r16(n * f * 2) + _r16(r * f * 2)
    return o + 16


def attention_backward_smem(n, f, bf16):
    """csrc/gat_attention_backward.cu ``layout``: up to 32 nodes one CTA
    with its 4 x 4 tiles' partials, above that a CTA of 32 rows with xl
    transposed and rows padded to 64 columns; the partials of as many
    features as fit (fc)."""
    small = n <= 32
    r = tile_rows(n)
    np_ = (n + 3) // 4 * 4 if small else (n + 63) // 64 * 64
    nt, chunks = np_ // 4, np_ // 64
    rows = _r16(r * f * 4)
    o = (rows if small else _r16(f * (np_ + 4) * 4)) + 3 * rows
    o += _r16(r * n) + _r16(f * 4) + 2 * r * np_ * 4 + _r16(r * 4)
    o += _r16((nt * nt if small else chunks) * f * 4)
    o += 0 if small else _r16(2 * f * 8)
    h = _r16(r * f * 2) if bf16 else 0
    o += (h if small else 0) + 2 * h + 16
    per = nt * (r + np_) * 4 if small else chunks * r * 4 + np_ * 4
    budget = MAX_SMEM_BYTES - 1024
    fc = (budget - o - 32) // per if budget > o + 32 else 1
    fc = max(1, min(fc, f))
    return o + _r16((nt if small else chunks) * r * fc * 4) \
        + _r16((nt * np_ if small else np_) * fc * 4)


def first_backward_smem(n, f, bf16):
    """The first backward design's ``layout``: the whole xl and xr per
    CTA, no feature chunks."""
    r, np_ = tile_rows(n), (n + 3) // 4 * 4
    rows = _r16(r * f * 4)
    o = 2 * _r16(n * f * 4) + rows + _r16(r * n) + _r16(f * 4) + 3 * rows
    o += 2 * r * np_ * 4 + _r16(r * 4) + _r16(2 * f * 16 * 8)
    if bf16:
        o += 2 * _r16(n * f * 2) + _r16(r * f * 2)
    return o + 16


# (M, N, C, S, P, E) of bench.py's stacks, and the parent's layout sizes
STACKS = {"flagship": ((128, 24, 1, 3, 3, 37), 32688),
          "rung4": ((512, 64, 1, 3, 3, 128), 119552),
          "interroute": ((1024, 128, 1, 3, 3, 192), 235520),
          "rung5": ((1024, 256, 2, 3, 5, 384), 291888)}


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_megakernel_layout_fits(stack):
    dims, parent = STACKS[stack]
    got = megakernel_smem(*dims)
    assert got <= MAX_SMEM_BYTES, (stack, got)
    assert got < parent, (stack, got, parent)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n", [24, 64, 128, 256])
def test_attention_layouts_fit(n, bf16):
    fwd, bwd = attention_smem(n, 22, bf16), attention_backward_smem(n, 22,
                                                                   bf16)
    assert fwd <= MAX_SMEM_BYTES and bwd <= MAX_SMEM_BYTES, (fwd, bwd)
    # a graph of more than 32 nodes is cut into tiles of 32 rows; the
    # backward's tiles form one cluster of at most 8 CTAs
    assert math.ceil(n / tile_rows(n)) <= 8
    if n == 24:
        # the flagship keeps its one-CTA layout: [N, N] weights in f32
        # (and dl in the backward), nothing more
        assert fwd == attention_smem(24, 22, bf16)
        assert bwd > 2 * 24 * 24 * 4


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n", [1, 5, 24, 32, 33, 64, 128, 255, 256])
def test_backward_layout_takes_every_f_the_first_design_took(n, bf16):
    """The redesigned backward takes every feature count the first design
    took at each N: its partials come in chunks of features where F is
    large."""
    f_max = max(f for f in range(1, 700)
                if first_backward_smem(n, f, bf16) <= MAX_SMEM_BYTES)
    for f in (1, 22, f_max):
        assert attention_backward_smem(n, f, bf16) <= MAX_SMEM_BYTES, \
            (n, f, bf16)


# ------------------------------------------------------------- slot order
def test_slot_order_sum_is_sequential_f32():
    rng = np.random.default_rng(0)
    differs = 0
    for trial in range(200):
        vals = np.where(rng.uniform(size=(3, 128)) < 0.1,
                        rng.normal(5.0, 1.0, size=(3, 128)),
                        0.0).astype(np.float32)
        got = slot_order_sum(torch.from_numpy(vals)).numpy()
        want = np.zeros(3, np.float32)
        for row in range(3):
            for x in vals[row]:
                want[row] = np.float32(want[row] + x)
        np.testing.assert_array_equal(got, want)
        differs += int((torch.from_numpy(vals).sum(-1).numpy() != want)
                       .any())
    # the vectorised sum adds in another order and differs somewhere
    assert differs > 0


def test_slot_sums_case_has_order_dependent_sums():
    """The battery case the card holds kernel #2 to bit for bit: some
    substep adds three or more fractional processing delays."""
    case = cases.slot_sums_case(batch=2, intervals=1)
    eng, b = case.engine, case.batch
    state = eng.init(b, "cpu")
    state, cap = eng.begin_interval(state, case.traffic.expand(b),
                                    case.schedule, case.placement)
    z = case.noise(0)
    most = 0
    for k in range(eng.substeps):
        m0 = state.metrics
        n0, s0 = m0.num_proc_delay.clone(), m0.sum_proc_delay.clone()
        state = eng.substep(state, case.topo.expand(b),
                            case.traffic.expand(b), cap, z[:, k])
        d = state.metrics.sum_proc_delay - s0
        frac = d != torch.round(d)
        most = max(most, int(((state.metrics.num_proc_delay - n0)
                              * frac).max()))
    assert most >= 3
    # the interval through the megakernel's wrapper (its plain version on
    # the CPU) is the plain version's, bit for bit
    a = cases.run_case(case, "cpu")[-1]
    p = cases.run_case(case, "cpu", plain=True)[-1]
    assert cases.bit_equal(a, p)


def test_slot_sums_case_matches_jax():
    """The engine's CPU parity with the JAX package's, at
    tests/test_torch_substep.py's tolerance, on stochastic delays under
    "overhead"."""
    _run_both(cases.slot_sums_case(batch=2, intervals=2))


def test_interroute_and_rung5_intervals_run_plain():
    """One interval of each large stack through the plain version: flows
    generated, slots of the 1024 in use, counters consistent."""
    for case in (cases.interroute_case(batch=1), cases.rung5_case(batch=1)):
        st = cases.run_case(case, "cpu")[-1]
        m = st.metrics
        assert int(m.generated[0]) > 0
        assert int(m.active[0]) == int(m.generated[0] - m.processed[0]
                                       - m.dropped[0])
        assert int((st.flows.phase[0] != 0).sum()) == int(m.active[0])
        assert case.engine.M == 1024


# -------------------------------------------------------------------- CLI
TINY_AGENT = ("GNN_features: 4\nGNN_num_layers: 1\nGNN_num_iter: 1\n"
              "episode_steps: 2\nactor_hidden_layer_nodes: [8]\n"
              "critic_hidden_layer_nodes: [8]\nbatch_size: 4\nmem_limit: 8\n"
              "nb_steps_warmup_critic: 2\ngnn_impl: pallas\n"
              "factored_head: true\nfactored_key_dim: 4\n")
TINY_SIM = ("inter_arrival_mean: 5.0\ndeterministic_arrival: true\n"
            "deterministic_size: true\nflow_dr_mean: 1.0\n"
            "flow_dr_stdev: 0.0\nflow_size_shape: 0.001\nrun_duration: 5\n"
            "ttl_choices: [100]\nmax_flows: 32\n")
MIXED = ("sfc_list:\n  sfc_1: [a, b, c]\n  sfc_2: [d, e]\nsf_list:\n"
         + "".join(f"  {n}:\n    processing_delay_mean: {d}\n"
                   "    processing_delay_stdev: 0.0\n"
                   for n, d in zip("abcde", (5.0, 5.0, 5.0, 8.0, 2.0))))


def test_cli_takes_interroute_with_factored_heads():
    args = cli._parser().parse_args(["train", "--device", "cpu", "--network",
                                     "interroute", "--max-nodes", "128",
                                     "--max-edges", "192"])
    env, driver, agent = cli._build(args, None)
    assert env.limits.action_dim == 128 * 1 * 3 * 128
    assert int(driver.topology_for(0).node_mask.sum()) == 110
    from gsc_tpu_torch.models.nets import use_factored_head
    assert use_factored_head(agent, env.limits.action_dim)
    with pytest.raises(SystemExit):
        cli._parser().parse_args(["train", "--network", "nowhere"])


def test_cli_trains_and_serves_a_graphml_network(tmp_path, capsys):
    pytest.importorskip("yaml")
    net = tmp_path / "rand8.graphml"
    synthetic.write_graphml(synthetic.random_network(8, num_ingress=2,
                                                     seed=2), str(net))
    (tmp_path / "agent.yaml").write_text(TINY_AGENT)
    (tmp_path / "sim.yaml").write_text(TINY_SIM)
    (tmp_path / "mixed.yaml").write_text(MIXED)
    common = ["--device", "cpu", "--agent-config",
              str(tmp_path / "agent.yaml"), "--simulator-config",
              str(tmp_path / "sim.yaml"), "--service",
              str(tmp_path / "mixed.yaml"), "--network", str(net),
              "--max-nodes", "12", "--max-edges", "16"]
    out = cli.run_train(["--replicas", "2", "--chunk", "2", "--episodes",
                         "1", "--result-dir", str(tmp_path / "r")] + common)
    assert math.isfinite(out["eval"]["mean_return"])
    assert out["state"].actor.factored and out["state"].critic.factored
    capsys.readouterr()
    assert cli.main(["serve", "--requests", "4", "--concurrency", "2",
                     "--pool-steps", "2", "--checkpoint",
                     out["summary"]["checkpoint"]] + common) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["completed"] == 4 and summary["errors"] == 0
