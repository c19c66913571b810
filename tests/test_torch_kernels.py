"""The fused GATv2 attention kernels' wrappers (forward and backward),
without JAX.

This file imports torch and the port only, so it also runs on the card,
where JAX is absent (``python -m pytest --noconftest
tests/test_torch_kernels.py -q``).  On the CPU each wrapper runs its plain
version and counts no launch, and ``launch`` refuses CPU tensors; on the
card (marker ``cuda``) the forward kernel is held against its plain
version at the serving shapes and one N > 32 case, and the backward kernel
against ``attention_backward_plain`` at the shapes of
tests/test_torch_gat_backward.py and the learn burst's (100, 24, 22), the
latter also with a saturated softmax; two backward launches on the same
inputs must give the same bits.  Both backward forms are also held, at
both aggregations and on unit-normal and saturated inputs, at the sizes
where the backward kernels change shape (``EDGE_N``: 1, 2, 31, 32, 33, 96,
255, 256 nodes) at batch 1 and at a batch whose last wave of CTAs is not
full; with every row isolated (all gradients 0); and relaunched bit for
bit at N = 24, 128 and 256 at the learn bursts' batch of 100.  At
interroute's N = 128 and rung 5's 256
(graphs cut into tiles of 32 target rows) all four forms are held to the
same tolerances and relaunched bit for bit, and the substep megakernel
runs one interroute interval bit-equal to its plain version.

Tolerances.  Forward: rtol 1e-5, atol 1e-5 — f32, summed in another order
than the plain einsums: with unit-normal inputs the logits sum 22
products, and their ~1e-6 relative rounding differences pass through exp
and the weighted sum into up to ~1e-5 absolute on outputs of a few units
(sum aggregation reaches |out| ~5).  ``chip_smoke.py`` checks on the card
that the kernel's distance to a float64 evaluation stays of the plain
version's order.  Rows without a neighbour must be exactly zero.
Backward, per output tensor: the largest difference within 1e-5 of the
tensor's largest entry plus 1e-5.  An f32 gradient entry is a sum of up
to N·F terms (d_att and d_bias over every graph of the batch) of the size
of the tensor's largest entries, each carrying the forward's rounding, so
its error scales with the tensor, not with the entry: the plain version
lies up to ~5e-5 from a float64 evaluation on d_att entries of ~100 at
(100, 24, 22), and an entry near 0 carries as much.  ``d_xr`` of a row
without a neighbour must be exactly zero.

The bf16 kernels (``gat_attention_bf16``, ``gat_attention_backward_bf16``)
take bf16 features and round where their plain versions round
(``ops.gat.attention_bf16``, ``attention_backward_wide``); their sums run
in another order.  Tolerance of a bf16 output (the forward's, d_xl, d_xr):
one bf16 ulp at the tensor's largest entry (2^(e-7) for a largest entry
in [2^e, 2^(e+1))).  Two f32 values a rounding apart may round to
neighbouring bf16 values, and a weight alpha_ij a rounding apart may round
to a neighbouring bf16 weight, which moves an output by at most 2^-9 of
an xl entry.  Each such output must also lie no further from a float64
evaluation at the same rounding points than twice the plain version's
distance (floored at a quarter of that ulp).  d_xl and d_xr also keep the
f32 backward's absolute floor (BWD_ATOL, and F64_FLOOR for the float64
comparison): where the softmax saturates, d_xr is ~1e-12 everywhere, the
f32 rounding of dl, and one ulp at its largest entry lies below that
(on an NVIDIA H100: 6.5e-13 against an ulp of 7.1e-15).  d_att and
d_bias are f32 sums, held as the f32 kernel's.
"""
import math

import numpy as np
import pytest
import torch

from gsc_tpu_torch.ops.gat import attention_bf16
from gsc_tpu_torch.ops.gat_attention import (GatAttention,
                                             GatAttentionBackward,
                                             attention_backward_plain,
                                             attention_backward_wide,
                                             attention_op, attention_plain,
                                             backward_op, gat_attention,
                                             gat_attention_backward,
                                             gat_attention_backward_bf16,
                                             gat_attention_bf16)
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5
BWD_SCALE, BWD_ATOL = 1e-5, 1e-5
F64_FLOOR = 1e-7
# (lead, N, F) of the backward's cases: N = 5 tiny, the flagship's 24,
# and 40 > 32 (more than one warp of source nodes per row)
BWD_CASES = [(lead, n, f) for lead in [(), (3,), (2, 3)]
             for n, f in [(5, 3), (24, 22), (40, 22)]]


def make_inputs(lead, n, f, seed, n_pad=3, n_isolated=2):
    """xl, xr, att, bias, adj with ``n_pad`` padded nodes (no edges at
    all) and ``n_isolated`` further rows whose adjacency row is empty."""
    rng = np.random.default_rng(seed)
    xl = rng.normal(size=lead + (n, f)).astype(np.float32)
    xr = rng.normal(size=lead + (n, f)).astype(np.float32)
    att = rng.normal(size=(f,)).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    adj = rng.uniform(size=lead + (n, n)) < 0.3
    real = n - n_pad
    adj[..., np.arange(real), np.arange(real)] = True       # self-loops
    adj[..., real:, :] = False
    adj[..., :, real:] = False
    adj[..., :n_isolated, :] = False
    return xl, xr, att, bias, adj


# graph sizes at the backward kernels' edges: one node, two, a warp of
# source nodes and one past it (the last one-CTA graph, then the first
# cluster, of 2 CTAs), a 3-CTA cluster, and the largest clusters (8 CTAs,
# the last one row short and full)
EDGE_N = [1, 2, 31, 32, 33, 96, 255, 256]


def make_edge_inputs(lead, n, f, seed):
    """``make_inputs`` for any n >= 1 (three padded nodes and two rows
    without a neighbour from n = 3 on, one such row at n = 2, none at n =
    1) with a numpy-seeded grad_out."""
    xl, xr, att, bias, adj = make_inputs(
        lead, n, f, seed, n_pad=3 if n >= 3 else 0,
        n_isolated=2 if n >= 3 else n - 1)
    grad = np.random.default_rng(seed + 1).normal(
        size=xl.shape).astype(np.float32)
    return xl, xr, att, bias, adj, grad


def make_backward_inputs(lead, n, f, seed):
    """``make_inputs`` (one padded node and one empty row below N = 8)
    with an edge i -> j where xl_j + xr_i is exactly 0 in up to three
    features (LeakyReLU'(0) = 1 there), and a numpy-seeded grad_out."""
    small = n < 8
    xl, xr, att, bias, adj = make_inputs(lead, n, f, seed,
                                         n_pad=1 if small else 3,
                                         n_isolated=1 if small else 2)
    i, j = (1, 2) if small else (2, 3)
    adj[..., i, j] = True
    xr[..., i, :3] = -xl[..., j, :3]
    grad = np.random.default_rng(seed + 1).normal(
        size=xl.shape).astype(np.float32)
    return xl, xr, att, bias, adj, grad


def make_saturated_inputs(lead, n, f, seed, gap=12.0):
    """``make_backward_inputs``' graphs with features that saturate the
    softmax, as trained weights do: att = 1/F and xl_j = 100 + U(0, 10) +
    gap * rank_j (a random rank per source node), xr in U(0, 1), so each
    row's logits lie ~gap apart and its largest weight is 1 - ~e^-gap;
    grad_out 0.2 N(0, 1)."""
    _, _, _, bias, adj, _ = make_backward_inputs(lead, n, f, seed)
    rng = np.random.default_rng(seed + 7)
    att = np.full((f,), 1.0 / f, np.float32)
    rank = np.argsort(rng.uniform(size=lead + (n,)), axis=-1)
    xl = (100.0 + rng.uniform(0, 10, size=lead + (n, f))
          + gap * rank[..., None]).astype(np.float32)
    xr = rng.uniform(0, 1, size=lead + (n, f)).astype(np.float32)
    grad = (0.2 * rng.normal(size=lead + (n, f))).astype(np.float32)
    return xl, xr, att, bias, adj, grad



def _port(xl, xr, att, bias, adj, mean):
    t = torch.from_numpy
    return attention_plain(t(xl), t(xr), t(att), t(bias), t(adj),
                           mean).numpy()


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    xl, xr, att, bias, adj = make_inputs((2,), 24, 22, seed=7)
    t = torch.from_numpy
    op = GatAttention()
    out = op(t(xl), t(xr), t(att), t(bias), t(adj), True)
    np.testing.assert_array_equal(out.numpy(),
                                  _port(xl, xr, att, bias, adj, True))
    assert op.launches == 0



def test_launch_refuses_cpu_tensors():
    """The kernel path never takes CPU tensors (no hidden fallback)."""
    args = [torch.from_numpy(a) for a in make_inputs((1,), 24, 22, seed=1)]
    op = GatAttention()
    with pytest.raises(ValueError, match="CUDA"):
        op.launch(*args, True)
    assert op.launches == 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card, f32, at the
    serving shapes and one N > 32 case."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU "
                    "mode; its plain version is tested above)")
    for lead, n, f in [((1,), 24, 22), ((8,), 24, 22), ((100,), 24, 22),
                       ((4,), 64, 22)]:
        for mean in (True, False):
            args = [torch.from_numpy(a).cuda()
                    for a in make_inputs(lead, n, f, seed=n + f)]
            before = gat_attention.launches
            got = gat_attention(*args, mean)
            torch.cuda.synchronize()
            assert gat_attention.launches == before + 1
            want = attention_plain(*args, mean)
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            empty = ~args[4].any(dim=-1)
            assert torch.all(got[empty] == 0)


def test_backward_wrapper_on_cpu_runs_plain_and_counts_nothing():
    xl, xr, att, _, adj, grad = (torch.from_numpy(a) for a in
                                 make_backward_inputs((2,), 24, 22, seed=7))
    op = GatAttentionBackward()
    got = op(grad, xl, xr, att, adj, True)
    want = attention_backward_plain(grad, xl, xr, att, adj, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert op.launches == 0


def test_backward_launch_refuses_cpu_tensors():
    """The backward kernel's path never takes CPU tensors either."""
    xl, xr, att, _, adj, grad = (torch.from_numpy(a) for a in
                                 make_backward_inputs((1,), 24, 22, seed=1))
    op = GatAttentionBackward()
    with pytest.raises(ValueError, match="CUDA"):
        op.launch(grad, xl, xr, att, adj, True)
    assert op.launches == 0


def _card_backward_inputs(lead, n, f, seed, saturated=False):
    make = make_saturated_inputs if saturated else make_backward_inputs
    xl, xr, att, _, adj, grad = (torch.from_numpy(a).cuda() for a in
                                 make(lead, n, f, seed))
    return grad, xl, xr, att, adj


@pytest.mark.cuda
def test_backward_kernel_matches_plain_on_card():
    """The backward kernel against ``attention_backward_plain`` on the
    card, at the CPU test's shapes and the learn burst's, the latter also
    with a saturated softmax."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU "
                    "mode; its plain version is tested above)")
    cases = [(lead, n, f, False) for lead, n, f in BWD_CASES]
    cases += [((100,), 24, 22, False), ((100,), 24, 22, True)]
    for lead, n, f, saturated in cases:
        for mean in (True, False):
            args = _card_backward_inputs(lead, n, f, seed=n * 31 + f,
                                         saturated=saturated)
            before = gat_attention_backward.launches
            got = gat_attention_backward(*args, mean)
            torch.cuda.synchronize()
            assert gat_attention_backward.launches == before + 1
            want = attention_backward_plain(*args, mean)
            for g, w in zip(got, want):
                assert g.shape == w.shape
                err = float((g - w).abs().max())
                assert err <= BWD_SCALE * float(w.abs().max()) + BWD_ATOL, \
                    (lead, n, f, mean, err)
            empty = ~args[4].any(dim=-1)
            assert torch.all(got[1][empty] == 0)


@pytest.mark.cuda
def test_backward_kernel_relaunch_is_bit_identical():
    """No float atomics: two launches on the same inputs give the same
    bits, d_att and d_bias (summed across graphs) included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    for lead in [(100,), (2, 3)]:
        args = _card_backward_inputs(lead, 24, 22, seed=5)
        first = gat_attention_backward.launch(*args, True)
        again = gat_attention_backward.launch(*args, True)
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


# ---------------------------------------------------------------- bf16
def bf16_ulp(t: torch.Tensor) -> float:
    """One bf16 ulp at the largest magnitude of ``t``."""
    m = float(t.abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 2.0 ** -133


def _bf16(args):
    xl, xr = args[0], args[1]
    return [xl.bfloat16(), xr.bfloat16(), *args[2:]]


def test_bf16_wrappers_on_cpu_run_plain_and_count_nothing():
    t = torch.from_numpy
    xl, xr, att, bias, adj = _bf16([t(a) for a in
                                    make_inputs((2,), 24, 22, seed=7)])
    assert attention_op(torch.bfloat16) is gat_attention_bf16
    assert attention_op(torch.float32) is gat_attention
    assert backward_op(torch.bfloat16) is gat_attention_backward_bf16
    op = GatAttention(dtype=torch.bfloat16)
    out = op(xl, xr, att, bias, adj, True)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, attention_plain(xl, xr, att, bias, adj, True))
    grad = torch.randn(xl.shape, generator=torch.Generator().manual_seed(0)
                       ).bfloat16()
    bop = GatAttentionBackward(dtype=torch.bfloat16)
    got = bop(grad, xl, xr, att, adj, True)
    assert [g.dtype for g in got] == [torch.bfloat16] * 2 + [torch.float32] * 2
    for g, w in zip(got, attention_backward_plain(grad, xl, xr, att, adj,
                                                  True)):
        assert torch.equal(g, w)
    assert op.launches == bop.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        op.launch(xl, xr, att, bias, adj, True)
    with pytest.raises(TypeError):
        GatAttention(dtype=torch.float16)


@pytest.mark.cuda
def test_bf16_kernel_matches_plain_on_card():
    """The bf16 forward kernel against ``attention_plain`` (its bf16
    branch) on the card: within one bf16 ulp of each tensor's largest
    entry, and no further from float64 than twice the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU "
                    "mode; its plain version is tested in "
                    "tests/test_torch_precision.py)")
    for lead, n, f in [((1,), 24, 22), ((8,), 24, 22), ((100,), 24, 22),
                       ((4,), 64, 22), ((3,), 5, 3)]:
        for mean in (True, False):
            args = _bf16([torch.from_numpy(a).cuda()
                          for a in make_inputs(lead, n, f, seed=n + f,
                                               n_pad=1 if n < 8 else 3,
                                               n_isolated=1 if n < 8 else 2)])
            before = gat_attention_bf16.launches
            got = gat_attention_bf16(*args, mean)
            torch.cuda.synchronize()
            assert gat_attention_bf16.launches == before + 1
            assert got.dtype == torch.bfloat16
            want = attention_plain(*args, mean)
            ulp = bf16_ulp(want.float())
            err = float((got.float() - want.float()).abs().max())
            assert err <= ulp, (lead, n, f, mean, err, ulp)
            ref = attention_bf16(*args, mean, wide=torch.float64)
            k64 = float((got.double() - ref).abs().max())
            p64 = float((want.double() - ref).abs().max())
            assert k64 <= 2.0 * max(p64, ulp / 4), (lead, n, f, k64, p64)
            empty = ~args[4].any(dim=-1)
            assert torch.all(got[empty] == 0)


@pytest.mark.cuda
def test_bf16_backward_kernel_matches_plain_on_card():
    """The bf16 backward kernel against ``attention_backward_plain`` (its
    bf16 form) on the card, the saturated learn-burst case included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    cases = [(lead, n, f, False) for lead, n, f in BWD_CASES]
    cases += [((100,), 24, 22, False), ((100,), 24, 22, True)]
    for lead, n, f, saturated in cases:
        for mean in (True, False):
            grad, xl, xr, att, adj = _card_backward_inputs(
                lead, n, f, seed=n * 31 + f, saturated=saturated)
            args = (grad.bfloat16(), xl.bfloat16(), xr.bfloat16(), att, adj)
            before = gat_attention_backward_bf16.launches
            got = gat_attention_backward_bf16(*args, mean)
            torch.cuda.synchronize()
            assert gat_attention_backward_bf16.launches == before + 1
            want = attention_backward_plain(*args, mean)
            ref = attention_backward_wide(*args, mean, torch.float64)
            for k, (g, w, r) in enumerate(zip(got, want, ref)):
                assert g.shape == w.shape and g.dtype == w.dtype
                err = float((g.float() - w.float()).abs().max())
                if k < 2:
                    ulp = bf16_ulp(w.float())
                    assert err <= ulp + BWD_ATOL, (lead, n, f, mean, k, err,
                                                   ulp)
                    k64 = float((g.double() - r).abs().max())
                    p64 = float((w.double() - r).abs().max())
                    assert k64 <= 2.0 * max(p64, ulp / 4, F64_FLOOR), \
                        (k, k64, p64)
                else:
                    assert err <= BWD_SCALE * float(w.abs().max()) \
                        + BWD_ATOL, (lead, n, f, mean, k, err)
            empty = ~adj.any(dim=-1)
            assert torch.all(got[1][empty] == 0)


@pytest.mark.cuda
def test_bf16_backward_kernel_relaunch_is_bit_identical():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    for lead in [(100,), (2, 3)]:
        grad, xl, xr, att, adj = _card_backward_inputs(lead, 24, 22, seed=5)
        args = (grad.bfloat16(), xl.bfloat16(), xr.bfloat16(), att, adj)
        first = gat_attention_backward_bf16.launch(*args, True)
        again = gat_attention_backward_bf16.launch(*args, True)
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


# ---------------------------------------------- large graphs (N > 32)
# interroute's N = 128 and rung 5's 256: a graph spans 4 and 8 CTAs of 32
# target rows, the backward's as one thread block cluster
LARGE = [((4,), 128, 22), ((4,), 256, 22)]
# a kernel's distance to float64 against its plain version's
F64_RATIO = 4.0


@pytest.mark.cuda
def test_all_four_forms_match_plain_at_large_n():
    """The forward and backward kernels, f32 and bf16, at N = 128 and 256
    against their plain versions, at this file's tolerances, the
    saturated softmax included; d_xr 0 on rows without a neighbour.
    Where the softmax saturates, d_att and d_bias sum terms far larger
    than themselves (act ~ 10^3) over N^2 pairs, and the plain version's
    f32 sums are the less accurate side (on an NVIDIA H100 at N = 256,
    mean aggregation, bf16: kernel 5.8e-7, plain 2.2e-6 from a float64
    evaluation), so there the two are held to float64 instead: the
    kernel no further from it than F64_RATIO times the plain version
    (floored at F64_FLOOR), as tests/test_torch_gat_backward.py holds
    saturated gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    for lead, n, f in LARGE:
        for saturated in (False, True):
            for mean in (True, False):
                grad, xl, xr, att, adj = _card_backward_inputs(
                    lead, n, f, seed=n + 13, saturated=saturated)
                bias = torch.from_numpy(np.random.default_rng(n).normal(
                    size=(f,)).astype(np.float32)).cuda()
                for dt in (torch.float32, torch.bfloat16):
                    ins = (grad.to(dt), xl.to(dt), xr.to(dt))
                    fwd, bwd = attention_op(dt), backward_op(dt)
                    out = fwd.launch(ins[1], ins[2], att, bias, adj, mean)
                    got = bwd.launch(*ins, att, adj, mean)
                    torch.cuda.synchronize()
                    want = attention_plain(ins[1], ins[2], att, bias, adj,
                                           mean)
                    plain = attention_backward_plain(*ins, att, adj, mean)
                    what = (n, saturated, mean, dt)
                    if dt == torch.float32:
                        torch.testing.assert_close(out, want, rtol=RTOL,
                                                   atol=ATOL)
                    else:
                        err = float((out.float() - want.float()).abs().max())
                        assert err <= bf16_ulp(want.float()), (what, err)
                    assert torch.all(out[~adj.any(dim=-1)] == 0)
                    if dt == torch.float32:
                        ref = attention_backward_plain(
                            grad.double(), xl.double(), xr.double(),
                            att.double(), adj, mean)
                    else:
                        ref = attention_backward_wide(*ins, att, adj, mean,
                                                      torch.float64)
                    for k, (g, w, r) in enumerate(zip(got, plain, ref)):
                        assert g.shape == w.shape and g.dtype == w.dtype
                        if saturated and k >= 2:
                            k64 = float((g.double() - r).abs().max())
                            p64 = float((w.double() - r).abs().max())
                            assert k64 <= F64_RATIO * max(p64, F64_FLOOR), \
                                (what, k, k64, p64)
                            continue
                        err = float((g.float() - w.float()).abs().max())
                        bound = BWD_SCALE * float(w.abs().max()) + BWD_ATOL
                        if dt == torch.bfloat16 and k < 2:
                            bound = bf16_ulp(w.float()) + BWD_ATOL
                        assert err <= bound, (what, k, err, bound)
                    assert torch.all(got[1][~adj.any(dim=-1)] == 0)


@pytest.mark.cuda
def test_large_n_relaunch_is_bit_identical():
    """At N = 256 (a cluster of 8 CTAs per graph in the backward, per-CTA
    partials of d_att and d_bias) two launches give the same bits, in
    both dtypes, forward and backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    grad, xl, xr, att, adj = _card_backward_inputs((4,), 256, 22, seed=9)
    bias = torch.zeros(22, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        ins = (grad.to(dt), xl.to(dt), xr.to(dt))
        for op, args in ((attention_op(dt), (ins[1], ins[2], att, bias,
                                             adj, True)),
                         (backward_op(dt), (*ins, att, adj, True))):
            first = op.launch(*args)
            again = op.launch(*args)
            torch.cuda.synchronize()
            first = first if isinstance(first, tuple) else (first,)
            again = again if isinstance(again, tuple) else (again,)
            for a, b in zip(first, again):
                assert torch.equal(a, b), (dt, op.entry)


def _tail_batch(n):
    """One graph more than 132 SMs hold at one CTA each: the last wave (or
    cluster wave) is not full."""
    return 132 // math.ceil(n / 32) + 1


def _hold_backward(ins, att, adj, mean, saturated, what):
    """Both backward forms on these f32 inputs against their plain
    versions at this file's tolerances (on a saturated softmax above 32
    nodes d_att and d_bias against float64, as
    test_all_four_forms_match_plain_at_large_n says why); d_xr 0 on rows
    without a neighbour."""
    grad, xl, xr = ins
    empty = ~adj.any(dim=-1)
    for dt in (torch.float32, torch.bfloat16):
        fin = tuple(t.to(dt) for t in ins)
        op = backward_op(dt)
        before = op.launches
        got = op(*fin, att, adj, mean)
        torch.cuda.synchronize()
        assert op.launches == before + 1
        plain = attention_backward_plain(*fin, att, adj, mean)
        if dt == torch.float32:
            ref = attention_backward_plain(grad.double(), xl.double(),
                                           xr.double(), att.double(), adj,
                                           mean)
        else:
            ref = attention_backward_wide(*fin, att, adj, mean,
                                          torch.float64)
        for k, (g, w, r) in enumerate(zip(got, plain, ref)):
            assert g.shape == w.shape and g.dtype == w.dtype, (what, dt, k)
            k64 = float((g.double() - r).abs().max())
            p64 = float((w.double() - r).abs().max())
            if saturated and adj.shape[-1] > 32 and k >= 2:
                assert k64 <= F64_RATIO * max(p64, F64_FLOOR), \
                    (what, dt, k, k64, p64)
                continue
            err = float((g.float() - w.float()).abs().max())
            bound = BWD_SCALE * float(w.float().abs().max()) + BWD_ATOL
            if dt == torch.bfloat16 and k < 2:
                ulp = bf16_ulp(w.float())
                bound = ulp + BWD_ATOL
                assert k64 <= 2.0 * max(p64, ulp / 4, F64_FLOOR), \
                    (what, dt, k, k64, p64)
            else:
                assert k64 <= F64_RATIO * max(p64, F64_FLOOR), \
                    (what, dt, k, k64, p64)
            assert err <= bound, (what, dt, k, err, bound)
        assert torch.all(got[1][empty] == 0), (what, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_N)
def test_backward_kernels_at_edge_sizes_on_card(n):
    """Both backward forms where the kernels change shape (one CTA per
    graph up to 32 nodes, then clusters of 2, 3 and 8 CTAs), at batch 1
    and at a batch whose last wave is not full, both aggregations, unit-
    normal and saturated inputs, against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU "
                    "mode; its plain version is tested in "
                    "tests/test_torch_gat_backward.py)")
    c = lambda a: torch.from_numpy(a).cuda()
    for b in (1, _tail_batch(n)):
        for saturated in (False, True):
            if saturated and n < 3:
                continue
            for mean in (True, False):
                make = make_saturated_inputs if saturated \
                    else make_edge_inputs
                xl, xr, att, _, adj, grad = make((b,), n, 22, seed=n + b)
                _hold_backward((c(grad), c(xl), c(xr)), c(att), c(adj), mean,
                               saturated, (n, b, saturated, mean))


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", [(32, 200), (256, 56), (256, 40)])
def test_backward_kernels_in_feature_chunks_on_card(n, f):
    """Feature counts whose partials do not fit one CTA's shared memory at
    once run in chunks of features (at (32, 200) both forms, at (256, 56)
    the f32 form; (256, 40) is the bf16 form's largest at 256 nodes in the
    first design), against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    c = lambda a: torch.from_numpy(a).cuda()
    for mean in (True, False):
        xl, xr, att, _, adj, grad = make_edge_inputs((3,), n, f, seed=n + f)
        ins = (c(grad), c(xl), c(xr))
        if (n, f) == (256, 56):
            got = gat_attention_backward(*ins, c(att), c(adj), mean)
            want = attention_backward_plain(*ins, c(att), c(adj), mean)
            for g, w in zip(got, want):
                err = float((g - w).abs().max())
                assert err <= BWD_SCALE * float(w.abs().max()) + BWD_ATOL, \
                    (n, f, mean, err)
            continue
        _hold_backward(ins, c(att), c(adj), mean, False, (n, f, mean))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24, 40, 128])
def test_backward_kernels_with_every_row_isolated_on_card(n):
    """No row has a neighbour: every gradient of both forms is 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    xl, xr, att, _, _, grad = make_edge_inputs((5,), n, 22, seed=n)
    c = lambda a: torch.from_numpy(a).cuda()
    adj = torch.zeros(5, n, n, dtype=torch.bool, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        for mean in (True, False):
            got = backward_op(dt).launch(c(grad).to(dt), c(xl).to(dt),
                                         c(xr).to(dt), c(att), adj, mean)
            torch.cuda.synchronize()
            for g in got:
                assert torch.all(g == 0), (n, dt, mean)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24, 128, 256])
def test_backward_relaunch_is_bit_identical_at_learn_burst_batch(n):
    """At the learn bursts' batch of 100 graphs, two launches of either
    backward form give the same bits, d_att and d_bias included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    grad, xl, xr, att, adj = _card_backward_inputs((100,), n, 22, seed=n)
    for dt in (torch.float32, torch.bfloat16):
        ins = (grad.to(dt), xl.to(dt), xr.to(dt), att, adj, True)
        first = backward_op(dt).launch(*ins)
        again = backward_op(dt).launch(*ins)
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b), (n, dt)


@pytest.mark.cuda
def test_megakernel_interroute_interval_is_bit_equal():
    """Kernel #2 at bench.py's interroute stack (M = 1024 slots, N = 128,
    E = 192): one interval bit-equal to its plain version on CPU copies,
    and a relaunch bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from gsc_tpu_torch.ops.substep import substep_megakernel
    from gsc_tpu_torch.sim import cases

    case = cases.interroute_case(batch=2, intervals=1)
    before = substep_megakernel.launches
    got = cases.run_case(case, "cuda")[-1]
    assert substep_megakernel.launches == before + 1
    want = cases.run_case(case, "cpu", plain=True)[-1]
    assert cases.bit_equal(got.to("cpu"), want)
    assert cases.bit_equal(cases.run_case(case, "cuda")[-1], got)
