"""The attention stage's gradient: the port's closed form against the JAX
package's.

``attention_backward_plain`` (the backward kernel's plain version, the
gradient written without autograd) is held against ``jax.vjp`` of the
Pallas kernel ``gatv2_pallas`` (interpret mode, as tests/test_torch_gat.py
runs it on the CPU; its custom VJP takes the dense VJP) and against torch
autograd of ``attention_plain``, on numpy-seeded inputs: lead dims (),
(3,) and (2, 3); (N, F) of (5, 3), (24, 22) and (40, 22) (more than one
warp of source nodes); mean and sum aggregation; padded nodes and rows
without a neighbour, whose ``d_xr`` rows must be exactly 0 and whose
grad_out must add nothing to ``d_bias``; and an edge where xl + xr is
exactly 0 in three features, where LeakyReLU'(0) = 1 as both frameworks'
``where(e >= 0, ...)`` take it.

A second test holds the closed form where the softmax saturates, as
trained weights make it (logits 8-16 apart, a largest weight of 1 - e^-8
to 1 - e^-16): there an f32 evaluation of the textbook dl = alpha (dalpha
- sum alpha dalpha) cancels to its rounding, off by more than the gradient
itself.  So does the JAX package's dense VJP in f32, which stops the
gradient at the row max; torch autograd of ``attention_plain``, whose
gradient through the row max cancels that rounding, stays accurate.  The
closed form, in f32, must lie no further from a float64 evaluation than 4
times torch autograd in f32 does (floored at 1e-6), per output.

A third holds the closed form against the JAX VJP at the sizes where the
backward kernels change shape (N = 1, 2, 31, 32, 33, 96, 255, 256: one
CTA per graph up to 32 nodes, then clusters of CTAs of 32 target rows)
and where every row lacks a neighbour (every gradient 0).  Its tolerance
is the backward kernels' (tests/test_torch_kernels.py): per output
tensor, the largest difference within 1e-5 of the tensor's largest entry
plus 1e-5, since at N = 256 an entry sums up to N F terms of the
tensor's scale in each side's own f32 order (measured: d_att under sum
aggregation at N = 256, 4.7e-4 apart on entries up to 81; elementwise
rtol 1e-4 fails there, as at N = 96 and 255).

Tolerance of the first test: rtol 1e-4, atol 1e-5.  Each side is an f32
evaluation in its own order: a gradient entry is a sum of up to N·F
products (d_att and d_bias over every graph and row of the batch), each
carrying the forward's rounding (logits of 22 products through exp and the
softmax), so the two differ by a few units of 1e-6 relative to an entry's
terms, not to the entry: measured at these shapes, autograd's and the
closed form's distances to a float64 evaluation stay within a third of
this tolerance.
"""
import jax
import numpy as np
import pytest
import torch

from gsc_tpu.ops.pallas_gat import gatv2_pallas

from gsc_tpu_torch.ops.gat_attention import (attention_backward_plain,
                                             attention_plain)
from test_torch_kernels import (BWD_CASES, BWD_ATOL, BWD_SCALE, EDGE_N,
                                make_backward_inputs, make_edge_inputs,
                                make_saturated_inputs)
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
NAMES = ("d_xl", "d_xr", "d_att", "d_bias")


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("lead,n,f", BWD_CASES)
def test_backward_plain_matches_jax_vjp_and_autograd(lead, n, f, mean):
    xl, xr, att, bias, adj, grad = make_backward_inputs(lead, n, f,
                                                        seed=n * 31 + f)
    adj_j = jax.numpy.asarray(adj)
    _, vjp = jax.vjp(lambda a, b, c, d: gatv2_pallas(a, b, c, d, adj_j, mean,
                                                     None, True),
                     xl, xr, att, bias)
    jax_grads = [np.asarray(g) for g in vjp(grad)]
    t = torch.from_numpy
    got = [g.numpy() for g in attention_backward_plain(
        t(grad), t(xl), t(xr), t(att), t(adj), mean)]
    ins = [t(a).requires_grad_(True) for a in (xl, xr, att, bias)]
    auto = torch.autograd.grad(attention_plain(*ins, t(adj), mean), ins,
                               t(grad))
    for name, g, j, a in zip(NAMES, got, jax_grads, auto):
        assert g.shape == j.shape, name
        np.testing.assert_allclose(g, j, rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(g, a.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    # the case holds what it is meant to: empty rows, exact zeros of e
    empty = ~adj.any(axis=-1)
    assert empty.any()
    i, j = (1, 2) if n < 8 else (2, 3)
    assert adj[..., i, j].all()
    assert (xl[..., j, :3] + xr[..., i, :3] == 0).all()
    assert np.all(got[1][empty] == 0.0)
    # grad_out on rows without a neighbour adds nothing to d_bias
    loud = grad.copy()
    loud[empty] = 1e6
    d_bias = attention_backward_plain(t(loud), t(xl), t(xr), t(att), t(adj),
                                      mean)[3].numpy()
    np.testing.assert_array_equal(d_bias, got[3])


@pytest.mark.parametrize("gap", [8.0, 12.0, 16.0])
@pytest.mark.parametrize("lead,n,f", [((100,), 24, 22), ((3,), 40, 22)])
def test_backward_plain_stays_accurate_when_the_softmax_saturates(lead, n, f,
                                                                 gap):
    xl, xr, att, bias, adj, grad = make_saturated_inputs(lead, n, f, seed=5,
                                                         gap=gap)
    t = torch.from_numpy
    got = attention_backward_plain(t(grad), t(xl), t(xr), t(att), t(adj),
                                   True)
    ins = [t(a).requires_grad_(True) for a in (xl, xr, att, bias)]
    auto = torch.autograd.grad(attention_plain(*ins, t(adj), True), ins,
                               t(grad))
    ref = attention_backward_plain(*(t(a).double() for a in
                                     (grad, xl, xr, att)), t(adj), True)
    for name, g, a, r in zip(NAMES, got, auto, ref):
        ours = float((g.double() - r).abs().max())
        dense = float((a.double() - r).abs().max())
        assert ours <= 4.0 * max(dense, 1e-6), (name, ours, dense)


def _jax_vjp(xl, xr, att, bias, adj, grad, mean):
    adj_j = jax.numpy.asarray(adj)
    _, vjp = jax.vjp(lambda a, b, c, d: gatv2_pallas(a, b, c, d, adj_j, mean,
                                                     None, True),
                     xl, xr, att, bias)
    return [np.asarray(g) for g in vjp(grad)]


def _assert_per_tensor(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, (what, name)
        err = float(np.abs(g - w).max()) if g.size else 0.0
        scale = float(np.abs(w).max()) if w.size else 0.0
        assert err <= BWD_SCALE * scale + BWD_ATOL, (what, name, err, scale)


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("n", EDGE_N)
def test_backward_plain_matches_jax_vjp_at_edge_sizes(n, mean):
    xl, xr, att, bias, adj, grad = make_edge_inputs((2,), n, 22,
                                                    seed=n * 7 + 3)
    t = torch.from_numpy
    got = [g.numpy() for g in attention_backward_plain(
        t(grad), t(xl), t(xr), t(att), t(adj), mean)]
    _assert_per_tensor(got, _jax_vjp(xl, xr, att, bias, adj, grad, mean),
                       (n, mean, "jax"))
    ins = [t(a).requires_grad_(True) for a in (xl, xr, att, bias)]
    auto = torch.autograd.grad(attention_plain(*ins, t(adj), mean), ins,
                               t(grad))
    _assert_per_tensor(got, [a.numpy() for a in auto], (n, mean, "autograd"))
    empty = ~adj.any(axis=-1)
    assert np.all(got[1][empty] == 0.0)


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("n", [24, 40])
def test_backward_plain_is_zero_when_every_row_is_isolated(n, mean):
    xl, xr, att, bias, _, grad = make_edge_inputs((3,), n, 22, seed=n)
    adj = np.zeros(xl.shape[:-1] + (n,), bool)
    t = torch.from_numpy
    got = [g.numpy() for g in attention_backward_plain(
        t(grad), t(xl), t(xr), t(att), t(adj), mean)]
    for name, g, j in zip(NAMES, got, _jax_vjp(xl, xr, att, bias, adj, grad,
                                               mean)):
        assert np.all(g == 0.0), name
        np.testing.assert_array_equal(j, 0.0, err_msg=name)
