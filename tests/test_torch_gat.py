"""The port's GATv2 attention stage against the JAX package's.

The port's plain attention (``attention_plain``, what the kernel wrapper
runs for CPU tensors) is held against the Pallas kernel ``gatv2_pallas``
(interpret mode, as tests/test_models.py runs it on the CPU) and against
``attention_dense``, on numpy-seeded inputs: a single graph, a batched
[2, 3, N, F] stack, mean and sum aggregation, padded nodes and rows with
no neighbour, and the flagship N=24, F=22 shape.  The port's
``dense_adj`` is held against the JAX one.

Tolerance: rtol 1e-5, atol 1e-6 (f32; the einsums may sum in another
order).  Rows without a neighbour must be exactly zero.
"""
import numpy as np
import pytest
import torch

from gsc_tpu.ops.gat import attention_dense as j_attention_dense
from gsc_tpu.ops.gat import dense_adj as j_dense_adj
from gsc_tpu.ops.pallas_gat import gatv2_pallas

from gsc_tpu_torch.ops.gat import dense_adj
from gsc_tpu_torch.ops.gat_attention import attention_plain
from test_torch_kernels import make_inputs
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _port(xl, xr, att, bias, adj, mean):
    t = torch.from_numpy
    return attention_plain(t(xl), t(xr), t(att), t(bias), t(adj),
                           mean).numpy()


CASES = [
    ((), 8, 5),             # single graph
    ((2, 3), 8, 5),         # batched [2, 3, N, F]
    ((4,), 24, 22),         # flagship shape
    ((1,), 24, 22),         # flagship, one request
    ((3,), 40, 7),          # N beyond one warp of lanes
]


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("lead,n,f", CASES)
def test_plain_matches_pallas_interpret_and_dense(lead, n, f, mean):
    xl, xr, att, bias, adj = make_inputs(lead, n, f, seed=n * 31 + f)
    pal = np.asarray(gatv2_pallas(xl, xr, att, bias, adj, mean_aggr=mean,
                                  interpret=True))
    den = np.asarray(j_attention_dense(xl, xr, att, bias, adj, mean))
    out = _port(xl, xr, att, bias, adj, mean)
    assert out.shape == pal.shape
    np.testing.assert_allclose(out, pal, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, den, rtol=RTOL, atol=ATOL)
    empty = ~adj.any(axis=-1)
    assert empty.any()
    assert np.all(out[empty] == 0.0)


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_dense_adj_matches_jax(lead):
    rng = np.random.default_rng(len(lead))
    n, e = 9, 12
    ei = rng.integers(0, n - 2, size=lead + (2, 2 * e)).astype(np.int32)
    em = rng.uniform(size=lead + (2 * e,)) < 0.7
    nm = np.zeros(lead + (n,), bool)
    nm[..., :n - 2] = True
    want = np.asarray(j_dense_adj(ei, em, nm))
    got = dense_adj(torch.from_numpy(ei), torch.from_numpy(em),
                    torch.from_numpy(nm)).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)

