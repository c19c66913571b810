"""The fused GATv2 attention kernel's wrapper, without JAX.

This file imports torch and the port only, so it also runs on the card,
where JAX is absent (``python -m pytest --noconftest
tests/test_torch_kernels.py -q``).  On the CPU the wrapper runs the plain
version and counts no launch, and ``launch`` refuses CPU tensors; on the
card (marker ``cuda``) the kernel is held against its plain version at the
serving shapes and one N > 32 case.

Tolerance: rtol 1e-5, atol 1e-5 — f32, summed in another order than
the plain einsums: with unit-normal inputs the logits sum 22 products, and
their ~1e-6 relative rounding differences pass through exp and the
weighted sum into up to ~1e-5 absolute on outputs of a few units (sum
aggregation reaches |out| ~5).  ``chip_smoke.py`` checks on the card that
the kernel's distance to a float64 evaluation stays of the plain
version's order.  Rows without a neighbour must be exactly zero.
"""
import numpy as np
import pytest
import torch

from gsc_tpu_torch.ops.gat_attention import (GatAttention, attention_plain,
                                             gat_attention)
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5


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
