"""The exactness argument behind the substep megakernel's parallel
admission scans, checked on the CPU.

The kernel adds each admission round's sorted values in a tree (a
Hillis-Steele scan within each warp of 32 lanes, then the totals of the
lower warps added to it) where PyTorch's CPU cumsum, the plain version,
adds them one after another into a double.  ``scan_order_free`` is the
kernel's test, in Python: when it holds, every partial sum is exact in a
double, so both orders give the same prefixes, rounded to the same f32.
Here the kernel's association is mirrored in numpy float64 and compared
with ``torch.cumsum`` bit for bit at every position, on arrays from
hypothesis; one fixed array, where the test fails, shows that the two
orders then really differ.  Exact comparison: no tolerance.
"""
import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gsc_tpu_torch.ops.substep import scan_order_free
from torch_port_helpers import one_torch_thread  # noqa: F401

WARP = 32


def tree_prefix(values: np.ndarray) -> np.ndarray:
    """The kernel's association of the inclusive prefix sums, in float64:
    leaves start from +0.0, a warp scan by shuffles up (lane >= o adds
    lane - o), then each position adds the sum of the lower warps' totals,
    taken warp by warp; rounded to f32."""
    leaves = [0.0 if v == 0.0 else float(v) for v in values]
    n = len(leaves)
    warps = (n + WARP - 1) // WARP
    x = np.zeros(warps * WARP, np.float64)
    x[:n] = leaves
    x = x.reshape(warps, WARP)
    o = 1
    while o < WARP:
        up = np.zeros_like(x)
        up[:, o:] = x[:, :-o]
        lane = np.arange(WARP)
        x = np.where(lane >= o, x + up, x)
        o *= 2
    totals = x[:, -1]
    out = np.empty_like(x)
    for w in range(warps):
        pre = 0.0
        for q in range(w):
            pre += totals[q]
        out[w] = pre + x[w]
    return out.reshape(-1)[:n].astype(np.float32)


def sequential_prefix(values: np.ndarray) -> np.ndarray:
    """The plain version's cumsum (CPU: a double accumulator)."""
    return torch.cumsum(torch.from_numpy(values), dim=0).numpy()


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


# values the admission rounds see: integer multiples of one power of two
# (data rates of integer traffic), data rates ~N(1, 0.35) in f32, and wide
# mixtures; zeros are the positions a round does not admit
_zero = st.sampled_from([np.float32(0.0), np.float32(-0.0)])
_same_scale = st.integers(-60, 60).flatmap(lambda e: st.lists(
    st.one_of(_zero, st.integers(-2 ** 20, 2 ** 20).map(
        lambda k: np.float32(np.ldexp(float(k), e)))),
    min_size=1, max_size=300))
_rates = st.lists(st.one_of(_zero, st.floats(0.0, 3.0, width=32)),
                  min_size=1, max_size=300)
_any = st.lists(st.one_of(_zero, st.floats(width=32, allow_nan=False,
                                           allow_infinity=False)),
                max_size=40)


@settings(max_examples=300, deadline=None)
@given(st.one_of(_same_scale, _rates), _any)
def test_tree_scan_equals_sequential_when_order_free(base, mixed):
    for values in (base, base + mixed):
        v = np.asarray(values, np.float32)
        if not scan_order_free(v):
            continue
        np.testing.assert_array_equal(_bits(tree_prefix(v)),
                                      _bits(sequential_prefix(v)))


def test_rates_of_this_system_are_order_free():
    """1,024 positions of data rates ~N(1, 0.35) (the traffic's widest)
    stay inside a double: the kernel never takes its sequential scan on
    them, and the tree gives the sequential prefixes."""
    rng = np.random.default_rng(0)
    v = np.abs(rng.normal(1.0, 0.35, 1024)).astype(np.float32)
    v[rng.uniform(size=1024) < 0.5] = 0.0
    assert scan_order_free(v)
    np.testing.assert_array_equal(_bits(tree_prefix(v)),
                                  _bits(sequential_prefix(v)))


def test_orders_differ_where_the_test_fails():
    """A span no double holds: the test fails, and the tree's prefix
    really differs from the sequential one (the sequential scan keeps the
    last 1e-30, the tree cancels it), so the test above is not vacuous."""
    v = np.array([1e10, 1e-30, -1e10, 1e-30], np.float32)
    assert not scan_order_free(v)
    tree, seq = tree_prefix(v), sequential_prefix(v)
    assert tree[-1] == 0.0 and seq[-1] == np.float32(1e-30)


def test_order_free_edge_cases():
    assert scan_order_free([])
    assert scan_order_free([0.0, -0.0])
    assert not scan_order_free([1.0, np.inf])
    assert not scan_order_free([np.nan])
    # 1 and 2^-51 span exactly 53 bits; 1 and two 2^-52 span 55
    assert scan_order_free([1.0, 2.0 ** -51])
    assert not scan_order_free([1.0, 2.0 ** -52, 2.0 ** -52])
    # a negative zero enters as +0.0: the prefix of zeros is +0.0
    v = np.array([-0.0, -0.0], np.float32)
    np.testing.assert_array_equal(_bits(tree_prefix(v)),
                                  _bits(sequential_prefix(v)))
