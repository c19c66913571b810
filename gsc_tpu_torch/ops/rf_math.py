"""The plain version of ``csrc/rf_math.cuh``: kernel #2's elementwise
functions of resource-function plugins, as the same sequence of IEEE
double operations in float64 numpy, rounded once to f32.

Every step is one basic operation (add, subtract, multiply, divide,
``rint``, ``floor``, a comparison, a bit move) on float64 values, which
numpy rounds as the card's ``__dadd_rn`` and kin do, so each function
gives the kernel's bits for every f32 input.  The header explains the
formulas; the constants below are the header's (the tests hold the two
lists equal).  ``UNARY`` maps a program op to its function, ``pow_`` is
the two-argument one.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

LN2 = float.fromhex("0x1.62e42fefa39efp-1")
LN2_HI = float.fromhex("0x1.62e42fee00000p-1")
LN2_LO = float.fromhex("0x1.a39ef35793c76p-33")
INV_LN2 = float.fromhex("0x1.71547652b82fep+0")
INV_LN10 = float.fromhex("0x1.bcb7b1526e50ep-2")
LOG10_2 = float.fromhex("0x1.34413509f79ffp-2")
SQRT2 = float.fromhex("0x1.6a09e667f3bcdp+0")
EXP_LIMIT = 200.0
EXP2_LIMIT = 300.0
TANH_ONE = 20.0
LOG1P_LO = -0.25
LOG1P_HI = 0.375
# e^r - 1 = r * sum EM1[k] r^k, EM1[k] = 1/(k+1)! (Horner from the last)
EM1 = tuple(float.fromhex(h) for h in (
    "0x1.0000000000000p+0", "0x1.0000000000000p-1", "0x1.5555555555555p-3",
    "0x1.5555555555555p-5", "0x1.1111111111111p-7", "0x1.6c16c16c16c17p-10",
    "0x1.a01a01a01a01ap-13", "0x1.a01a01a01a01ap-16", "0x1.71de3a556c734p-19",
    "0x1.27e4fb7789f5cp-22", "0x1.ae64567f544e4p-26", "0x1.1eed8eff8d898p-29",
    "0x1.6124613a86d09p-33"))
# log1p(f) = s * sum ATANH[k] z^k, s = f/(2+f), z = s^2, ATANH[k] = 2/(2k+1)
ATANH = tuple(float.fromhex(h) for h in (
    "0x1.0000000000000p+1", "0x1.5555555555555p-1", "0x1.999999999999ap-2",
    "0x1.2492492492492p-2", "0x1.c71c71c71c71cp-3", "0x1.745d1745d1746p-3",
    "0x1.3b13b13b13b14p-3", "0x1.1111111111111p-3", "0x1.e1e1e1e1e1e1ep-4",
    "0x1.af286bca1af28p-4", "0x1.8618618618618p-4"))
_MANT = np.int64(0x000FFFFFFFFFFFFF)
_ONE = np.int64(0x3FF0000000000000)


def _pow2(n: np.ndarray) -> np.ndarray:
    return ((n.astype(np.int64) + 1023) << 52).view(np.float64)


def _horner(c, v: np.ndarray) -> np.ndarray:
    p = np.full_like(v, c[-1])
    for k in c[-2::-1]:
        p = p * v + k
    return p


def _em1_poly(r: np.ndarray) -> np.ndarray:
    return r * _horner(EM1, r)


def _log1p_core(f: np.ndarray) -> np.ndarray:
    s = f / (2.0 + f)
    return s * _horner(ATANH, s * s)


def _log_parts(x: np.ndarray):
    """(e, L(m - 1)) of positive finite doubles x = m 2^e."""
    b = x.view(np.int64)
    e = ((b >> 52) - 1023).astype(np.float64)
    m = ((b & _MANT) | _ONE).view(np.float64)
    big = m > SQRT2
    m = np.where(big, m * 0.5, m)
    e = np.where(big, e + 1.0, e)
    return e, _log1p_core(m - 1.0)


def _log_d(x: np.ndarray) -> np.ndarray:
    e, L = _log_parts(x)
    return e * LN2 + L


def _reduce(x: np.ndarray):
    x = np.clip(x, -EXP_LIMIT, EXP_LIMIT)
    n = np.rint(x * INV_LN2)
    return (x - n * LN2_HI) - n * LN2_LO, n


def _exp_d(x: np.ndarray) -> np.ndarray:
    r, n = _reduce(x)
    return (1.0 + _em1_poly(r)) * _pow2(n)


def _expm1_d(x: np.ndarray) -> np.ndarray:
    r, n = _reduce(x)
    p = _em1_poly(r)
    t = _pow2(n)
    return np.where(n == 0.0, p, (t - 1.0) + t * p)


def _wide(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).astype(np.float64)


def _f32(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32)


def _unary(fn: Callable[[np.ndarray], np.ndarray]):
    def run(x) -> np.ndarray:
        with np.errstate(all="ignore"):
            return _f32(fn(_wide(x)))
    run.__name__ = fn.__name__.lstrip("_")
    return run


def _safe(x: np.ndarray, bad: np.ndarray, fill: float = 1.0) -> np.ndarray:
    return np.where(bad, fill, x)


@_unary
def exp(x):
    nan = np.isnan(x)
    return np.where(nan, np.nan, _exp_d(_safe(x, nan)))


@_unary
def expm1(x):
    nan = np.isnan(x)
    out = _expm1_d(_safe(x, nan))
    return np.where(nan, np.nan, np.where(x == 0.0, x, out))


@_unary
def exp2(x):
    nan = np.isnan(x)
    c = np.clip(_safe(x, nan), -EXP2_LIMIT, EXP2_LIMIT)
    n = np.rint(c)
    t = (c - n) * LN2
    return np.where(nan, np.nan, (1.0 + _em1_poly(t)) * _pow2(n))


def _log_family(x, body):
    special = ~(x > 0.0) | np.isinf(x)
    out = body(_safe(x, special))
    return np.where(~(x >= 0.0), np.nan,
                    np.where(x == 0.0, -np.inf,
                             np.where(np.isinf(x), np.inf, out)))


@_unary
def log(x):
    return _log_family(x, _log_d)


@_unary
def log2(x):
    def body(v):
        e, L = _log_parts(v)
        return e + L * INV_LN2
    return _log_family(x, body)


@_unary
def log10(x):
    def body(v):
        e, L = _log_parts(v)
        return e * LOG10_2 + L * INV_LN10
    return _log_family(x, body)


@_unary
def log1p(x):
    special = ~(x > -1.0) | np.isinf(x) | (x == 0.0)
    v = _safe(x, special)
    direct = (v >= LOG1P_LO) & (v <= LOG1P_HI)
    out = np.where(direct, _log1p_core(v), _log_d(_safe(1.0 + v, direct)))
    return np.where(np.isnan(x) | (x < -1.0), np.nan,
                    np.where(x == -1.0, -np.inf,
                             np.where(np.isinf(x), np.inf,
                                      np.where(x == 0.0, x, out))))


@_unary
def tanh(x):
    nan = np.isnan(x)
    a = np.abs(_safe(x, nan))
    e = _expm1_d(np.minimum(a, TANH_ONE) + np.minimum(a, TANH_ONE))
    t = np.where(a <= TANH_ONE, e / (e + 2.0), 1.0)
    out = np.where(x < 0.0, -t, t)
    return np.where(nan, np.nan, np.where(x == 0.0, x, out))


@_unary
def sigmoid(x):
    nan = np.isnan(x)
    v = _safe(x, nan)
    t = _exp_d(-np.abs(v))
    d = 1.0 + t
    return np.where(nan, np.nan, np.where(v >= 0.0, 1.0 / d, t / d))


def pow_(x, y) -> np.ndarray:
    """C99 ``pow`` of f32 arrays (broadcast), as ``rf_pow``."""
    x, y = np.broadcast_arrays(_wide(x), _wide(y))
    with np.errstate(all="ignore"):
        ax = np.abs(x)
        finite_y = np.isfinite(y)
        ys = np.where(finite_y, y, 0.0)
        yint = np.floor(ys) == ys
        half = ys * 0.5
        yodd = yint & (np.floor(half) != half)
        neg = np.signbit(x)
        edge = (x == 0.0) | np.isinf(x)
        mag = np.where((x == 0.0) == (y < 0.0), np.inf, 0.0)
        edge_val = np.where(neg & yodd, -mag, mag)
        inf_y = np.where(ax == 1.0, 1.0,
                         np.where((ax > 1.0) == (y > 0.0), np.inf, 0.0))
        body_x = np.where(edge | np.isnan(x) | (ax == 0.0), 1.0, ax)
        r = _exp_d(ys * _log_d(body_x))
        body = np.where(neg & ~yint, np.nan, np.where(neg & yodd, -r, r))
        out = np.where(edge, edge_val, body)
        out = np.where(np.isinf(y), inf_y, out)
        out = np.where(np.isnan(x) | np.isnan(y), np.nan, out)
        out = np.where((y == 0.0) | (x == 1.0), 1.0, out)
        return _f32(out)


UNARY: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "exp": exp, "expm1": expm1, "exp2": exp2, "log": log, "log1p": log1p,
    "log2": log2, "log10": log10, "tanh": tanh, "sigmoid": sigmoid}

# the probe's outputs per element (csrc/rf_math_probe.cu), in order
PROBE_ORDER = tuple(UNARY) + ("pow",)


def plain_values(x, y) -> np.ndarray:
    """[n, len(PROBE_ORDER)] f32: every function on f32 ``x`` (and
    ``pow_(x, y)``), the plain version of
    ``rf_math_probe.card_values``."""
    return np.stack([UNARY[k](x) for k in UNARY] + [pow_(x, y)], axis=1)

