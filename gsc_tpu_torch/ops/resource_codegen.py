"""Resource-function plugins compiled into substep kernel #2.

A plugin (``config.registry``) maps an SF instance's load to the node
capacity it demands.  The TPU kernel calls whatever callable the service
tables hold, inside its admission loop; here kernel #2 runs a CUDA
device function generated from the plugin, ``float rf_plugin_<id>(float
load)``, compiled into its library (``ops.substep``; ids from 2 up, the
built-ins taking 0 and 1).

``trace(fn)`` traces the plugin with ``torch.fx.symbolic_trace`` into a
``ResourceProgram``: a list of elementwise operations on f32 and bool
values.  Each operation is emitted in the form that gives, for every f32
input (zeros, negatives, subnormals, infinities, NaN), the bits that
torch's CPU operation gives, since admission compares the demand with a
capacity (``dem <= cap + EPS``) and one ulp flips an admission:

- ``+ - * /`` as ``__fadd_rn`` / ``__fsub_rn`` / ``__fmul_rn`` /
  ``__fdiv_rn`` (the kernel builds with ``-fmad=false``); a Python
  number divided by a tensor (``c / load``) is torch's
  ``reciprocal(load) * c``, two roundings, and is emitted so;
- negation, ``abs``, comparisons, ``torch.where``, logical and/or/not
  on comparisons, bool to float;
- ``torch.maximum`` / ``minimum`` with NaN propagation (not ``fminf``),
  ``clamp`` / ``clip`` / ``clamp_min`` / ``clamp_max`` / ``relu`` with
  Python-number bounds as ``std::min(std::max(x, lo), hi)``;
- ``pow`` with the exponents torch's CPU kernel special-cases: 0 (ones),
  1, 2 (``x*x``), 3 (``x*x*x``), -1 (``1/x``), -2 (``1/(x*x)``), and
  ``square``, ``reciprocal``;
- Python-number constants rounded to f32 (round to nearest even, as
  torch rounds a wrapped scalar), ``zeros_like`` / ``ones_like`` /
  ``full_like`` and 0-dim f32 tensor constants.

``sqrt``, ``rsqrt`` and ``pow`` with exponent 0.5 or -0.5 are emitted as
IEEE square roots (``__fsqrt_rn``; ``rsqrt`` as ``1 / sqrt``).  torch's
CPU ``sqrt`` is not correctly rounded on f32 (one load in ~150 lies an
ulp off, tests/test_torch_resource_plugins.py), so a plugin with one of
these runs, in the plain engine too, through its traced graph
(``ResourceProgram.__call__``), whose square root is numpy's IEEE one
(``ResourceProgram.uses_graph``; ``plain_form``).

``exp``, ``expm1``, ``exp2``, ``log``, ``log1p``, ``log2``, ``log10``,
``tanh``, ``sigmoid`` and ``pow`` with any other exponent (a constant, or
a tensor: ``2 ** load``, ``load ** load``) are the hand-written device
functions of ``csrc/rf_math.cuh``: the same IEEE double operations as
their plain version ``ops.rf_math`` (float64 numpy), rounded once to f32,
so kernel and plain engine agree bit for bit; they are graph ops too
(``GRAPH_OPS``).  ``floor``, ``ceil``, ``trunc`` and ``round`` (half to
even) are exact in f32 on both sides.  A plugin without graph ops is
called as it is, and its traced graph equals it bit for bit.

What is refused, with its name (``UnsupportedResourceFunction``), is
what the JAX package's jitted engine refuses too: code that does not
trace (Python control flow on a tensor's value, ``math`` functions on
it), a second argument, a result that is not a float tensor.  The
refusal comes when kernel #2 is asked to run the plugin on the card; on
the CPU the plain engine still calls it.  There is no fallback from the
kernel to the plain engine.
"""
from __future__ import annotations

import hashlib
import operator
import struct
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import rf_math
from .build import notify_build

# the kernel's first plugin id (RF_PLUGIN_BASE in the CUDA source)
PLUGIN_BASE = 2
HEADER_NAME = "resource_plugins.cuh"

_BINARY = {"add": "__fadd_rn", "sub": "__fsub_rn", "mul": "__fmul_rn",
           "div": "__fdiv_rn"}
_COMPARE = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==",
            "ne": "!="}
_LOGIC = {"and": "&&", "or": "||"}
# pow exponents in torch's CPU special cases (Pow.cpp, PowKernel.cpp)
_POW_EXACT = (0.0, 1.0, 2.0, 3.0, -1.0, -2.0)
_POW_SQRT = {0.5: "sqrt", -0.5: "rsqrt"}
# exact f32 rounding functions, the same bits in torch and CUDA
_ROUNDING = {"floor": "floorf", "ceil": "ceilf", "trunc": "truncf",
             "round": "rintf"}
# ops whose emitted form is the IEEE (or rf_math) result, not torch's CPU
# result: a plugin with one runs its traced graph in the plain engine;
# "powg" is pow with an exponent outside the exact forms
GRAPH_OPS = ("sqrt", "rsqrt", "powg") + tuple(rf_math.UNARY)


class UnsupportedResourceFunction(ValueError):
    """A plugin that kernel #2 cannot run: an operation outside the set
    above (named in the message), or a function that does not trace."""


def _f32(value) -> float:
    """A Python number rounded to f32 (to nearest, ties to even)."""
    return float(np.float32(value))


def _tensor(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A numpy result as a tensor on ``like``'s device."""
    return torch.from_numpy(np.ascontiguousarray(values)).to(like.device)


def _f32_literal(value: float) -> str:
    bits = struct.unpack("<I", struct.pack("<f", value))[0]
    return f"__int_as_float(0x{bits:08x})"


# an operand: ("n", node index) or ("c", f32 value) or ("k", bool)
Operand = Tuple[str, Union[int, float, bool]]


@dataclass(frozen=True)
class Node:
    op: str
    args: Tuple[Operand, ...]
    dtype: str          # "f" (f32) or "b" (bool)


@dataclass
class ResourceProgram:
    """A plugin traced to elementwise operations.  ``out`` is the operand
    the function returns; ``uses_graph`` says whether an op is in
    ``GRAPH_OPS``, so that the plain engine evaluates this graph instead
    of calling the plugin."""

    name: str
    fn: Callable
    nodes: List[Node]
    out: Operand

    @property
    def uses_graph(self) -> bool:
        return any(n.op in GRAPH_OPS for n in self.nodes)

    # ------------------------------------------------------------ the CPU
    def __call__(self, load: torch.Tensor) -> torch.Tensor:
        return self.evaluate(load)

    def evaluate(self, load: torch.Tensor) -> torch.Tensor:
        """The emitted formulas on f32 tensors: what kernel #2 computes
        for each element of ``load``."""
        load = load.to(torch.float32)
        vals: List[torch.Tensor] = []

        def get(a: Operand, dtype: str = "f") -> torch.Tensor:
            kind, v = a
            if kind == "n":
                t = vals[v]
                return t.to(torch.float32) if dtype == "f" and \
                    t.dtype == torch.bool else t
            if kind == "k":
                return torch.full_like(load, bool(v), dtype=torch.bool)
            return torch.full_like(load, v)

        nan = torch.full_like(load, float("nan"))
        for node in self.nodes:
            op, args = node.op, node.args
            if op == "load":
                r = load
            elif op in _BINARY:
                a, b = get(args[0]), get(args[1])
                r = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
                     "div": torch.div}[op](a, b)
            elif op == "rdiv":          # c / x == reciprocal(x) * c
                r = (torch.ones_like(load) / get(args[1])) * get(args[0])
            elif op == "neg":
                r = -get(args[0])
            elif op == "abs":
                r = get(args[0]).abs()
            elif op == "tofloat":
                r = get(args[0], "b").to(torch.float32)
            elif op in _COMPARE:
                a, b = get(args[0]), get(args[1])
                r = {"gt": torch.gt, "ge": torch.ge, "lt": torch.lt,
                     "le": torch.le, "eq": torch.eq, "ne": torch.ne}[op](a, b)
            elif op in _LOGIC:
                a, b = get(args[0], "b"), get(args[1], "b")
                r = a & b if op == "and" else a | b
            elif op == "not":
                r = ~get(args[0], "b")
            elif op == "where":
                r = torch.where(get(args[0], "b"), get(args[1]),
                                get(args[2]))
            elif op in ("maximum", "minimum"):
                a, b = get(args[0]), get(args[1])
                pick = torch.where(a < b, b, a) if op == "maximum" \
                    else torch.where(b < a, b, a)
                r = torch.where(a.isnan() | b.isnan(), nan, pick)
            elif op == "clamp_min":     # std::max(x, lo)
                a, lo = get(args[0]), get(args[1])
                r = torch.where(a < lo, lo, a)
            elif op == "clamp_max":     # std::min(x, hi)
                a, hi = get(args[0]), get(args[1])
                r = torch.where(hi < a, hi, a)
            elif op in ("sqrt", "rsqrt"):
                x = get(args[0])
                s = np.sqrt(x.detach().cpu().numpy())
                if op == "rsqrt":
                    s = np.float32(1.0) / s
                r = torch.from_numpy(np.ascontiguousarray(s)).to(x.device)
            elif op in rf_math.UNARY:
                x = get(args[0])
                r = _tensor(rf_math.UNARY[op](x.detach().cpu().numpy()), x)
            elif op == "powg":
                x, y = get(args[0]), get(args[1])
                r = _tensor(rf_math.pow_(x.detach().cpu().numpy(),
                                         y.detach().cpu().numpy()), x)
            elif op in _ROUNDING:
                r = getattr(torch, op)(get(args[0]))
            else:   # trace() emits no other op
                raise AssertionError(op)
            vals.append(r)
        return get(self.out)

    # ------------------------------------------------------------- the card
    def cuda_function(self, fname: str) -> str:
        """``__device__ float fname(float load)``: the same formulas."""
        def ref(a: Operand, dtype: str = "f") -> str:
            kind, v = a
            if kind == "n":
                if dtype == "f" and self.nodes[v].dtype == "b":
                    return f"(v{v} ? 1.0f : 0.0f)"
                return f"v{v}"
            if kind == "k":
                return "true" if v else "false"
            return _f32_literal(v)

        qnan = "__int_as_float(0x7fc00000)"
        lines = [f"__device__ __forceinline__ float {fname}(float load) {{"]
        for i, node in enumerate(self.nodes):
            op, args = node.op, node.args
            r = [ref(a) for a in args]
            if op == "load":
                e = "load"
            elif op in _BINARY:
                e = f"{_BINARY[op]}({r[0]}, {r[1]})"
            elif op == "rdiv":
                e = f"__fmul_rn(__fdiv_rn(1.0f, {r[1]}), {r[0]})"
            elif op == "neg":
                e = f"-{r[0]}"
            elif op == "abs":
                e = f"fabsf({r[0]})"
            elif op == "tofloat":
                e = f"({ref(args[0], 'b')} ? 1.0f : 0.0f)"
            elif op in _COMPARE:
                e = f"({r[0]} {_COMPARE[op]} {r[1]})"
            elif op in _LOGIC:
                a, b = ref(args[0], "b"), ref(args[1], "b")
                e = f"({a} {_LOGIC[op]} {b})"
            elif op == "not":
                e = f"(!{ref(args[0], 'b')})"
            elif op == "where":
                e = f"({ref(args[0], 'b')} ? {r[1]} : {r[2]})"
            elif op == "maximum":
                e = (f"(({r[0]} != {r[0]} || {r[1]} != {r[1]}) ? {qnan} : "
                     f"({r[0]} < {r[1]} ? {r[1]} : {r[0]}))")
            elif op == "minimum":
                e = (f"(({r[0]} != {r[0]} || {r[1]} != {r[1]}) ? {qnan} : "
                     f"({r[1]} < {r[0]} ? {r[1]} : {r[0]}))")
            elif op == "clamp_min":
                e = f"({r[0]} < {r[1]} ? {r[1]} : {r[0]})"
            elif op == "clamp_max":
                e = f"({r[1]} < {r[0]} ? {r[1]} : {r[0]})"
            elif op == "sqrt":
                e = f"__fsqrt_rn({r[0]})"
            elif op == "rsqrt":
                e = f"__fdiv_rn(1.0f, __fsqrt_rn({r[0]}))"
            elif op in rf_math.UNARY:
                e = f"rf_{op}({r[0]})"
            elif op == "powg":
                e = f"rf_pow({r[0]}, {r[1]})"
            elif op in _ROUNDING:
                e = f"{_ROUNDING[op]}({r[0]})"
            else:
                raise AssertionError(op)
            ctype = "bool" if node.dtype == "b" else "float"
            lines.append(f"    const {ctype} v{i} = {e};")
        lines.append(f"    return {ref(self.out)};")
        lines.append("}")
        return "\n".join(lines)


# ------------------------------------------------------------------ tracing
def _target_name(node) -> str:
    t = node.target
    if node.op == "call_method":
        return str(t)
    return getattr(t, "__name__", str(t)).strip("_")


_FUNCTIONS = {
    operator.add: "add", torch.add: "add",
    operator.sub: "sub", torch.sub: "sub", torch.subtract: "sub",
    operator.mul: "mul", torch.mul: "mul", torch.multiply: "mul",
    operator.truediv: "truediv", torch.div: "div", torch.divide: "div",
    torch.true_divide: "div",
    operator.neg: "neg", torch.neg: "neg", torch.negative: "neg",
    operator.abs: "abs", abs: "abs", torch.abs: "abs",
    operator.gt: "gt", torch.gt: "gt", torch.greater: "gt",
    operator.ge: "ge", torch.ge: "ge", torch.greater_equal: "ge",
    operator.lt: "lt", torch.lt: "lt", torch.less: "lt",
    operator.le: "le", torch.le: "le", torch.less_equal: "le",
    operator.eq: "eq", torch.eq: "eq", operator.ne: "ne", torch.ne: "ne",
    operator.and_: "and", torch.logical_and: "and",
    operator.or_: "or", torch.logical_or: "or",
    operator.invert: "not", torch.logical_not: "not",
    torch.where: "where", torch.maximum: "maximum",
    torch.minimum: "minimum", torch.clamp: "clamp", torch.clip: "clamp",
    torch.clamp_min: "clamp_min", torch.clamp_max: "clamp_max",
    torch.relu: "relu", torch.nn.functional.relu: "relu",
    operator.pow: "pow", torch.pow: "pow", torch.square: "square",
    torch.reciprocal: "reciprocal", torch.sqrt: "sqrt", torch.rsqrt: "rsqrt",
    torch.zeros_like: "zeros_like", torch.ones_like: "ones_like",
    torch.full_like: "full_like",
    torch.exp: "exp", torch.expm1: "expm1", torch.special.expm1: "expm1",
    torch.exp2: "exp2", torch.special.exp2: "exp2", torch.log: "log",
    torch.log1p: "log1p", torch.special.log1p: "log1p", torch.log2: "log2",
    torch.log10: "log10", torch.tanh: "tanh",
    torch.nn.functional.tanh: "tanh", torch.sigmoid: "sigmoid",
    torch.special.expit: "sigmoid", torch.nn.functional.sigmoid: "sigmoid",
    torch.floor: "floor", torch.ceil: "ceil", torch.trunc: "trunc",
    torch.fix: "trunc", torch.round: "round", torch.special.round: "round",
}
_METHODS = {"add": "add", "sub": "sub", "subtract": "sub", "mul": "mul",
            "multiply": "mul", "div": "div", "divide": "div",
            "true_divide": "div", "neg": "neg", "negative": "neg",
            "abs": "abs", "gt": "gt", "ge": "ge", "lt": "lt", "le": "le",
            "eq": "eq", "ne": "ne", "logical_and": "and",
            "logical_or": "or", "logical_not": "not",
            "maximum": "maximum", "minimum": "minimum", "clamp": "clamp",
            "clip": "clamp", "clamp_min": "clamp_min",
            "clamp_max": "clamp_max", "relu": "relu", "pow": "pow",
            "square": "square", "reciprocal": "reciprocal", "sqrt": "sqrt",
            "rsqrt": "rsqrt", "float": "float",
            **{op: op for op in ("exp", "expm1", "exp2", "log", "log1p",
                                 "log2", "log10", "tanh", "sigmoid",
                                 "floor", "ceil", "trunc", "round")},
            "fix": "trunc"}


# keyword arguments that carry values (the others are options)
_NUMERIC_KWARGS = ("min", "max", "fill_value", "exponent")


class _Builder:
    def __init__(self, name: str):
        self.name = name
        self.nodes: List[Node] = []

    def refuse(self, what: str):
        raise UnsupportedResourceFunction(
            f"resource function {self.name!r}: {what} is not in the "
            "operation set kernel #2 compiles (ops/resource_codegen.py)")

    def add(self, op: str, args: Sequence[Operand], dtype: str) -> Operand:
        self.nodes.append(Node(op, tuple(args), dtype))
        return ("n", len(self.nodes) - 1)

    def dtype(self, a: Operand) -> str:
        if a[0] == "n":
            return self.nodes[a[1]].dtype
        return "b" if a[0] == "k" else "f"

    def number(self, a: Operand) -> Operand:
        """``a`` as an f32 operand (a bool value becomes 0 or 1)."""
        if self.dtype(a) == "f":
            return a
        if a[0] == "k":
            return ("c", 1.0 if a[1] else 0.0)
        return self.add("tofloat", [a], "f")

    def boolean(self, a: Operand, op: str) -> Operand:
        if self.dtype(a) != "b":
            self.refuse(f"{op} on a float value")
        return a


def _operand(b: _Builder, env: Dict, value, op: str) -> Operand:
    import torch.fx as fx

    if value is None:
        return None
    if isinstance(value, fx.Node):
        if value not in env:
            b.refuse(f"the value of {value.name!r}")
        return env[value]
    if isinstance(value, bool):
        return ("k", value)
    if isinstance(value, (int, float)):
        return ("c", _f32(value))
    if isinstance(value, torch.Tensor) and value.dim() == 0 \
            and value.dtype in (torch.float32, torch.bool):
        if value.dtype == torch.bool:
            return ("k", bool(value))
        return ("c", float(value))
    b.refuse(f"an argument of {op} ({type(value).__name__})")


def _scalar(b: _Builder, a: Operand, op: str) -> float:
    if a[0] != "c":
        b.refuse(f"{op} with a tensor argument")
    if a[1] != a[1]:
        b.refuse(f"{op} with a NaN bound")
    return a[1]


def _lower(b: _Builder, op: str, args: List[Operand], kwargs: Dict,
           operator_form: bool) -> Operand:
    """One traced call as program nodes (``operator_form``: a Python
    operator, whose reflected forms torch evaluates differently)."""
    if op in ("add", "sub", "mul", "div", "truediv"):
        if kwargs.get("alpha", 1) != 1 or kwargs.get("rounding_mode"):
            b.refuse(f"{op} with {sorted(kwargs)}")
        x, y = b.number(args[0]), b.number(args[1])
        if x[0] != "n" and y[0] != "n":
            b.refuse(f"{op} of two constants")
        if op == "truediv":
            # float / tensor is Tensor.__rtruediv__: reciprocal(x) * c
            return b.add("rdiv" if x[0] != "n" else "div", [x, y], "f")
        return b.add(op, [x, y], "f")
    if op in ("neg", "abs"):
        return b.add(op, [b.number(args[0])], "f")
    if op in _COMPARE:
        x, y = args[0], args[1]
        if b.dtype(x) == "b" or b.dtype(y) == "b":
            b.refuse(f"{op} on boolean values")
        return b.add(op, [x, y], "b")
    if op in _LOGIC:
        return b.add(op, [b.boolean(args[0], op), b.boolean(args[1], op)],
                     "b")
    if op == "not":
        return b.add("not", [b.boolean(args[0], op)], "b")
    if op == "where":
        if len(args) != 3:
            b.refuse("where with one argument")
        cond = args[0]
        if cond[0] == "k":
            return b.number(args[1] if cond[1] else args[2])
        return b.add("where", [b.boolean(cond, op), b.number(args[1]),
                               b.number(args[2])], "f")
    if op in ("maximum", "minimum"):
        return b.add(op, [b.number(args[0]), b.number(args[1])], "f")
    if op in ("clamp", "clamp_min", "clamp_max", "relu"):
        x = b.number(args[0])
        rest = list(args[1:]) + [None, None]
        lo, hi = {"relu": (("c", 0.0), None),
                  "clamp_min": (rest[0] or kwargs.get("min"), None),
                  "clamp_max": (None, rest[0] or kwargs.get("max")),
                  "clamp": (rest[0] or kwargs.get("min"),
                            rest[1] or kwargs.get("max"))}[op]
        if lo is not None:
            x = b.add("clamp_min", [x, ("c", _scalar(b, lo, op))], "f")
        if hi is not None:
            x = b.add("clamp_max", [x, ("c", _scalar(b, hi, op))], "f")
        return x
    if op in ("pow", "square", "reciprocal"):
        x = b.number(args[0])
        if op == "square":
            y = ("c", 2.0)
        elif op == "reciprocal":
            y = ("c", -1.0)
        else:
            if len(args) < 2:
                args = [args[0], kwargs.get("exponent")]
            if args[1] is None:
                b.refuse("pow without an exponent")
            y = b.number(args[1])
        if x[0] != "n" or y[0] != "c":
            # a constant base or a tensor exponent (2 ** load, load ** load)
            return b.add("powg", [x, y], "f")
        e = float(y[1])
        if e in _POW_SQRT:
            return b.add(_POW_SQRT[e], [x], "f")
        if e not in _POW_EXACT:
            return b.add("powg", [x, y], "f")
        if e == 0.0:
            return ("c", 1.0)
        if e == 1.0:
            return x
        sq = b.add("mul", [x, x], "f") if abs(e) >= 2 else x
        if abs(e) == 3.0:
            sq = b.add("mul", [sq, x], "f")
        return b.add("div", [("c", 1.0), sq], "f") if e < 0 else sq
    if op in ("sqrt", "rsqrt") or op in rf_math.UNARY:
        return b.add(op, [b.number(args[0])], "f")
    if op in _ROUNDING:
        if op == "round" and kwargs.get("decimals", 0) != 0:
            b.refuse("round with decimals")
        return b.add(op, [b.number(args[0])], "f")
    if op in ("zeros_like", "ones_like", "full_like"):
        dtype = kwargs.get("dtype")
        if dtype not in (None, torch.float32):
            b.refuse(f"{op} with dtype {dtype}")
        if op == "full_like":
            fill = args[1] if len(args) > 1 else kwargs.get("fill_value")
            return ("c", _scalar(b, fill, op))
        return ("c", 0.0 if op == "zeros_like" else 1.0)
    if op == "float":
        return args[0]
    b.refuse(op)


def trace(fn: Callable, name: Optional[str] = None) -> ResourceProgram:
    """Trace ``fn`` into a ``ResourceProgram``; raises
    ``UnsupportedResourceFunction`` naming the first operation outside
    the set, or when ``fn`` does not trace."""
    import torch.fx as fx

    name = name or registered_name(fn)
    b = _Builder(name)
    try:
        gm = fx.symbolic_trace(fn)
    except Exception as e:   # noqa: BLE001 - any tracing failure refuses
        b.refuse(f"code that does not trace ({type(e).__name__}: {e})")
    env: Dict = {}
    out: Optional[Operand] = None
    n_inputs = 0
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            n_inputs += 1
            if n_inputs > 1:
                b.refuse("a second argument")
            env[node] = b.add("load", [], "f")
        elif node.op == "get_attr":
            env[node] = _operand(b, env, getattr(gm, node.target),
                                 node.target)
        elif node.op in ("call_function", "call_method"):
            table = _FUNCTIONS if node.op == "call_function" else _METHODS
            try:
                op = table.get(node.target)
            except TypeError:      # an unhashable target
                op = None
            if op is None and getattr(node.target, "__module__",
                                      None) == "math":
                b.refuse(f"math.{_target_name(node)} on a tensor (a Python "
                         "math function, refused by JAX's tracer too)")
            if op is None:
                b.refuse(_target_name(node))
            args = [_operand(b, env, a, op) for a in node.args]
            kwargs = {k: (_operand(b, env, v, op) if k in _NUMERIC_KWARGS
                          else v)
                      for k, v in node.kwargs.items() if v is not None
                      and not (k == "alpha" and v == 1)}
            env[node] = _lower(b, op, args, kwargs,
                               node.target in (operator.truediv,
                                               operator.pow))
        elif node.op == "output":
            out = _operand(b, env, node.args[0], "return")
        else:
            b.refuse(node.op)
    if out is None or b.dtype(out) != "f":
        b.refuse("a result that is not a float tensor")
    return ResourceProgram(name=name, fn=fn, nodes=b.nodes, out=out)


def registered_name(fn: Callable) -> str:
    """The name ``fn`` is registered under (else its ``__name__``)."""
    from ..config import registry

    for key, value in registry._RESOURCE_FUNCTIONS.items():
        if value is fn:
            return key
    return getattr(fn, "__name__", type(fn).__name__)


# the built-in functions compiled into the kernel, by id
BUILTIN_IDS = {"default": 0, "overhead": 1}


def builtin_id(fn: Callable) -> Optional[int]:
    """The kernel's id of ``fn`` when it is a built-in function, else
    None."""
    from ..config.registry import get_resource_function

    for name, i in BUILTIN_IDS.items():
        if get_resource_function(name) is fn:
            return i
    return None


def plain_form(fn: Callable) -> Callable:
    """What the plain engine calls for ``fn``: the function itself,
    unless it traces to a program with a square root (``GRAPH_OPS``),
    whose traced graph is then evaluated instead."""
    if builtin_id(fn) is not None or isinstance(fn, ResourceProgram):
        return fn
    try:
        prog = trace(fn)
    except UnsupportedResourceFunction:
        return fn
    return prog if prog.uses_graph else fn


def kernel_plan(fns: Sequence[Callable]
                ) -> Tuple[List[int], Optional[str]]:
    """(the kernel's resource-function id of every SF column, the
    generated header or None without plugins).  Plugins take ids from 2
    in the order the columns first name them; raises
    ``UnsupportedResourceFunction`` for one the kernel cannot run."""
    ids: List[int] = []
    programs: List[ResourceProgram] = []
    keys: List[Callable] = []
    for fn in fns:
        bid = builtin_id(fn)
        if bid is not None:
            ids.append(bid)
            continue
        key = fn.fn if isinstance(fn, ResourceProgram) else fn
        if key not in keys:
            keys.append(key)
            programs.append(fn if isinstance(fn, ResourceProgram)
                            else trace(fn))
        ids.append(PLUGIN_BASE + keys.index(key))
    if not programs:
        return ids, None
    t0 = time.perf_counter()
    header = plugin_header(programs)
    digest = hashlib.sha256(header.encode()).hexdigest()[:16]
    notify_build(f"resource_plugins_{digest}", "build",
                 time.perf_counter() - t0)
    return ids, header


def plugin_header(programs: Sequence[ResourceProgram]) -> str:
    """The generated header: one device function per program (ids from
    ``PLUGIN_BASE`` in order) and the ``rf_plugin`` dispatch.  It holds
    the code alone, not the plugins' names, so plugins that compute the
    same share one build."""
    parts = ["// Generated by gsc_tpu_torch/ops/resource_codegen.py: "
             "resource-function plugins of substep kernel #2.",
             "#pragma once", ""]
    cases = []
    for k, prog in enumerate(programs):
        pid = PLUGIN_BASE + k
        parts.append(prog.cuda_function(f"rf_plugin_{pid}"))
        parts.append("")
        cases.append(f"    case {pid}: return rf_plugin_{pid}(load);")
    parts += ["__device__ __forceinline__ float rf_plugin(int id, "
              "float load) {", "    switch (id) {", *cases, "    }",
              "    return load;", "}", ""]
    return "\n".join(parts)
