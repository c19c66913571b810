"""The port's static analysis, rules R1-R4 (stdlib ``ast`` only).

The port of ``gsc_tpu.analysis.astlint``.  The JAX rules guard a
compiled program (jit reachability, buffer donation, weak-typed
retraces); the port runs eagerly, so each rule is read for PyTorch or
dropped:

- **R1 host sync in a step**: ``.item()``, ``.cpu()``, ``.numpy()``,
  ``.tolist()``, ``float()``/``int()``/``bool()`` of a tensor, ``if``,
  ``while``, ``assert`` or a conditional expression on a tensor, and
  ``torch.cuda.synchronize`` / ``Event.synchronize`` /
  ``Stream.synchronize``, in any function reachable from a step entry
  point (``STEP_ROOTS``: the entry points ``analysis.no_host_sync``
  guards at run time).  A host read inside a step stalls the host on the
  card's queue, and breaks the CUDA-graph capture of the step that the
  speed work plans.  It is the static twin of ``no_host_sync``: that
  sentinel sees the branches a test runs, this rule every branch.
- **R3 global RNG or a clock in a step**: ``torch.rand``/``randn``/
  ``randint``/``randperm``/``normal``/``bernoulli``/``multinomial``
  (and their ``_like`` forms) or the in-place ``normal_``/``uniform_``/
  ``exponential_``/... without ``generator=``, ``torch.manual_seed``,
  ``np.random.<fn>`` (other than a generator's constructor),
  ``random.<fn>``, and wall-clock reads (``time.time``,
  ``perf_counter``, ``datetime.now``, ...), reachable from a step entry
  point.  The port draws every random number from an explicit generator
  (``agents.ddpg.Draws``), which is what makes resumes exact and runs
  bit-equal across processes.
- **R4 accumulation dtype**: a product (``@``, ``torch.matmul``/``mm``/
  ``bmm``/``einsum``/``tensordot``, ``F.linear``, ``.matmul``/``.mm``/
  ``.bmm``) in a bf16-policy module (``ops/``, ``models/``) must make
  its accumulation explicit, as ``models/nets.py`` (``_dense``,
  ``_bilinear``) and ``ops/gat.py`` (``project``, ``attention_bf16``)
  do: every operand widened (``.float()``, ``.double()``, ``.to()`` of a
  float32/float64 dtype or of a parameter whose default is one), so the
  products accumulate in f32 whatever the policy; or the product sits in
  an f32-gated branch (``if <dtype-ish> is None:``, ``if <x>.dtype ==
  torch.float32:``, the ``else`` of a low-precision gate, or the code
  after a low-precision gate whose body returns).  A bare product on
  bf16 operands rounds where the JAX package's
  ``preferred_element_type=float32`` contractions do not.
- **R2 (use after donation) and R5 (weak-typed scalar retrace) are
  dropped** (``findings.DROPPED_RULES``): eager PyTorch never consumes
  an argument's storage, and nothing is traced, so a Python scalar
  retraces nothing.  The hazards nearest to them (writes through an
  alias of a replay ring; Python scalars frozen into a captured CUDA
  graph) are not visible by name; the runtime tests hold the first
  (exact resumes, bit-equal rings), and the second has no graph to
  freeze into yet.

Reachability resolves calls by name and type, never by running code:
``self.m()`` to the class's method (bases included), ``x.m()`` by the
type of ``x`` (a parameter's annotation, a constructor assigned to it,
a dataclass field's annotation, a function's return annotation), a
called instance to its class's ``forward`` or ``__call__``,
``Fn.apply`` of an autograd function to its ``forward`` and
``backward``, bare names through the module's own functions and its
imports.  A method called on a receiver of unknown type resolves when
exactly one class of the project defines that name (and the name is not
also a common tensor or container method).  Nested functions and lambdas
of a reached function are reached.  False positives go to the baseline
with a written reason (``baseline.py``); false negatives are bounded by
the runtime sentinels (``sentinels.py``).
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .baseline import build_result, load_baseline
from .findings import RULE_IDS, Finding, LintResult

# ----------------------------------------------------------- configuration

# the step entry points (class.method qualnames): what
# ``analysis.no_host_sync`` guards at run time (tests/
# test_torch_no_host_sync.py, chip_smoke.py's sync regions): the env's
# reset and step, the single-env episode, the replica trainer's chunk and
# learn burst, and the serving policy's batched forward
STEP_ROOTS = (
    "ServiceCoordEnv.reset",
    "ServiceCoordEnv.step",
    "DDPG.episode_step",
    "ParallelDDPG.chunk_step",
    "ParallelDDPG.learn_burst",
    "GreedyServePolicy.run_batch",
)

_SYNC_METHODS = {"item", "cpu", "numpy", "tolist"}   # zero-argument reads
_CAST_BUILTINS = {"float", "int", "bool"}
# a method call with one of these names yields a tensor when its receiver
# is one (reductions and predicates whose truth value is a host read)
_TENSOR_METHODS = {
    "any", "all", "sum", "max", "min", "amax", "amin", "mean", "prod",
    "norm", "count_nonzero", "argmax", "argmin", "isnan", "isinf",
    "isfinite", "eq", "ne", "gt", "lt", "ge", "le", "logical_and",
    "logical_or", "logical_not", "abs", "clamp", "nonzero", "equal",
    "allclose"}
# ``torch.<x>`` attributes that are not tensor-valued functions
_TORCH_NON_TENSOR = {
    "cuda", "backends", "distributed", "jit", "utils", "autograd", "nn",
    "is_tensor", "is_grad_enabled", "is_floating_point", "is_complex",
    "get_num_threads", "get_default_dtype", "device", "dtype", "Size",
    "finfo", "iinfo", "no_grad", "inference_mode", "Generator",
    "set_num_threads", "from_numpy", "profiler", "library", "ops", "_C"}

_RAND_FUNCS = {"rand", "randn", "randint", "randperm", "rand_like",
               "randn_like", "randint_like", "normal", "bernoulli",
               "multinomial", "poisson"}
_RAND_METHODS = {"normal_", "uniform_", "exponential_", "random_",
                 "bernoulli_", "geometric_", "cauchy_", "log_normal_",
                 "multinomial", "bernoulli"}
_SEED_FUNCS = {"manual_seed", "seed", "manual_seed_all", "set_rng_state"}
_NP_GENERATORS = {"default_rng", "Generator", "RandomState", "SeedSequence",
                  "PCG64", "PCG64DXSM", "MT19937", "Philox", "SFC64",
                  "BitGenerator"}
_TIME_ATTRS = {"time", "perf_counter", "monotonic", "process_time",
               "perf_counter_ns", "time_ns", "monotonic_ns"}
_DATETIME_ATTRS = {"now", "utcnow", "today"}

_DOT_FUNCS = {"matmul", "mm", "bmm", "einsum", "tensordot", "dot", "mv",
              "inner", "outer", "addmm", "baddbmm", "chain_matmul"}
_DOT_METHODS = {"matmul", "mm", "bmm"}
_WIDE_DTYPES = {"float32", "float64", "double", "float"}
_LOW_DTYPES = {"bfloat16", "float16", "half"}

# method names shared with torch tensors, numpy arrays and Python
# containers: a receiver of unknown type calling one is more likely one
# of those than a project object, so they never resolve by name alone
_GENERIC_METHODS = {
    "to", "map", "item", "sum", "append", "get", "update", "copy", "clone",
    "expand", "view", "reshape", "index", "add", "pop", "keys", "values",
    "items", "format", "join", "split", "replace", "strip", "read",
    "write", "close", "run", "start", "stop", "put", "set", "clear",
    "extend", "insert", "remove", "sort", "float", "int", "cpu", "cuda",
    "numpy", "tolist", "apply", "step", "forward", "backward", "reset",
    "init", "load", "save", "sample", "mean", "max", "min", "any", "all",
    "fill_", "zero_", "copy_", "record", "wait", "result", "state_dict",
    "load_state_dict", "parameters", "named_parameters", "train", "eval",
    "size", "numel", "squeeze", "unsqueeze", "flatten", "stack", "cat",
    "where", "gather", "scatter", "flip", "roll", "repeat",
    "permute", "transpose", "contiguous", "detach", "type", "long", "bool",
    "half", "double", "new_zeros", "new_ones", "new_full", "zeros",
    "ones", "full", "empty", "arange", "emit", "event", "gauge", "counter",
    "series", "__init__", "__call__", "__enter__", "__exit__"}


def _dotted(node: ast.AST) -> Optional[List[str]]:
    """['torch', 'cuda', 'synchronize'] for torch.cuda.synchronize; None
    for chains that do not start at a name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _walk_own(fn_node: ast.AST):
    """ast.walk over a function body EXCLUDING nested def/class subtrees
    (each nested def is indexed on its own).  Lambda bodies are included:
    a lambda has no entry of its own, so what it calls belongs to the
    function that wrote it."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _scopes(fn: "FunctionInfo"):
    """``fn`` and the functions it is nested in, innermost first."""
    while fn is not None:
        yield fn
        fn = fn.module.functions.get(fn.parent) if fn.parent else None


# ------------------------------------------------------------------ index

@dataclass
class FunctionInfo:
    module: "ModuleIndex"
    qualname: str
    name: str
    node: ast.AST                   # FunctionDef / AsyncFunctionDef
    parent: Optional[str]           # enclosing function qualname
    cls: Optional["ClassInfo"]      # owning class of a method
    # local name -> type expressions (annotations, constructors assigned)
    local_types: Dict[str, List[ast.AST]] = field(default_factory=dict)

    @property
    def path(self) -> str:
        return self.module.path


@dataclass
class ClassInfo:
    module: "ModuleIndex"
    qualname: str
    name: str
    node: ast.ClassDef
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)
    # attribute -> type expressions (class-body annotations, ``self.x =``)
    attr_types: Dict[str, List[Tuple[ast.AST, FunctionInfo]]] = field(
        default_factory=dict)


@dataclass
class ModuleIndex:
    path: str                       # repo-relative posix path
    tree: ast.Module
    lines: List[str]
    modname: str = ""               # dotted module name
    functions: Dict[str, FunctionInfo] = field(default_factory=dict)
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    # local name -> (absolute module, attribute or None for a module)
    imports: Dict[str, Tuple[str, Optional[str]]] = field(
        default_factory=dict)
    # module-level name -> value expressions assigned to it
    globals: Dict[str, List[ast.AST]] = field(default_factory=dict)


def _module_name(path: str) -> Tuple[str, bool]:
    """'gsc_tpu_torch/env/env.py' -> ('gsc_tpu_torch.env.env', False);
    a package's ``__init__.py`` -> (package, True)."""
    parts = path[:-3].split("/") if path.endswith(".py") else path.split("/")
    is_pkg = parts[-1] == "__init__"
    if is_pkg:
        parts = parts[:-1]
    return ".".join(p for p in parts if p not in (".", "")), is_pkg


def _resolve_from(modname: str, is_pkg: bool, level: int,
                  module: Optional[str]) -> str:
    if level == 0:
        return module or ""
    base = modname.split(".") if modname else []
    if not is_pkg:
        base = base[:-1]
    if level > 1:
        base = base[:len(base) - (level - 1)]
    return ".".join(base + ([module] if module else []))


def _param_types(node: ast.AST) -> Dict[str, List[ast.AST]]:
    out: Dict[str, List[ast.AST]] = {}
    args = node.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs
              + [x for x in (args.vararg, args.kwarg) if x is not None]):
        if a.annotation is not None:
            out.setdefault(a.arg, []).append(a.annotation)
    return out


def _wide_params(node: ast.AST) -> Set[str]:
    """Parameters whose default is an f32-or-wider dtype."""
    args = node.args
    pos = args.posonlyargs + args.args
    out = set()
    for a, d in zip(pos[len(pos) - len(args.defaults):], args.defaults):
        dd = _dotted(d)
        if dd and dd[-1] in _WIDE_DTYPES:
            out.add(a.arg)
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        dd = _dotted(d) if d is not None else None
        if dd and dd[-1] in _WIDE_DTYPES:
            out.add(a.arg)
    return out


def index_module(path: str, source: str) -> ModuleIndex:
    tree = ast.parse(source, filename=path)
    modname, is_pkg = _module_name(path)
    idx = ModuleIndex(path=path, tree=tree, lines=source.splitlines(),
                      modname=modname)
    for st in tree.body:
        if isinstance(st, ast.Assign):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    idx.globals.setdefault(t.id, []).append(st.value)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    idx.imports[a.asname] = (a.name, None)
                else:
                    top = a.name.split(".")[0]
                    idx.imports[top] = (top, None)
        elif isinstance(node, ast.ImportFrom):
            base = _resolve_from(modname, is_pkg, node.level, node.module)
            for a in node.names:
                idx.imports[a.asname or a.name] = (base, a.name)

    def visit(node, quals: Tuple[str, ...], parent_fn: Optional[str],
              cls: Optional[ClassInfo]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                qual = ".".join(quals + (child.name,))
                ci = ClassInfo(module=idx, qualname=qual, name=child.name,
                               node=child)
                idx.classes[qual] = ci
                for st in child.body:
                    if isinstance(st, ast.AnnAssign) \
                            and isinstance(st.target, ast.Name):
                        ci.attr_types.setdefault(st.target.id, []).append(
                            (st.annotation, None))
                visit(child, quals + (child.name,), parent_fn, ci)
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                qual = ".".join(quals + (child.name,))
                info = FunctionInfo(module=idx, qualname=qual,
                                    name=child.name, node=child,
                                    parent=parent_fn, cls=cls)
                info.local_types = _param_types(child)
                for st in _walk_own(child):
                    if isinstance(st, ast.Assign):
                        for t in st.targets:
                            if isinstance(t, ast.Name):
                                info.local_types.setdefault(
                                    t.id, []).append(st.value)
                            elif (cls is not None
                                  and isinstance(t, ast.Attribute)
                                  and isinstance(t.value, ast.Name)
                                  and t.value.id == "self"):
                                cls.attr_types.setdefault(
                                    t.attr, []).append((st.value, info))
                    elif isinstance(st, ast.AnnAssign) \
                            and isinstance(st.target, ast.Name):
                        info.local_types.setdefault(
                            st.target.id, []).append(st.annotation)
                idx.functions[qual] = info
                if cls is not None:
                    cls.methods[child.name] = info
                # what a function body defines is no method of ``cls``
                visit(child, quals + (child.name,), qual, None)
            else:
                visit(child, quals, parent_fn, cls)

    visit(tree, (), None, None)
    return idx


# ------------------------------------------------------------ the project

class Project:
    """Every indexed module, with name and type resolution across them."""

    def __init__(self, modules: Sequence[ModuleIndex]):
        self.modules = list(modules)
        self.by_modname = {m.modname: m for m in self.modules}
        self.classes_by_name: Dict[str, List[ClassInfo]] = {}
        self.methods_by_name: Dict[str, List[FunctionInfo]] = {}
        # an outside class's last name -> the project classes deriving it
        self.subclasses: Dict[str, List[ClassInfo]] = {}
        for m in self.modules:
            for ci in m.classes.values():
                self.classes_by_name.setdefault(ci.name, []).append(ci)
                for name, fn in ci.methods.items():
                    self.methods_by_name.setdefault(name, []).append(fn)
        for m in self.modules:
            for ci in m.classes.values():
                for b in ci.node.bases:
                    d = _dotted(b)
                    if d and not self.classes_of(m, b):
                        self.subclasses.setdefault(d[-1], []).append(ci)

    # -- names
    def _module_attr(self, modname: str, attr: str, depth: int = 0):
        """What ``attr`` of module ``modname`` is: a ClassInfo, a
        FunctionInfo, a module-level value expression (with its module)
        or a module; None when unknown."""
        m = self.by_modname.get(modname)
        if m is None or depth > 6:
            sub = self.by_modname.get(f"{modname}.{attr}")
            return ("module", sub) if sub is not None else None
        if attr in m.classes:
            return m.classes[attr]
        if attr in m.functions:
            return m.functions[attr]
        if attr in m.globals:
            return ("value", m, m.globals[attr])
        if attr in m.imports:
            base, name = m.imports[attr]
            if name is None:
                sub = self.by_modname.get(base)
                return ("module", sub) if sub is not None else None
            return self._module_attr(base, name, depth + 1)
        sub = self.by_modname.get(f"{modname}.{attr}")
        return ("module", sub) if sub is not None else None

    def lookup(self, module: ModuleIndex, name: str):
        """A bare name at module scope (see ``_module_attr``)."""
        return self._module_attr(module.modname, name)

    def _follow(self, ref, parts: Sequence[str]):
        """``ref.part1.part2...`` through modules (None past anything
        else)."""
        for part in parts:
            if not (isinstance(ref, tuple) and ref[0] == "module"):
                return None
            ref = self._module_attr(ref[1].modname, part)
        return ref

    def _class_named(self, module: ModuleIndex, name: str
                     ) -> Optional[ClassInfo]:
        hit = self.lookup(module, name)
        if isinstance(hit, ClassInfo):
            return hit
        if hit is None:
            cands = self.classes_by_name.get(name, [])
            if len(cands) == 1:
                return cands[0]
        return None

    def classes_of(self, module: ModuleIndex, expr: ast.AST,
                   depth: int = 0) -> List[ClassInfo]:
        """The project classes a type expression names (Optional[X],
        Union, ``X | None``, a quoted name, ``mod.X``).  A class from
        outside the project (``torch.optim.Adam``) names the project
        classes that derive it directly, when there are at most two (a
        field typed ``torch.optim.Adam`` holds a ``DeviceAdam``; one typed
        ``nn.Module`` tells nothing)."""
        found = self._classes_of(module, expr, depth)
        if not found and self.subclasses:
            d = _dotted(expr) if isinstance(expr, (ast.Name,
                                                   ast.Attribute)) else None
            if d and d[-1] not in self.classes_by_name:
                subs = self.subclasses.get(d[-1], [])
                if len(subs) <= 2:
                    return list(subs)
        return found

    def _classes_of(self, module: ModuleIndex, expr: ast.AST,
                    depth: int = 0) -> List[ClassInfo]:
        if expr is None or depth > 4:
            return []
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            try:
                expr = ast.parse(expr.value, mode="eval").body
            except SyntaxError:
                return []
        if isinstance(expr, ast.Name):
            ci = self._class_named(module, expr.id)
            return [ci] if ci else []
        if isinstance(expr, ast.Attribute):
            d = _dotted(expr)
            if d and len(d) >= 2:
                hit = self._follow(self.lookup(module, d[0]), d[1:])
                if isinstance(hit, ClassInfo):
                    return [hit]
                cands = self.classes_by_name.get(d[-1], [])
                return cands[:1] if len(cands) == 1 else []
            return []
        if isinstance(expr, ast.Subscript):
            inner = expr.slice
            elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
            out: List[ClassInfo] = []
            for e in elts:
                out += self.classes_of(module, e, depth + 1)
            return out
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.BitOr):
            return (self.classes_of(module, expr.left, depth + 1)
                    + self.classes_of(module, expr.right, depth + 1))
        return []

    # -- classes
    def bases(self, ci: ClassInfo) -> List[ClassInfo]:
        out = []
        for b in ci.node.bases:
            out += self.classes_of(ci.module, b)
        return out

    def mro(self, ci: ClassInfo) -> List[ClassInfo]:
        seen, order, work = set(), [], [ci]
        while work:
            c = work.pop(0)
            if id(c) in seen:
                continue
            seen.add(id(c))
            order.append(c)
            work += self.bases(c)
        return order

    def method(self, ci: ClassInfo, name: str) -> Optional[FunctionInfo]:
        for c in self.mro(ci):
            if name in c.methods:
                return c.methods[name]
        return None

    def attr_classes(self, ci: ClassInfo, attr: str,
                     depth: int) -> List[ClassInfo]:
        out: List[ClassInfo] = []
        for c in self.mro(ci):
            for expr, fn in c.attr_types.get(attr, []):
                if fn is None:
                    out += self.classes_of(c.module, expr)
                else:
                    out += self.expr_classes(fn, expr, depth + 1)
        return out

    # -- expressions
    def expr_classes(self, fn: FunctionInfo, expr: ast.AST,
                     depth: int = 0) -> List[ClassInfo]:
        """The project classes an expression's value may be an instance
        of, as far as names, annotations and constructors tell."""
        if depth > 5 or expr is None:
            return []
        if isinstance(expr, ast.Name):
            if expr.id in ("self", "cls"):
                owner = self._owner(fn)
                if owner is not None:
                    return [owner]
            out: List[ClassInfo] = []
            for scope in _scopes(fn):
                if expr.id in scope.local_types:
                    for t in scope.local_types[expr.id]:
                        out += (self.expr_classes(scope, t, depth + 1)
                                + self.classes_of(scope.module, t))
                    return out
            hit = self.lookup(fn.module, expr.id)
            if isinstance(hit, tuple) and hit[0] == "value":
                vfn = FunctionInfo(module=hit[1], qualname="<module>",
                                   name="<module>", node=hit[1].tree,
                                   parent=None, cls=None)
                for v in hit[2]:
                    out += self.expr_classes(vfn, v, depth + 1)
            return out
        if isinstance(expr, ast.Attribute):
            out = []
            for ci in self.expr_classes(fn, expr.value, depth + 1):
                out += self.attr_classes(ci, expr.attr, depth + 1)
            return out
        if isinstance(expr, ast.Call):
            out = []
            for target in self.call_targets(fn, expr, depth + 1,
                                            constructors=False):
                if isinstance(target, ClassInfo):
                    out.append(target)
                elif target.node.returns is not None:
                    out += self.classes_of(target.module,
                                           target.node.returns)
            return out
        if isinstance(expr, ast.IfExp):
            return (self.expr_classes(fn, expr.body, depth + 1)
                    + self.expr_classes(fn, expr.orelse, depth + 1))
        if isinstance(expr, ast.BoolOp):
            out = []
            for v in expr.values:
                out += self.expr_classes(fn, v, depth + 1)
            return out
        return []

    def _instance_call(self, classes: Iterable[ClassInfo]
                       ) -> List[FunctionInfo]:
        out = []
        for ci in classes:
            m = self.method(ci, "forward") or self.method(ci, "__call__")
            if m is not None:
                out.append(m)
        return out

    def _constructed(self, ci: ClassInfo, constructors: bool):
        if not constructors:
            return [ci]
        return [ci] + [m for m in (self.method(ci, "__init__"),
                                   self.method(ci, "__post_init__"))
                       if m is not None]

    def call_targets(self, fn: FunctionInfo, call: ast.Call,
                     depth: int = 0, constructors: bool = True):
        """FunctionInfos a call may run (and, for a constructor, its
        ClassInfo: callers that only want functions drop those)."""
        f = call.func
        if depth > 5:
            return []
        if isinstance(f, ast.Name):
            # nested defs of the enclosing functions, then module scope
            for scope in _scopes(fn):
                nested = fn.module.functions.get(f"{scope.qualname}.{f.id}")
                if nested is not None:
                    return [nested]
            if self._is_local(fn, f.id):
                return (self._instance_call(
                    self.expr_classes(fn, f, depth + 1))
                    + self._bound_methods(fn, f.id, depth + 1))
            hit = self.lookup(fn.module, f.id)
            if isinstance(hit, FunctionInfo):
                return [hit]
            if isinstance(hit, ClassInfo):
                return self._constructed(hit, constructors)
            if isinstance(hit, tuple) and hit[0] == "value":
                return self._instance_call(
                    self.expr_classes(fn, f, depth + 1))
            return []
        if isinstance(f, ast.Attribute):
            # a class or module reference: Cls.method, Fn.apply, mod.fn
            d = _dotted(f.value)
            if d and self._external(fn, d[0]) \
                    and not self._is_local(fn, d[0]):
                return []
            ref = None
            if d and d[0] not in ("self", "cls") \
                    and not self._is_local(fn, d[0]):
                ref = self.lookup(fn.module, d[0])
                if len(d) > 1:
                    ref = self._follow(ref, d[1:])
            if isinstance(ref, ClassInfo):
                if f.attr == "apply":
                    fwd = self.method(ref, "forward")
                    bwd = self.method(ref, "backward")
                    if fwd is not None and bwd is not None:
                        return [fwd, bwd]
                m = self.method(ref, f.attr)
                return [m] if m is not None else []
            if isinstance(ref, tuple) and ref[0] == "module":
                hit = self._module_attr(ref[1].modname, f.attr)
                if isinstance(hit, FunctionInfo):
                    return [hit]
                if isinstance(hit, ClassInfo):
                    return self._constructed(hit, constructors)
                return []
            receivers = self.expr_classes(fn, f.value, depth + 1)
            if receivers:
                out: List = []
                for ci in receivers:
                    m = self.method(ci, f.attr)
                    if m is not None:
                        out.append(m)
                    else:
                        out += self._instance_call(
                            self.attr_classes(ci, f.attr, depth + 1))
                return out
            if f.attr not in _GENERIC_METHODS:
                cands = self.methods_by_name.get(f.attr, [])
                if len(cands) == 1:
                    return cands
            return []
        if isinstance(f, (ast.IfExp, ast.Subscript, ast.Call)):
            return self._instance_call(self.expr_classes(fn, f, depth + 1))
        return []

    def _bound_methods(self, fn: FunctionInfo, name: str,
                       depth: int) -> List[FunctionInfo]:
        """Methods a local name is bound to (``f = self.m``, ``f = a.m if c
        else b.n``)."""
        out: List[FunctionInfo] = []
        scope = next((s for s in _scopes(fn) if name in s.local_types), None)
        if scope is None or depth > 5:
            return out
        work = list(scope.local_types[name])
        while work:
            v = work.pop()
            if isinstance(v, ast.IfExp):
                work += [v.body, v.orelse]
            elif isinstance(v, ast.Attribute):
                for ci in self.expr_classes(scope, v.value, depth + 1):
                    m = self.method(ci, v.attr)
                    if m is not None:
                        out.append(m)
        return out

    def _owner(self, fn: FunctionInfo) -> Optional[ClassInfo]:
        """The class of the method ``fn`` is, or is nested in."""
        return next((s.cls for s in _scopes(fn) if s.cls is not None), None)

    def _external(self, fn: FunctionInfo, name: str) -> bool:
        """``name`` is imported from outside the linted files (torch,
        numpy, the standard library)."""
        imp = fn.module.imports.get(name)
        if imp is None:
            return False
        base, attr = imp
        return base not in self.by_modname and not (
            attr is not None and f"{base}.{attr}" in self.by_modname)

    def _is_local(self, fn: FunctionInfo, name: str) -> bool:
        """``name`` is a parameter or a local of ``fn`` or of a function
        it is nested in."""
        for scope in _scopes(fn):
            args = getattr(scope.node, "args", None)
            if name in scope.local_types or (args is not None and name in {
                    a.arg for a in args.posonlyargs + args.args
                    + args.kwonlyargs}):
                return True
        return False

    # -- reachability
    def reachable(self, roots: Sequence[str]) -> Dict[Tuple[str, str], str]:
        """(path, qualname) of every function reachable from a function
        whose qualname is in ``roots`` -> the root that reaches it."""
        work: List[Tuple[FunctionInfo, str]] = []
        for m in self.modules:
            for info in m.functions.values():
                if info.qualname in roots:
                    work.append((info, info.qualname))
        seen: Dict[Tuple[str, str], str] = {}
        while work:
            info, root = work.pop()
            key = (info.path, info.qualname)
            if key in seen:
                continue
            seen[key] = root
            for node in _walk_own(info.node):
                if isinstance(node, ast.Call):
                    for t in self.call_targets(info, node):
                        if isinstance(t, FunctionInfo):
                            work.append((t, root))
            prefix = info.qualname + "."
            for other in info.module.functions.values():
                if other.qualname.startswith(prefix):
                    work.append((other, root))
        return seen


# ------------------------------------------------------------------ rules

class _RuleContext:
    def __init__(self, info: FunctionInfo, findings: List[Finding]):
        self.info = info
        self.findings = findings

    def add(self, rule: str, node: ast.AST, message: str):
        lines = self.info.module.lines
        line = getattr(node, "lineno", 1)
        text = lines[line - 1].strip() if 1 <= line <= len(lines) else ""
        self.findings.append(Finding(
            rule=rule, path=self.info.path, line=line,
            col=getattr(node, "col_offset", 0) + 1,
            symbol=self.info.qualname, message=message, line_text=text))


def _tensor_names(fn_node: ast.AST) -> Set[str]:
    """Local names bound to a tensor-ish value in this function (to a
    fixed point over its own assignments)."""
    assigns = [(t.id, st.value) for st in _walk_own(fn_node)
               if isinstance(st, ast.Assign) for t in st.targets
               if isinstance(t, ast.Name)]
    names: Set[str] = set()
    grew = True
    while grew:
        grew = False
        for name, value in assigns:
            if name not in names and _tensorish(value, names):
                names.add(name)
                grew = True
    return names


def _tensorish(expr: ast.AST, names: Set[str]) -> bool:
    """Does this expression (heuristically) evaluate to a tensor?"""
    if isinstance(expr, ast.Name):
        return expr.id in names
    if isinstance(expr, ast.Call):
        d = _dotted(expr.func)
        if d and d[0] == "torch" and len(d) >= 2 \
                and d[1] not in _TORCH_NON_TENSOR:
            return True
        if isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in _TENSOR_METHODS:
            return _tensorish(expr.func.value, names) or not (
                isinstance(expr.func.value, ast.Name)
                and expr.func.value.id in ("np", "numpy", "math"))
        return False
    if isinstance(expr, ast.Attribute):
        # a field's type is not known (``x.shape`` is a host value, a
        # dataclass field may be either)
        return False
    if isinstance(expr, ast.Subscript):
        return _tensorish(expr.value, names)
    if isinstance(expr, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for op in expr.ops):
            return False
        return any(_tensorish(e, names)
                   for e in [expr.left, *expr.comparators])
    if isinstance(expr, ast.BinOp):
        return _tensorish(expr.left, names) or _tensorish(expr.right, names)
    if isinstance(expr, ast.UnaryOp):
        return _tensorish(expr.operand, names)
    if isinstance(expr, ast.BoolOp):
        return any(_tensorish(v, names) for v in expr.values)
    return False


def _check_r1_r3(ctx: _RuleContext, root: str, rules: Set[str]):
    """Host reads (R1) and global RNG / clock reads (R3) in a function
    reachable from a step entry point."""
    tensors = _tensor_names(ctx.info.node)
    via = "" if root == ctx.info.qualname else f" (reached from {root})"

    def r1(node, what):
        if "R1" in rules:
            ctx.add("R1", node, f"{what} inside a step{via}: a "
                    "device-to-host sync (the host waits for the card's "
                    "queue; a captured CUDA graph cannot hold it)")

    def r3(node, what):
        if "R3" in rules:
            ctx.add("R3", node, f"{what} inside a step{via}: draw from an "
                    "explicit torch.Generator / numpy Generator "
                    "(agents.ddpg.Draws) and keep clocks outside the "
                    "step, so runs and resumes stay reproducible")

    for node in _walk_own(ctx.info.node):
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            if _tensorish(node.test, tensors):
                r1(node.test, "the truth value of a tensor")
            continue
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        d = _dotted(f)
        kwargs = {kw.arg for kw in node.keywords}
        if isinstance(f, ast.Attribute):
            if f.attr in _SYNC_METHODS and not node.args \
                    and not node.keywords:
                r1(node, f".{f.attr}()")
            elif f.attr == "synchronize":
                r1(node, f"{'.'.join(d) if d else '.synchronize'}()")
            if d and d[0] == "torch" and len(d) == 2 \
                    and d[1] in _RAND_FUNCS and "generator" not in kwargs:
                r3(node, f"torch.{d[1]}() without generator=")
            elif f.attr in _RAND_METHODS and "generator" not in kwargs \
                    and not (d and d[0] == "torch"):
                r3(node, f".{f.attr}() without generator=")
            elif d and d[0] == "torch" and d[-1] in _SEED_FUNCS:
                r3(node, f"{'.'.join(d)}() (the global generator)")
            elif d and len(d) >= 3 and d[0] in ("np", "numpy") \
                    and d[1] == "random" and d[2] not in _NP_GENERATORS:
                r3(node, f"{'.'.join(d)}() (numpy's global generator)")
            elif d and len(d) == 2 and d[0] == "random" \
                    and d[1] not in ("Random", "SystemRandom"):
                r3(node, f"random.{d[1]}() (Python's global generator)")
            elif d and d[0] == "time" and f.attr in _TIME_ATTRS:
                r3(node, f"time.{f.attr}() (a wall-clock read)")
            elif d and "datetime" in d[:-1] and f.attr in _DATETIME_ATTRS:
                r3(node, f"{'.'.join(d)}() (a wall-clock read)")
        elif isinstance(f, ast.Name):
            if f.id in _CAST_BUILTINS and len(node.args) == 1 \
                    and _tensorish(node.args[0], tensors):
                r1(node, f"{f.id}() of a tensor")


def _dtype_gate(test: ast.AST) -> Optional[str]:
    """'f32' for an f32 gate (``<dtype-ish> is None``, ``<x>.dtype ==
    torch.float32``), 'low' for a low-precision gate (``<dtype-ish> is
    not None``, ``<x>.dtype == torch.bfloat16``), else None."""
    if not isinstance(test, ast.Compare) or len(test.ops) != 1:
        return None
    op, right = test.ops[0], test.comparators[0]
    if isinstance(op, ast.Eq):
        for side in (test.left, right):
            d = _dotted(side)
            if d and d[-1] == "float32":
                return "f32"
            if d and d[-1] in _LOW_DTYPES:
                return "low"
        return None
    if isinstance(op, (ast.Is, ast.IsNot)) and isinstance(right, ast.Constant) \
            and right.value is None:
        d = _dotted(test.left)
        if d:
            last = d[-1].lower()
            if last in ("cd", "mdt") or "dtype" in last or "dt" in last:
                return "f32" if isinstance(op, ast.Is) else "low"
    return None


def _ends_in_exit(body: Sequence[ast.stmt]) -> bool:
    return bool(body) and isinstance(body[-1], (ast.Return, ast.Raise))


def _widened(expr: ast.AST, wide: Set[str]) -> bool:
    """Does this expression hold f32 or wider values, as written: a cast
    (``.float()``, ``.double()``, ``.to()``/``.type()`` of float32/float64
    or of a name in ``wide``), a tensor made with such a ``dtype=``, a
    name in ``wide`` (bound to one of these), or arithmetic, a
    ``torch.where``, a conditional, an index, a method or a ``torch``
    function of one (type promotion keeps the wider float)."""
    def wide_dtype(node) -> bool:
        d = _dotted(node)
        return bool(d) and (d[-1] in _WIDE_DTYPES
                            or (len(d) == 1 and d[0] in wide))

    if isinstance(expr, ast.Name):
        return expr.id in wide
    if isinstance(expr, ast.BinOp):
        return _widened(expr.left, wide) or _widened(expr.right, wide)
    if isinstance(expr, ast.UnaryOp):
        return _widened(expr.operand, wide)
    if isinstance(expr, ast.IfExp):
        return _widened(expr.body, wide) and _widened(expr.orelse, wide)
    if isinstance(expr, ast.Subscript):
        return _widened(expr.value, wide)
    if not isinstance(expr, ast.Call):
        return False
    if any(kw.arg == "dtype" and wide_dtype(kw.value)
           for kw in expr.keywords):
        return True
    f = expr.func
    d = _dotted(f)
    if isinstance(f, ast.Attribute) and not (d and d[0] == "torch"):
        if f.attr in ("float", "double") and not expr.args:
            return True
        if f.attr in ("to", "type"):
            return bool(expr.args) and wide_dtype(expr.args[0])
        if f.attr in ("half", "bfloat16"):
            return False
        return _widened(f.value, wide)
    if d and d[0] == "torch":
        if d[-1] == "where" and len(expr.args) == 3:
            return (_widened(expr.args[1], wide)
                    and _widened(expr.args[2], wide))
        args = expr.args[1:] if d[-1] == "einsum" else expr.args[:1]
        return bool(args) and all(_widened(a, wide) for a in args)
    return False


def _wide_names(fn_node: ast.AST) -> Set[str]:
    """Parameters whose default is an f32-or-wider dtype, and local names
    every assignment of which is widened (the greatest fixed point, so
    ``x = x * 2`` keeps a widened ``x``)."""
    params = _wide_params(fn_node)
    values: Dict[str, List[ast.AST]] = {}
    for st in _walk_own(fn_node):
        targets = (st.targets if isinstance(st, ast.Assign)
                   else [st.target] if isinstance(st, (ast.AugAssign,
                                                       ast.AnnAssign))
                   else [])
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    # a tuple target's part is not known to be widened
                    values.setdefault(n.id, []).append(
                        st.value if t is n and st.value is not None
                        else None)
    wide = params | set(values)
    changed = True
    while changed:
        changed = False
        for name, vals in values.items():
            if name in wide and name not in params and not all(
                    v is not None and _widened(v, wide) for v in vals):
                wide.discard(name)
                changed = True
    return wide


def _check_r4(ctx: _RuleContext):
    """Products in a bf16-policy module whose accumulation dtype the
    precision policy does not make explicit."""
    wide = _wide_names(ctx.info.node)

    def product(node) -> Optional[Tuple[str, List[ast.AST]]]:
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            return "`@`", [node.left, node.right]
        if not isinstance(node, ast.Call):
            return None
        d = _dotted(node.func)
        if d and d[0] == "torch" and d[-1] in _DOT_FUNCS:
            ops = node.args[1:] if d[-1] == "einsum" else node.args[:2]
            return f"{'.'.join(d)}()", list(ops)
        if d and d[-1] == "linear" and len(d) >= 2 \
                and (d[-2] in ("F", "functional")):
            return f"{'.'.join(d)}()", list(node.args[:2])
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _DOT_METHODS and node.args \
                and not (d and d[0] == "torch"):
            return f".{node.func.attr}()", [node.func.value, node.args[0]]
        return None

    def scan(nodes: Iterable[ast.AST], f32_safe: bool):
        nodes = list(nodes)
        for i, node in enumerate(nodes):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(node, ast.If):
                gate = _dtype_gate(node.test)
                scan([node.test], f32_safe)
                scan(node.body, f32_safe or gate == "f32")
                scan(node.orelse, f32_safe or gate == "low")
                if gate == "low" and _ends_in_exit(node.body):
                    # the low-precision case returned: the rest is f32
                    scan(nodes[i + 1:], True)
                    return
                continue
            if not f32_safe:
                hit = product(node)
                if hit is not None:
                    what, operands = hit
                    if not operands or not all(_widened(o, wide)
                                               for o in operands):
                        ctx.add("R4", node,
                                f"{what} in a bf16-policy module with an "
                                "operand that is not widened to f32 "
                                "(`.float()`, `.to(torch.float32)`) "
                                "outside an f32-gated branch: under the "
                                "bf16 policy it would not accumulate as "
                                "the policy's f32 products do")
            scan(ast.iter_child_nodes(node), f32_safe)

    scan(getattr(ctx.info.node, "body", []), False)


# ------------------------------------------------------------------ driver

def _iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__"
                                 and not d.startswith((".", "_build")))
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(root, f))
        elif p.endswith(".py"):
            out.append(p)
    return out


def _is_policy_module(path: str) -> bool:
    parts = path.replace(os.sep, "/").split("/")
    return "ops" in parts or "models" in parts


def lint_files(files: Sequence[str], rules: Optional[Set[str]] = None,
               root: Optional[str] = None) -> Tuple[List[Finding], int]:
    """Raw (un-baselined) findings over ``files``.  ``root`` anchors the
    repo-relative paths used in fingerprints (default: cwd)."""
    root = os.path.abspath(root or os.getcwd())
    rules = set(rules) if rules else set(RULE_IDS)
    modules: List[ModuleIndex] = []
    for path in files:
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            rel = os.path.relpath(os.path.abspath(path), root)
            modules.append(index_module(rel.replace(os.sep, "/"), source))
        except (OSError, SyntaxError) as e:
            raise RuntimeError(f"gsc-lint cannot parse {path}: {e}") from e

    project = Project(modules)
    reach = (project.reachable(STEP_ROOTS) if rules & {"R1", "R3"}
             else {})
    findings: List[Finding] = []
    from .concur import check_concurrency
    concur_rules = {"R6", "R7", "R8", "R9", "R10"}
    for m in modules:
        policy_module = _is_policy_module(m.path)
        for info in m.functions.values():
            ctx = _RuleContext(info, findings)
            step_root = reach.get((m.path, info.qualname))
            if step_root is not None:
                _check_r1_r3(ctx, step_root, rules)
            if "R4" in rules and policy_module:
                _check_r4(ctx)
        if rules & concur_rules:
            findings.extend(check_concurrency(m))
    findings = [f for f in findings if f.rule in rules]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, len(modules)


def lint_paths(paths: Sequence[str], baseline_path: Optional[str] = None,
               rules: Optional[Set[str]] = None,
               root: Optional[str] = None) -> LintResult:
    """Lint files and directories and apply the suppression baseline."""
    files = _iter_py_files(paths)
    raw, nfiles = lint_files(files, rules=rules, root=root)
    entries = load_baseline(baseline_path)
    if rules:
        entries = [e for e in entries
                   if e.get("rule") in rules or not e.get("rule")]
    return build_result(raw, entries, nfiles)
