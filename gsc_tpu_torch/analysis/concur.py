"""Concurrency-discipline analysis of the port's linter (rules R6-R10).

The port runs threads: the async actor/learner fleet
(``parallel/async_rl.py``), the serving fleet and batcher
(``serve/fleet.py``, ``serve/batcher.py``), the watchdog
(``obs/watchdog.py``) and the driver's prefetcher (``env/driver.py``).
These rules are the JAX package's (``gsc_tpu.analysis.concur``), rule for
rule and finding for finding, so that both packages' code is held to one
discipline:

- **R6 lock-order cycle**: a per-module lock-acquisition graph is built
  from ``with <lock>:`` nesting and ``.acquire()``/``.release()`` pairs;
  two functions that take the same pair of locks in opposite orders form
  a cycle, and every edge on a cycle is reported.  Locks are identified
  by attribute path (``self.flush_lock`` scoped to its class,
  ``ParallelDDPG.dispatch_lock``, bare closure locks scoped to their
  outermost function), so two classes' unrelated ``self._lock`` fields
  never alias.
- **R7 guarded-by**: a field whose ``__init__`` assignment carries a
  ``# guarded-by: <lock>`` comment may only be read or written inside a
  ``with`` on that lock (or in a method annotated
  ``# requires-lock: <lock>`` on its ``def`` line, which asserts the
  caller holds it).  ``__init__`` itself is exempt: construction happens
  before any thread can see the object.
- **R8 dispatch-without-lock**: in a module that spawns threads, every
  call to a multi-rank dispatch entry point (``chunk_step`` /
  ``rollout_episodes`` / ``learn_burst`` / ``replay_ingest``) must be
  lexically under a ``dispatch_lock``.  Ranks that meet in a collective
  must issue it in one order: two threads whose dispatches interleave
  differently on two ranks wedge both (see parallel/dp.py).  Call sites
  protected by a lock INSIDE the callee carry an inline disable naming
  that invariant.
- **R9 blocking-under-lock**: while lexically holding a lock: untimed
  ``queue.get()`` / ``.wait()`` / ``.join()`` / ``.result()``, a nested
  manual ``.acquire()``, ``block_until_ready``, or a device call
  (``run_batch``).  The one deliberate case (continuous batching holds
  ``flush_lock`` across the device call so weight swaps serialize
  against in-flight dispatches) carries an inline disable with its
  reason next to the code.
- **R10 thread-ctor discipline**: every ``threading.Thread(...)`` must
  pass ``name=`` and ``daemon=True``: the watchdog's stall events and
  blackbox.json post-mortems identify threads BY NAME, and an unnamed
  thread renders as ``Thread-N``; a non-daemon worker turns any crashed
  run into a hang at interpreter exit.

Everything is lexical (stdlib ``ast``, no dataflow): a lock is anything
``with``-entered or ``.acquire()``d whose final path segment is lock-ish
(``lock`` / ``_lock`` / ``_cond`` / ``mutex`` / ``_sem``); lambda bodies
and nested ``def``s are walked with an EMPTY held set because they
execute later, usually on another thread.  False positives go to the
baseline or an inline disable with a written reason, as for R1-R4.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding

# final-path-segment heuristic for "this object is a lock"
_LOCKISH_EXACT = {"lock", "cond", "mutex"}
_LOCKISH_SUFFIX = ("_lock", "_cond", "_mutex", "_sem", "_semaphore")
_LOCKISH_PREFIX = ("lock_", "cond_")

# R8: the multi-rank dispatch entry points (ParallelDDPG's and the async
# learner's ingest; the JAX package's names, which the port keeps)
DISPATCH_NAMES = {"chunk_step", "rollout_episodes", "learn_burst",
                  "replay_ingest"}
# the lock R8 requires (matched on the final path segment, so
# `self.dispatch_lock`, `pddpg.dispatch_lock` and a bare closure
# `dispatch_lock` all satisfy it)
DISPATCH_LOCK_NAME = "dispatch_lock"

# R9: calls that hand the device (or another thread) control while the
# holder keeps its lock
_DEVICE_CALL_NAMES = {"run_batch", "block_until_ready"}
_UNTIMED_BLOCKING_ATTRS = {"get", "wait", "join", "result"}

_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][\w.]*)")
_REQUIRES_LOCK_RE = re.compile(r"#\s*requires-lock:\s*([A-Za-z_][\w.]*)")


def _is_lockish(name: str) -> bool:
    n = name.lower()
    return (n in _LOCKISH_EXACT or n.endswith(_LOCKISH_SUFFIX)
            or n.startswith(_LOCKISH_PREFIX))


def _dotted(node: ast.AST) -> Optional[List[str]]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _trailing_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


# ------------------------------------------------------------- lock naming

@dataclass
class _FnScope:
    """Naming context for one function: which class `self` binds to and
    which outermost function scopes its bare closure locks."""
    qualname: str
    node: ast.AST
    owning_class: Optional[str]    # innermost enclosing class name
    scope_root: str                # outermost enclosing function qualname
    requires: List[str] = field(default_factory=list)  # requires-lock paths


def _lock_id(parts: List[str], scope: _FnScope,
             class_names: Set[str]) -> str:
    """Canonical identity of a lock path.  `self.X` is scoped to the
    owning class (two classes' `self._lock` must not alias), bare names
    to their outermost function (closure locks are shared across nested
    defs), `Class.X` to that class, and other `obj.X` chains to a
    module-wide `*.X` (the object's class is unknown)."""
    if len(parts) == 1:
        return f"{scope.scope_root}:{parts[0]}" if scope.scope_root \
            else parts[0]
    if parts[0] == "self" and scope.owning_class:
        return f"{scope.owning_class}.{'.'.join(parts[1:])}"
    if parts[0] in class_names:
        return ".".join(parts)
    return f"*.{parts[-1]}"


@dataclass
class _Held:
    lock_id: str
    text: str          # as written, for messages
    node: ast.AST      # acquisition site
    manual: bool = False   # .acquire() (vs `with`), released by name


# ------------------------------------------------------------- the walker

class _FnWalker:
    """Source-order walk of one function body tracking the lexically held
    lock stack; emits acquisition edges (R6), attribute accesses (R7) and
    calls (R8/R9/R10) annotated with the held set at that point."""

    def __init__(self, scope: _FnScope, class_names: Set[str],
                 base_held: Sequence[_Held]):
        self.scope = scope
        self.class_names = class_names
        self.held: List[_Held] = list(base_held)
        self.edges: List[Tuple[_Held, _Held]] = []     # (outer, inner)
        self.accesses: List[Tuple[ast.Attribute, Tuple[str, ...]]] = []
        self.calls: List[Tuple[ast.Call, Tuple[str, ...],
                               Tuple[str, ...]]] = []

    # -- helpers
    def _lock_of(self, expr: ast.AST) -> Optional[Tuple[str, str]]:
        parts = _dotted(expr)
        if parts and _is_lockish(parts[-1]):
            return (_lock_id(parts, self.scope, self.class_names),
                    ".".join(parts))
        return None

    def _acquire(self, lock_id: str, text: str, node: ast.AST,
                 manual: bool) -> _Held:
        h = _Held(lock_id, text, node, manual)
        for outer in self.held:
            self.edges.append((outer, h))
        self.held.append(h)
        return h

    def _release(self, lock_id: str):
        for i in range(len(self.held) - 1, -1, -1):
            if self.held[i].manual and self.held[i].lock_id == lock_id:
                del self.held[i]
                return

    def _held_ids(self) -> Tuple[str, ...]:
        return tuple(h.lock_id for h in self.held)

    def _held_texts(self) -> Tuple[str, ...]:
        return tuple(h.text for h in self.held)

    # -- statements
    def walk(self):
        self._stmts(getattr(self.scope.node, "body", []))

    def _stmts(self, body: Sequence[ast.stmt]):
        for st in body:
            self._stmt(st)

    def _stmt(self, st: ast.stmt):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return      # nested defs run later: a separate walk, empty held
        if isinstance(st, (ast.With, ast.AsyncWith)):
            pushed: List[_Held] = []
            for item in st.items:
                self._expr(item.context_expr)
                lk = self._lock_of(item.context_expr)
                if lk:
                    pushed.append(self._acquire(
                        lk[0], lk[1], item.context_expr, manual=False))
            self._stmts(st.body)
            for h in pushed:
                if h in self.held:
                    self.held.remove(h)
        elif isinstance(st, ast.If):
            self._expr(st.test)
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self._expr(st.iter)
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, ast.While):
            self._expr(st.test)
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, ast.Try):
            self._stmts(st.body)
            for h in st.handlers:
                self._stmts(h.body)
            self._stmts(st.orelse)
            self._stmts(st.finalbody)
        else:
            self._expr(st)

    # -- expressions (source order; lambdas/nested defs excluded)
    def _expr(self, node: Optional[ast.AST]):
        if node is None:
            return
        for child in self._iter_own(node):
            if isinstance(child, ast.Call):
                self._call(child)
            elif isinstance(child, ast.Attribute):
                self.accesses.append((child, self._held_ids()))

    def _iter_own(self, node: ast.AST):
        """Pre-order walk excluding nested def/class/lambda subtrees
        (deferred execution does not inherit the lexical held set)."""
        stack = [node]
        while stack:
            n = stack.pop()
            yield n
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
                continue
            stack.extend(reversed(list(ast.iter_child_nodes(n))))

    def _call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in ("acquire",
                                                       "release"):
            lk = self._lock_of(f.value)
            if lk:
                if f.attr == "acquire":
                    # record the call (R9 sees a nested acquire) BEFORE
                    # the lock joins the held set
                    self.calls.append((node, self._held_ids(),
                                       self._held_texts()))
                    self._acquire(lk[0], lk[1], node, manual=True)
                else:
                    self._release(lk[0])
                return
        self.calls.append((node, self._held_ids(), self._held_texts()))


# ------------------------------------------------------------ module scan

def _collect_scopes(tree: ast.Module,
                    lines: List[str]) -> Tuple[List[_FnScope], Set[str]]:
    """Every function in the module with its lock-naming context, plus
    the set of class names (for `Class.lock` identities)."""
    scopes: List[_FnScope] = []
    class_names: Set[str] = set()

    def visit(node, quals: Tuple[str, ...], cls: Optional[str],
              root_fn: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                class_names.add(child.name)
                visit(child, quals + (child.name,), child.name, root_fn)
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                qual = ".".join(quals + (child.name,))
                scope = _FnScope(qualname=qual, node=child,
                                 owning_class=cls,
                                 scope_root=root_fn or qual)
                # the annotation may sit on any line of the def header
                # (a multi-line signature puts the `:` past the def line)
                body_start = child.body[0].lineno if child.body \
                    else child.lineno + 1
                header = "\n".join(
                    lines[child.lineno - 1:
                          min(body_start - 1, len(lines))]
                    or [lines[child.lineno - 1]
                        if child.lineno <= len(lines) else ""])
                scope.requires = _REQUIRES_LOCK_RE.findall(header)
                scopes.append(scope)
                visit(child, quals + (child.name,), cls,
                      root_fn or qual)
            else:
                visit(child, quals, cls, root_fn)

    visit(tree, (), None, None)
    return scopes, class_names


def _guarded_fields(tree: ast.Module,
                    lines: List[str]) -> Dict[str, Dict[str, str]]:
    """class name -> {field: guarding lock path} from `# guarded-by:`
    comments on `self.<field> = ...` lines in `__init__`."""
    out: Dict[str, Dict[str, str]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        init = next((f for f in node.body
                     if isinstance(f, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                     and f.name == "__init__"), None)
        if init is None:
            continue
        fields: Dict[str, str] = {}
        for st in ast.walk(init):
            targets: List[ast.expr] = []
            if isinstance(st, ast.Assign):
                targets = st.targets
            elif isinstance(st, (ast.AnnAssign, ast.AugAssign)):
                targets = [st.target]
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self" \
                        and st.lineno <= len(lines):
                    m = _GUARDED_BY_RE.search(lines[st.lineno - 1])
                    if m:
                        fields[t.attr] = m.group(1)
        if fields:
            out[node.name] = fields
    return out


def _module_spawns_threads(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if d and d[-1] == "Thread" \
                    and (len(d) == 1 or d[-2] == "threading"):
                return True
    return False


def check_concurrency(module) -> List[Finding]:
    """All R6-R10 findings for one indexed module (astlint.ModuleIndex:
    needs .path, .tree, .lines)."""
    findings: List[Finding] = []
    tree, lines = module.tree, module.lines
    scopes, class_names = _collect_scopes(tree, lines)
    guarded = _guarded_fields(tree, lines)
    spawns = _module_spawns_threads(tree)

    def add(rule: str, node: ast.AST, symbol: str, message: str):
        line = getattr(node, "lineno", 1)
        text = lines[line - 1].strip() if 1 <= line <= len(lines) else ""
        findings.append(Finding(
            rule=rule, path=module.path, line=line,
            col=getattr(node, "col_offset", 0) + 1,
            symbol=symbol, message=message, line_text=text))

    # lock-order graph nodes/edges accumulated module-wide for R6
    edge_sites: Dict[Tuple[str, str], List[Tuple[str, _Held, _Held]]] = {}

    for scope in scopes:
        base: List[_Held] = []
        for req in scope.requires:
            parts = req.split(".")
            base.append(_Held(_lock_id(parts, scope, class_names), req,
                              scope.node, manual=False))
        w = _FnWalker(scope, class_names, base)
        w.walk()

        for outer, inner in w.edges:
            edge_sites.setdefault((outer.lock_id, inner.lock_id),
                                  []).append((scope.qualname, outer,
                                              inner))

        # ---- R7: guarded fields only touched under their lock
        fields = guarded.get(scope.owning_class or "", {})
        if fields and scope.node.name != "__init__":
            seen: Set[int] = set()
            for attr, held in w.accesses:
                if id(attr) in seen:
                    continue
                seen.add(id(attr))
                if not (isinstance(attr.value, ast.Name)
                        and attr.value.id == "self"):
                    continue
                lock_path = fields.get(attr.attr)
                if lock_path is None:
                    continue
                need = _lock_id(lock_path.split("."), scope, class_names)
                if need not in held:
                    add("R7", attr, scope.qualname,
                        f"`self.{attr.attr}` is guarded-by "
                        f"`{lock_path}` but is touched without holding "
                        "it (take the lock, or annotate the method "
                        f"`# requires-lock: {lock_path}` if every "
                        "caller holds it)")

        # ---- R8 / R9 / R10 over call sites
        for call, held_ids, held_texts in w.calls:
            name = _trailing_name(call.func)
            kwargs = {kw.arg for kw in call.keywords}

            if spawns and name in DISPATCH_NAMES \
                    and scope.node.name not in DISPATCH_NAMES:
                if not any(h.split(".")[-1].split(":")[-1]
                           == DISPATCH_LOCK_NAME for h in held_ids):
                    add("R8", call, scope.qualname,
                        f"multi-rank dispatch `{name}()` in a "
                        "thread-spawning module outside `with "
                        "dispatch_lock:`: concurrent dispatch "
                        "interleaves the order in which threads issue "
                        "collectives and wedges the ranks' rendezvous "
                        "(see parallel/dp.py)")

            if held_ids:
                held_str = ", ".join(held_texts)
                if isinstance(call.func, ast.Attribute) \
                        and call.func.attr == "acquire":
                    add("R9", call, scope.qualname,
                        f"nested `.acquire()` while holding "
                        f"[{held_str}]: blocking on a second lock "
                        "under a held one is the deadlock half of a "
                        "lock-order inversion; prefer nested `with` so "
                        "R6 can order-check it")
                elif name in _DEVICE_CALL_NAMES:
                    add("R9", call, scope.qualname,
                        f"`{name}()` (device call) while holding "
                        f"[{held_str}]: every other thread contending "
                        "for the lock stalls for the full device "
                        "round-trip")
                elif isinstance(call.func, ast.Attribute) \
                        and call.func.attr in _UNTIMED_BLOCKING_ATTRS \
                        and not call.args \
                        and not ({"timeout", "block"} & kwargs):
                    add("R9", call, scope.qualname,
                        f"untimed `.{call.func.attr}()` while holding "
                        f"[{held_str}]: if the wakeup source needs "
                        "this lock the program deadlocks; pass a "
                        "timeout or release first")

            d = _dotted(call.func)
            if d and d[-1] == "Thread" \
                    and (len(d) == 1 or d[-2] == "threading"):
                missing = [k for k in ("name", "daemon")
                           if k not in kwargs]
                if missing:
                    add("R10", call, scope.qualname,
                        "threading.Thread(...) without "
                        f"{'/'.join(missing)}=: watchdog stall "
                        "events and blackbox.json post-mortems "
                        "identify threads BY NAME (unnamed renders "
                        "as Thread-N), and a non-daemon worker "
                        "hangs interpreter exit after a crash")

    # ---- R6: cycles in the module lock-order graph
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edge_sites:
        if a != b:
            graph.setdefault(a, set()).add(b)
        else:
            # self-edge: lexical re-entry of a held lock
            for fn, outer, inner in edge_sites[(a, b)]:
                add("R6", inner.node, fn,
                    f"`{inner.text}` re-entered while already held: "
                    "self-deadlock for a plain Lock (only an RLock "
                    "survives this; if so, disable inline with that "
                    "reason)")

    cyclic_edges = _edges_on_cycles(graph)
    for (a, b) in sorted(cyclic_edges):
        sites = edge_sites[(a, b)]
        others = sorted({fn for fn, _, _ in edge_sites.get((b, a), [])})
        who = ", ".join(others) if others else "another function"
        for fn, outer, inner in sites:
            add("R6", inner.node, fn,
                f"lock-order cycle: takes `{outer.text}` then "
                f"`{inner.text}`, but {who} nests them in the "
                "opposite order: threads interleaving these "
                "functions deadlock; pick one global order")

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def _edges_on_cycles(graph: Dict[str, Set[str]]) -> Set[Tuple[str, str]]:
    """Edges whose endpoints share a strongly connected component (every
    such edge participates in some cycle)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    comp: Dict[str, int] = {}
    counter = [0]
    ncomp = [0]

    def strongconnect(v: str):
        # iterative Tarjan (fixtures can be arbitrarily deep)
        work = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if low[node] == index[node]:
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp[w] = ncomp[0]
                    if w == node:
                        break
                ncomp[0] += 1
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    nodes = set(graph) | {b for bs in graph.values() for b in bs}
    for v in sorted(nodes):
        if v not in index:
            strongconnect(v)
    return {(a, b) for a, bs in graph.items() for b in bs
            if comp.get(a) == comp.get(b)}
