"""Launch and operation counts of an uncompiled program: the port's
counterpart of ``gsc_tpu.analysis.hlo``.

The JAX package mines a compiled executable's HLO; the port has no
compiled program, so it counts what one observed call dispatches:

- ``CostCounter``, the tap a capture pushes (``ops.cost.KernelTap``): per
  aten call, matmul-class FLOPs (``torch.utils.flop_counter``'s formula
  registry, plus the vector forms and the composite ``linear``,
  ``matmul`` and ``einsum`` that inference mode dispatches whole), the
  bytes of its tensor inputs and
  outputs (views and bare allocations move none), and the ``ops``
  histogram (``dot``, ``gather``, ``scatter``; ``while`` is None: there
  is no loop op to count); the hand kernels' posted work
  (``ops.cost``), their data-reading counts held until the capture
  settles them (``Frame.settle``: at its end, or mid-call once the held
  inputs pass ``HOLD_BYTES``); the collectives ``parallel.mesh`` posts;
  on the CPU the reads of a tensor's value into Python (``aten._local_scalar_dense``:
  ``.item()``, ``float()``, ``bool()``), the calls that synchronise a
  CUDA stream.  Calls inside a hand kernel's wrapper or its plain version
  are left out: the kernel counts as its work, once;
- ``profile_counts``: device launches per call and a histogram by kind
  (``gemm``, each hand kernel by name, ``copy`` for memory copies and
  sets, ``collective``, ``other``) and the device seconds, from one
  ``torch.profiler`` capture of the card's activity;
- ``SyncWatch``: the card's synchronizing operations of chosen threads,
  through ``torch.cuda.set_sync_debug_mode("warn")`` (process-wide: the
  watch claims the warnings of its threads, passes on or drops the
  others, and restores the mode it found).
"""
from __future__ import annotations

import math
import re
import threading
import warnings
from typing import Callable, Dict, List, Optional, Set, Tuple

import torch
from torch.utils.flop_counter import flop_registry

from ..ops.cost import KernelTap, Work

aten = torch.ops.aten
# the autograd node running on this thread (None outside a backward)
_current_node = getattr(torch._C, "_current_autograd_node", lambda: None)

# the JAX ledger's op histogram keys (obs.perf); ``while`` has no
# counterpart in an eager program
OP_KEYS = ("while", "dot", "scatter", "gather")
_DOT = {"mm", "addmm", "bmm", "baddbmm", "addbmm", "matmul", "dot", "vdot",
        "mv", "addmv", "linear", "einsum", "_scaled_mm", "convolution",
        "_convolution"}
_GATHER = {"gather", "index", "_unsafe_index", "index_select", "take",
           "take_along_dim", "embedding"}
_SCATTER = {"scatter", "scatter_add", "scatter_reduce", "index_put",
            "_index_put_impl", "index_add", "index_copy", "index_fill",
            "masked_scatter"}
# allocations that write nothing
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided"}


def _matmul_flops(a, b, *_, **__) -> int:
    n = a.shape[-2] if a.dim() > 1 else 1
    m = b.shape[-1] if b.dim() > 1 else 1
    batch = math.prod(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    return 2 * batch * n * a.shape[-1] * m


def _einsum_flops(equation: str, operands, *_, **__) -> int:
    """2 x the product of every index's size: a pairwise contraction's
    multiply-adds (0 for one operand, a reduction)."""
    if len(operands) < 2:
        return 0
    terms = equation.replace(" ", "").split("->")[0].split(",")
    sizes, ellipses = {}, []
    for term, t in zip(terms, operands):
        dims = list(t.shape)
        if "..." in term:
            pre, post = term.split("...")
            ellipses.append(dims[len(pre):len(dims) - len(post)])
            dims = dims[:len(pre)] + dims[len(dims) - len(post):]
            term = pre + post
        for c, d in zip(term, dims):
            sizes[c] = max(sizes.get(c, 1), d)
    ell = math.prod(torch.broadcast_shapes(*ellipses)) if ellipses else 1
    return 2 * ell * math.prod(sizes.values())


# matrix products the flop registry leaves out: vector forms, and the
# composite ops that inference mode dispatches whole (``linear``,
# ``matmul``, ``einsum`` are seen before their decomposition there)
_EXTRA_FLOPS = {
    "dot": lambda a, b, *_, **__: 2 * a.numel(),
    "vdot": lambda a, b, *_, **__: 2 * a.numel(),
    "mv": lambda m, v, *_, **__: 2 * m.numel(),
    "addmv": lambda s, m, v, *_, **__: 2 * m.numel(),
    "linear": lambda x, w, *_, **__: 2 * (x.numel() // x.shape[-1])
    * w.numel(),
    "matmul": _matmul_flops,
    "einsum": _einsum_flops,
}
# the hand kernels by name, as the profiler lists their CUDA functions
# and the wrappers post them (the backward before the forward: its name
# holds the forward's)
HAND_KERNELS = ("gat_attention_backward", "gat_attention",
                "substep_megakernel")
LAUNCH_KINDS = ("gemm",) + HAND_KERNELS + ("copy", "collective", "other")
# the most bytes of the deferred counts' inputs (adjacencies, the
# substep's times and cursors) one capture holds before it settles them
# (``Frame.settle``): a learn burst builds an adjacency per forward
HOLD_BYTES = 256 << 20


def _op_name(func) -> str:
    return func.overloadpacket.__name__.rstrip("_")


def op_kind(func) -> Optional[str]:
    """The ``ops`` histogram key of an aten call, or None."""
    name = _op_name(func)
    if name in _DOT:
        return "dot"
    if name in _GATHER:
        return "gather"
    if name in _SCATTER:
        return "scatter"
    return None


def _tensor_bytes(x) -> int:
    """Bytes of the tensors in an aten call's arguments or result (nested
    in tuples and lists, as aten puts them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


def _flop_fn(func):
    """The matmul-class FLOP count of an aten op, or None."""
    fn = flop_registry.get(func.overloadpacket)
    if fn is not None:
        return lambda args, kwargs, out: fn(*args, **kwargs, out_val=out)
    extra = _EXTRA_FLOPS.get(_op_name(func))
    if extra is not None:
        return lambda args, kwargs, out: extra(*args, **kwargs)
    return None


def aten_flops(func, args, kwargs, out) -> int:
    """Matmul-class FLOPs of one aten call (0 for any other)."""
    fn = _flop_fn(func)
    return int(fn(args, kwargs, out)) if fn is not None else 0


# per aten op, looked up once: (counted: not a view, writes bytes, its
# ops key, its FLOP count or None)
_OP_INFO: Dict[object, Tuple[bool, bool, Optional[str], object]] = {}


def _op_info(func):
    info = _OP_INFO.get(func)
    if info is None:
        info = _OP_INFO[func] = (not func.is_view,
                                 _op_name(func) not in _NO_BYTES,
                                 op_kind(func), _flop_fn(func))
    return info


class Frame:
    """The counts of one observation (one entry point's observed call);
    nested observations each have their own, and every count goes to
    every open frame."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.ops = {k: 0 for k in OP_KEYS if k != "while"}
        self.host_syncs = 0
        # (name, static, deferred, data ids, consts) -> [count, data]
        self.posts: Dict[tuple, list] = {}
        # (name, count, static, deferred work) of the posts whose data
        # the capture let go of (``settle``)
        self.settled: List[tuple] = []
        self.collectives: Dict[str, List[int]] = {}
        self.launches: Optional[int] = 0
        self.by_kind: Dict[str, int] = {k: 0 for k in LAUNCH_KINDS}
        self.device_s: Optional[float] = 0.0
        self.no_profile: Optional[str] = None
        self.closed_at: Optional[float] = None

    def add_profile(self, counts: Tuple[int, Dict[str, int], float]):
        n, kinds, seconds = counts
        self.launches += n
        self.device_s += seconds
        for k, v in kinds.items():
            self.by_kind[k] += v

    def settle(self, memo: Dict[tuple, Work]) -> None:
        """Run the held posts' deferred counts (device reductions, no
        value read) once per distinct input (``memo`` is shared by the
        frames of one capture) and let go of their data."""
        for (name, static, deferred, ids, consts), (n, data) in \
                self.posts.items():
            work = None
            if deferred is not None:
                key = (deferred, ids, consts)
                if key not in memo:
                    memo[key] = deferred(*data, *consts)
                work = memo[key]
            self.settled.append((name, n, static, work))
        self.posts.clear()

    def evaluate(self, memo: Dict[tuple, Work]) -> Tuple[Work, Dict]:
        """(the kernels' work in all, per kernel ``{launches, flops,
        bytes}``), the deferred counts read here."""
        self.settle(memo)
        total, per, read = Work(), {}, {}
        for name, n, static, deferred in self.settled:
            work = static
            if deferred is not None:
                if id(deferred) not in read:
                    read[id(deferred)] = deferred.resolved()
                work = work + read[id(deferred)]
            rec = per.setdefault(name, {"launches": 0, "flops": 0.0,
                                        "bytes": 0.0})
            rec["launches"] += n
            rec["flops"] += n * work.flops
            rec["bytes"] += n * work.bytes
            total = total + work * n
        return total, per


class CostCounter(KernelTap):
    """The dispatch mode of one thread's capture: counts every aten call
    it sees into the open ``frames`` (a list the capture owns).
    ``item_syncs``: count value reads as host syncs (the CPU's measure;
    on the card ``SyncWatch`` counts them).  ``threads`` collects the
    threads that dispatched through it (the autograd engine's ones
    included)."""

    def __init__(self, frames: List[Frame], item_syncs: bool,
                 on_full: Optional[Callable[[], None]] = None):
        super().__init__()
        self.frames = frames
        self.item_syncs = item_syncs
        self.owner = threading.get_ident()
        self.threads: Set[int] = {self.owner}
        self._lock = threading.Lock()
        # bytes of the deferred counts' inputs held, by tensor; past
        # HOLD_BYTES a post on the owning thread calls ``on_full``, which
        # settles the frames and calls ``release``
        self.on_full = on_full
        self.held: Dict[int, int] = {}
        self.held_bytes = 0

    def release(self) -> None:
        """The held inputs were let go of (``Frame.settle``)."""
        with self._lock:
            self.held.clear()
            self.held_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.threads.add(threading.get_ident())
        if self.suppress or (self.plain_nodes
                             and _current_node() in self.plain_nodes):
            return out
        if func is aten._local_scalar_dense.default:
            if self.item_syncs:
                with self._lock:
                    for f in self.frames:
                        f.host_syncs += 1
            return out
        counted, writes, kind, flop_fn = _op_info(func)
        if not counted:
            return out
        nbytes = (_tensor_bytes(args) + _tensor_bytes(tuple(kwargs.values()))
                  + _tensor_bytes(out)) if writes else 0
        flops = int(flop_fn(args, kwargs, out)) if flop_fn is not None else 0
        with self._lock:
            for f in self.frames:
                f.bytes += nbytes
                f.flops += flops
                if kind is not None:
                    f.ops[kind] += 1
        return out

    def post(self, name: str, parts) -> None:
        static, deferred, data, consts = parts
        key = (name, static, deferred, tuple(id(d) for d in data),
               tuple(consts))
        with self._lock:
            for f in self.frames:
                rec = f.posts.get(key)
                if rec is None:
                    f.posts[key] = [1, data]
                else:
                    rec[0] += 1
            for d in data:
                if id(d) not in self.held:
                    self.held[id(d)] = d.numel() * d.element_size()
                    self.held_bytes += self.held[id(d)]
            full = (self.held_bytes > HOLD_BYTES
                    and threading.get_ident() == self.owner)
        if full and self.on_full is not None:
            self.on_full()

    def post_collective(self, op: str, nbytes: int) -> None:
        with self._lock:
            for f in self.frames:
                rec = f.collectives.setdefault(op, [0, 0])
                rec[0] += 1
                rec[1] += nbytes


# ---------------------------------------------------------------- profiler
def launch_kind(name: str) -> str:
    """The histogram key of one device activity's name."""
    for k in HAND_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if "nccl" in low:
        return "collective"
    if low.startswith(("memcpy", "memset")) or "memcpy" in low \
            or "memset" in low:
        return "copy"
    if any(s in low for s in ("gemm", "cutlass", "xmma", "gemv", "splitk",
                              "cublas")):
        return "gemm"
    return "other"


def profile_counts(prof) -> Tuple[int, Dict[str, int], float]:
    """(device activities, their histogram by kind, device seconds) of a
    stopped ``torch.profiler.profile``, read from its raw records (the
    profiler's own event tree costs seconds on a training step's tens of
    thousands of records)."""
    from torch.autograd import DeviceType

    n, kinds, ns = 0, {k: 0 for k in LAUNCH_KINDS}, 0
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != DeviceType.CUDA:
            continue
        n += 1
        kinds[launch_kind(evt.name())] += 1
        ns += evt.end_ns() - evt.start_ns()
    return n, kinds, ns / 1e9


# -------------------------------------------------------------- host syncs
_SYNC_MESSAGE = re.compile(r".*synchroniz", re.IGNORECASE)


class SyncWatch:
    """While started, ``on_sync(message)`` runs for every synchronizing
    CUDA operation of the threads in ``threads`` (a set the caller may
    grow); it may raise, and the exception propagates from the operation.
    Several watches may run at once; the mode and the warnings hook are
    restored when the last one stops."""

    _lock = threading.Lock()
    _active: List["SyncWatch"] = []
    _prev_mode = 0
    _prev_show = None
    _filter = ("always", _SYNC_MESSAGE, UserWarning, None, 0)

    def __init__(self, threads: Set[int], on_sync: Callable[[str], None]):
        self.threads = threads
        self.on_sync = on_sync

    @classmethod
    def _show(cls, message, category, filename, lineno, file=None,
              line=None):
        text = str(message)
        if category is UserWarning and _SYNC_MESSAGE.match(text):
            me = threading.get_ident()
            mine = [w for w in list(cls._active) if me in w.threads]
            for w in mine:
                w.on_sync(text)
            if mine or cls._prev_mode == 0:
                return
        cls._prev_show(message, category, filename, lineno, file, line)

    def start(self) -> "SyncWatch":
        with SyncWatch._lock:
            if not SyncWatch._active:
                SyncWatch._prev_mode = torch.cuda.get_sync_debug_mode()
                SyncWatch._prev_show = warnings.showwarning
                warnings.showwarning = SyncWatch._show
                warnings.filters.insert(0, SyncWatch._filter)
                warnings._filters_mutated()
                torch.cuda.set_sync_debug_mode("warn")
            SyncWatch._active.append(self)
        return self

    def stop(self) -> None:
        with SyncWatch._lock:
            if self not in SyncWatch._active:
                return
            SyncWatch._active.remove(self)
            if SyncWatch._active:
                return
            torch.cuda.set_sync_debug_mode(SyncWatch._prev_mode)
            if warnings.showwarning is SyncWatch._show:
                warnings.showwarning = SyncWatch._prev_show
            try:
                warnings.filters.remove(SyncWatch._filter)
            except ValueError:
                pass
            warnings._filters_mutated()

    @staticmethod
    def paused_sync(device) -> None:
        """``torch.cuda.synchronize(device)`` with the mode off, so that
        a watch's own waits are not counted."""
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            torch.cuda.synchronize(device)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
