"""The work of the port's hand kernels, and the tap their wrappers post
each launch to.

Work counts (``Work``: operations and bytes) are functions of a launch's
inputs, whichever implementation runs, so a kernel counts the same work
on the card and in its plain version on the CPU:

- ``attention_work`` / ``attention_backward_work``: kernel #1 and its
  gradient (``ops.gat_attention``), f32 and bf16.  Bytes: every input
  read once, every output written once, in its dtype; operations per
  edge and per row of the adjacency (the edge and row counts read the
  adjacency);
- ``substep_work``: kernel #2 (``ops.substep``) in the duration, per-flow
  and plugin modes.  Bytes: every state leaf read once and every leaf
  the substep writes written once (the release rings only in the rows
  it touches), the topology, the interval's capacities, the traffic
  records it admits and one arrival time per substep; operations: a
  lower count of what every flow slot does in every substep.  Which ring
  rows take holds and how many records are admitted show only in the
  state after the launch: a caller that has it passes them
  (``ring_rows``, ``admitted``); from the inputs alone
  (``substep_launch_parts``) the rows are those the interval releases and
  the records those due within it.

``least_ms(work, dtype)`` is the least time on one H100 SXM for a work
count, over the data sheet's rates below.

The tap.  A capture (``obs.perf.CostLedger.observe``) pushes a
``KernelTap``, a ``TorchDispatchMode``, onto the thread's dispatch-mode
stack; a wrapper finds it with ``tap()`` (outside a capture: one check of
the thread's dispatch-mode stack, which PyTorch carries into the autograd
engine's threads with the rest of the caller's thread-local state) and
``posted(name, parts, *inputs)`` posts the launch's work and keeps the
wrapper's own aten calls (allocations, clones, the plain version's
operations) out of the tap's counts, so that a kernel is counted once,
as its work.  Counts that read data (the adjacency's edges, the records
due) are deferred: the tap keeps the tensors they read and evaluates them
after the observed call, never inside it.  They run as device reductions
to 0-dim tensors, read by ``Work.resolved``; where the tensors kept pass
``analysis.launches.HOLD_BYTES``, the capture runs the reductions
between two profile segments and lets the tensors go (no value is read
inside the call).  On the CPU the
attention's gradient is autograd's through the plain version:
``watch_plain_backward`` posts the backward kernel's work when autograd
reaches that subgraph and marks its nodes, whose aten calls the tap then
leaves out as well.  ``post_collective`` records one collective's payload
bytes (``parallel.mesh``) under a capture, and counts every collective by
the name of the thread that issued it (``collective_counts``), capture or
not.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

from ..sim.state import state_leaves

# one H100 SXM (NVIDIA data sheet): the HBM3 rate, the f32 rate outside
# the tensor cores (the port keeps TF32 off, device.py), and the dense
# bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# operations that every flow slot does in every substep, whatever its
# phase (the phase test and the timer's advance): a lower count, since
# what else a slot does depends on phases that are not traced
OPS_PER_SLOT_SUBSTEP = 2
RINGS = ("rel_node", "rel_edge")
# the fields of one traffic record the kernel reads when it admits it
RECORD_FIELDS = 7


@dataclass(frozen=True)
class Work:
    """Operations and bytes of one launch."""

    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)

    def resolved(self) -> "Work":
        """With plain floats: a deferred count's fields are 0-dim tensors
        on the data's device until read here."""
        return Work(float(self.flops), float(self.bytes))


def flop_rate(dtype: torch.dtype) -> float:
    """The card's peak operation rate for inputs of ``dtype``."""
    return BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S


def least_ms(work: Work, dtype: torch.dtype = torch.float32
             ) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the peak rate for ``dtype``."""
    t_bytes = work.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = work.flops / flop_rate(dtype) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------- kernel #1
def edge_ops(adj: torch.Tensor, per_edge: int, per_row: int) -> Work:
    """Operations on an adjacency: ``per_edge`` per edge, ``per_row`` per
    row with a neighbour, as a 0-dim integer tensor on ``adj``'s device
    (``Work.resolved`` reads it)."""
    edges = adj.sum(dtype=torch.int64)
    rows = adj.any(dim=-1).sum(dtype=torch.int64)
    return Work(edges * per_edge + rows * per_row, 0.0)


def attention_parts(xl, xr, att, bias, adj):
    """(bytes as ``Work``, the deferred count, its data, its constants) of
    one forward launch: xl, xr, att, bias, adj read once and the output
    (xl's shape and dtype) written once; per edge the add, the leaky
    select, the multiply-add into the logit (4F), exp and normalise (2)
    and the weighted accumulate (2F), per row the divide and the bias
    (2F)."""
    f = xl.shape[-1]
    static = Work(0.0, float(_nbytes(xl, xr, att, bias, adj, xl)))
    return static, edge_ops, (adj,), (6 * f + 3, 2 * f)


def attention_backward_parts(grad_out, xl, xr, att, adj):
    """As ``attention_parts`` for the gradient: grad_out, xl, xr, att and
    adj read once, d_xl and d_xr (the features' dtype) and d_att, d_bias
    (att's dtype) written once; per edge the logit again (4F), exp and
    normalise (3), dalpha (2F), dl (4), d_att's multiply-add (2F),
    LeakyReLU' and dl x att (2F), the d_xr add (F) and d_xl's multiply-add
    and add (3F); per row g / d_i, the empty-row select and the d_bias add
    (3F)."""
    f = xl.shape[-1]
    nbytes = _nbytes(grad_out, xl, xr, att, adj) \
        + 2 * xl.numel() * xl.element_size() + 2 * f * att.element_size()
    return Work(0.0, float(nbytes)), edge_ops, (adj,), (14 * f + 7, 3 * f)


def _evaluate(parts) -> Work:
    static, deferred, data, consts = parts
    return (static + deferred(*data, *consts)).resolved() if deferred \
        else static


def attention_work(xl, xr, att, bias, adj) -> Work:
    """One forward launch's work on these inputs (reads ``adj``)."""
    return _evaluate(attention_parts(xl, xr, att, bias, adj))


def attention_backward_work(grad_out, xl, xr, att, adj) -> Work:
    """One backward launch's work on these inputs (reads ``adj``)."""
    return _evaluate(attention_backward_parts(grad_out, xl, xr, att, adj))


# ---------------------------------------------------------------- kernel #2
def _substep_bytes(engine, state, batch: int, k: int, written, skip,
                   extra_bytes: int, ring_rows: Dict[str, int]) -> int:
    read_only = tuple(n for n in ("sf_startup", "placed", "schedule")
                      if n not in written)
    nbytes = extra_bytes
    for name, t in state_leaves(state).items():
        if name == "run_idx" or name in RINGS or name in skip:
            continue
        n = t.numel() * t.element_size()
        nbytes += n if name in read_only else 2 * n
    h = engine.H
    for name in RINGS:
        ring = getattr(state, name)
        row = ring.numel() // (ring.shape[0] * h) * ring.element_size()
        nbytes += 2 * ring_rows[name] * row
    n_nn, e = engine.N * engine.N, engine.E
    nbytes += 3 * n_nn * 4 + 2 * e * 4 + batch * engine.N * 4
    return nbytes + k * batch * 4


def substep_work(engine, state, batch: int, substeps: Optional[int] = None,
                 written: Sequence[str] = (), skip: Sequence[str] = (),
                 extra_bytes: int = 0,
                 ring_rows: Optional[Dict[str, int]] = None,
                 admitted: int = 0) -> Work:
    """One launch of ``substeps`` substeps (default: the interval) of
    ``batch`` replicas from the state it starts from: every leaf read once
    and every leaf the substep writes written once (``placed`` and
    ``sf_startup`` only where named in ``written``; the leaves in ``skip``
    not at all), of the two release rings the ``ring_rows`` rows of each
    read and written (default: the rows the interval releases), the
    topology, the interval's capacities, ``admitted`` traffic records and
    one arrival time per substep read once, and ``extra_bytes``; against
    ``OPS_PER_SLOT_SUBSTEP`` operations per slot and substep."""
    k = engine.substeps if substeps is None else substeps
    if ring_rows is None:
        ring_rows = {name: batch * min(k, engine.H) for name in RINGS}
    nbytes = _substep_bytes(engine, state, batch, k, written, skip,
                            extra_bytes, ring_rows) \
        + admitted * RECORD_FIELDS * 4
    return Work(float(OPS_PER_SLOT_SUBSTEP * engine.M * k * batch),
                float(nbytes))


def due_records(t: torch.Tensor, cursor: torch.Tensor,
                arr_time: torch.Tensor, span: float) -> Work:
    """The bytes of the traffic records due within ``span`` seconds of
    each replica's time ``t``, from its ``cursor`` on, as a 0-dim integer
    tensor on their device (``Work.resolved`` reads it)."""
    idx = torch.arange(arr_time.shape[-1], device=arr_time.device)
    due = (idx[None, :] >= cursor.long()[:, None]) \
        & (arr_time < (t + span)[:, None]) & torch.isfinite(arr_time)
    return Work(0.0, due.sum(dtype=torch.int64) * (RECORD_FIELDS * 4))


def substep_launch_parts(engine, state, traffic, substeps, ext_decisions):
    """The parts of one launch from its inputs alone: the mode's leaves
    (per-flow control writes ``placed`` and ``sf_startup`` and touches
    neither the WRR schedule nor its counts, and reads the decisions; the
    idle expiry writes ``placed``), the released ring rows, and the
    records due in the launch's substeps, deferred."""
    k = int(substeps if substeps is not None else
            1 if ext_decisions is not None else engine.substeps)
    written, skip, extra = set(), (), 0
    if ext_decisions is not None:
        written |= {"placed", "sf_startup"}
        skip = ("schedule", "metrics.run_flow_counts")
        extra = ext_decisions.numel() * 4
    if engine.cfg.controller == "per_flow":
        written.add("placed")
    static = substep_work(engine, state, state.batch, k, tuple(written),
                          skip, extra)
    return (static, due_records, (state.t, state.cursor, traffic.arr_time),
            (k * engine.dt,))


# --------------------------------------------------------------------- tap
class KernelTap(TorchDispatchMode):
    """What a capture pushes on the thread's dispatch-mode stack; its
    subclass (``analysis.launches.CostCounter``) counts the aten calls.
    ``post`` records a launch's work, ``suppress`` (a depth) keeps aten
    calls out of the counts, ``plain_nodes`` holds the autograd nodes of
    plain versions whose backward aten calls are left out too."""

    def __init__(self):
        super().__init__()
        self.suppress = 0
        self.plain_nodes = set()

    def post(self, name: str, parts) -> None:
        raise NotImplementedError

    def post_collective(self, op: str, nbytes: int) -> None:
        raise NotImplementedError

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def tap() -> Optional[KernelTap]:
    """The capture's tap on this thread's dispatch-mode stack, or None."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, KernelTap):
            return mode
    return None


class posted:
    """``with posted(name, parts_fn, *inputs) as t:`` around a launch or
    its plain version: under a capture posts ``parts_fn(*inputs)`` as one
    launch of ``name`` and keeps the aten calls inside out of the counts;
    ``t`` is the tap (None outside a capture, where nothing else
    happens)."""

    __slots__ = ("tap",)

    def __init__(self, name: str, parts_fn: Callable, *inputs):
        t = tap()
        self.tap = t
        if t is not None:
            t.suppress += 1
            try:
                t.post(name, parts_fn(*inputs))
            finally:
                t.suppress -= 1

    def __enter__(self) -> Optional[KernelTap]:
        if self.tap is not None:
            self.tap.suppress += 1
        return self.tap

    def __exit__(self, *exc) -> bool:
        if self.tap is not None:
            self.tap.suppress -= 1
        return False


def watch_plain_backward(t: Optional[KernelTap], out: torch.Tensor,
                         inputs: Sequence[torch.Tensor], name: str,
                         parts_fn: Callable, *parts_inputs) -> None:
    """Under a capture, for a plain version's output ``out`` with a
    gradient: mark the autograd nodes between ``out`` and ``inputs`` as
    the plain version's (their backward aten calls are left out) and post
    ``parts_fn(*parts_inputs)`` as one launch of ``name`` when autograd
    reaches ``out``'s node, as the kernel's backward would launch."""
    if t is None or out.grad_fn is None:
        return
    stop = {x.grad_fn for x in inputs
            if isinstance(x, torch.Tensor) and x.grad_fn is not None}
    nodes, stack = set(), [out.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in stop or node in nodes \
                or type(node).__name__ == "AccumulateGrad":
            continue
        nodes.add(node)
        stack.extend(n for n, _ in node.next_functions)
    t.plain_nodes |= nodes
    t.suppress += 1
    try:
        parts = parts_fn(*parts_inputs)
    finally:
        t.suppress -= 1
    out.grad_fn.register_prehook(lambda grads: t.post(name, parts))


# collectives issued in this process, by thread name
_COLLECTIVES: Dict[str, int] = {}   # guarded-by: _COLLECTIVES_LOCK
_COLLECTIVES_LOCK = threading.Lock()


def collective_counts() -> Dict[str, int]:
    """Collectives issued in this process so far, by thread name."""
    with _COLLECTIVES_LOCK:
        return dict(_COLLECTIVES)


def post_collective(op: str, nbytes: int) -> None:
    """Count one collective for the calling thread, and record it with
    its ``nbytes`` of payload under a capture."""
    name = threading.current_thread().name
    with _COLLECTIVES_LOCK:
        _COLLECTIVES[name] = _COLLECTIVES.get(name, 0) + 1
    t = tap()
    if t is not None:
        t.post_collective(op, int(nbytes))
