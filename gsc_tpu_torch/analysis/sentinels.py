"""Runtime sentinels: kernel-build monitoring and host-sync guarding.

The port of ``gsc_tpu.analysis.sentinels``, under the same names.  The
JAX package watches jit traces and XLA compiles; the port compiles
nothing while it runs but its kernel libraries, so its sentinels watch
those:

- :class:`CompileMonitor` hooks ``ops.build`` (every library built with
  ``nvcc`` or loaded with ``ctypes``; the native traffic sampler's g++
  build and load report there too) and ``ops.resource_codegen`` (every
  plugin header generated for kernel #2) and, wired into a
  :class:`~gsc_tpu_torch.obs.MetricsHub`, emits one ``compile`` event per
  occurrence into the run's ``events.jsonl`` (``fn``: the library, as its
  file is named, or ``resource_plugins_<digest>``; ``stage``: ``"build"``
  or ``"load"``; ``duration_s``; ``count``), rendered by
  ``tools/obs_report.py`` and ``obs.trace``;
- :func:`assert_no_retrace`: fails with :class:`RetraceError` when a
  watched library is built or loaded inside the region (a steady-state
  loop reuses what it loaded once);
- :func:`no_host_sync`: fails with :class:`HostSyncError`, naming the
  region, on a device-to-host synchronisation inside it: on the card
  every synchronizing CUDA operation of the guarded thread
  (``analysis.launches.SyncWatch``), on any device a read of a tensor's
  value into Python (``.item()``, ``float()``, ``bool()``: a dispatch
  tripwire on ``aten._local_scalar_dense``), which lets the CPU hold the
  same contract.
"""
from __future__ import annotations

import threading
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops.build import add_build_hook, remove_build_hook
from .launches import SyncWatch

# the port's kernel libraries (by source), the plugin headers kernel #2's
# builds include and the native traffic sampler (``native``, built with
# g++): a run builds or loads each of them once
DEFAULT_WATCH = ("gat_attention", "gat_attention_backward",
                 "substep_megakernel", "resource_plugins", "traffic_gen")


class RetraceError(AssertionError):
    """A watched kernel library was built or loaded inside a no-retrace
    region."""


class HostSyncError(AssertionError):
    """A guarded region synchronised the host with the device."""


def library_source(fn: str) -> str:
    """``gat_attention_backward_<digest>`` -> ``gat_attention_backward``."""
    return fn.rsplit("_", 1)[0]


class CompileMonitor:
    """Counts kernel-library builds and loads per library while active.

    ``hub`` (a :class:`gsc_tpu_torch.obs.MetricsHub`) is optional: with
    one, every build or load of a *watched* library (by source name;
    ``watch=None`` watches everything) emits a ``compile`` event and bumps
    ``kernel_builds_total`` / ``kernel_loads_total{fn=...}``."""

    def __init__(self, hub=None,
                 watch: Optional[Iterable[str]] = DEFAULT_WATCH):
        self.hub = hub
        self.watch = None if watch is None else set(watch)
        self._lock = threading.Lock()
        self.build_counts: Dict[str, int] = {}
        self.load_counts: Dict[str, int] = {}
        # bounded: the durable record is the hub's events.jsonl stream
        self.events: deque = deque(maxlen=1024)
        self._started = False

    def start(self) -> "CompileMonitor":
        if not self._started:
            self._started = True
            add_build_hook(self._on_event)
        return self

    def stop(self):
        if self._started:
            self._started = False
            remove_build_hook(self._on_event)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _watched(self, fn: str) -> bool:
        return self.watch is None or library_source(fn) in self.watch

    def _on_event(self, fn: str, stage: str, duration_s: float):
        if not self._watched(fn):
            return
        with self._lock:
            counts = (self.build_counts if stage == "build"
                      else self.load_counts)
            counts[fn] = n = counts.get(fn, 0) + 1
            self.events.append({"fn": fn, "stage": stage,
                                "duration_s": duration_s, "count": n})
        if self.hub is not None:
            self.hub.counter("kernel_builds_total" if stage == "build"
                             else "kernel_loads_total", fn=fn)
            # the field is `stage`, not `kind`: MetricsHub.event's first
            # parameter owns that name
            self.hub.event("compile", fn=fn, stage=stage,
                           duration_s=round(duration_s, 4), count=n)

    def snapshot(self) -> Dict[str, Tuple[int, int]]:
        """{library: (builds, loads)} for every library seen so far."""
        with self._lock:
            names = set(self.build_counts) | set(self.load_counts)
            return {n: (self.build_counts.get(n, 0),
                        self.load_counts.get(n, 0)) for n in names}

    def _total(self, names) -> Dict[str, int]:
        with self._lock:
            seen = set(self.build_counts) | set(self.load_counts)
            return {n: self.build_counts.get(n, 0) + self.load_counts.get(n, 0)
                    for n in seen
                    if not names or library_source(n) in names}

    @contextmanager
    def assert_no_retrace(self, *names: str):
        """Fail with :class:`RetraceError` if any library of ``names``
        (sources; default: any watched one) is built or loaded inside the
        region."""
        wanted = set(names)
        before = self._total(wanted)
        yield self
        after = self._total(wanted)
        grew = {n: k - before.get(n, 0) for n, k in after.items()
                if k > before.get(n, 0)}
        if grew:
            detail = ", ".join(f"{n} (+{k})" for n, k in sorted(grew.items()))
            raise RetraceError(
                f"kernel libraries built or loaded inside a no-retrace "
                f"region: {detail} — a steady-state loop reuses the "
                "libraries it loaded once")


@contextmanager
def assert_no_retrace(*names: str, hub=None):
    """Standalone guard: monitors builds and loads only for the region and
    raises :class:`RetraceError` on any of ``names`` (any library at all
    when no names are given)."""
    mon = CompileMonitor(hub=hub, watch=set(names) or None)
    with mon:
        with mon.assert_no_retrace(*names):
            yield mon


class _ItemTripwire(TorchDispatchMode):
    """Raises on a read of a tensor's value into Python."""

    def __init__(self, what: str):
        super().__init__()
        self.what = what

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise HostSyncError(
                f"a tensor's value was read into Python (.item(), float(), "
                f"bool()) inside {self.what}: a device-to-host sync")
        return func(*args, **(kwargs or {}))


@contextmanager
def no_host_sync(what: str = "guarded region"):
    """Zero device-to-host syncs inside the region on this thread.

    On every device a dispatch tripwire raises on a value read
    (``aten._local_scalar_dense``); on the card every synchronizing CUDA
    operation of this thread (copies to the host, data-dependent shapes,
    waits) raises too.  The sync-debug mode it sets is process-wide and
    restored after; other threads' syncs are not this region's.
    Host-to-device copies stay allowed."""
    watch = None
    hits = []
    if torch.cuda.is_available():
        def on_sync(message):
            hits.append(message)
            raise HostSyncError(f"a synchronizing CUDA operation inside "
                                f"{what}: {message}")
        watch = SyncWatch({threading.get_ident()}, on_sync).start()
    try:
        with _ItemTripwire(what):
            yield
    finally:
        if watch is not None:
            watch.stop()
    if hits:
        # a sync whose warning did not reach Python as an exception
        raise HostSyncError(f"a synchronizing CUDA operation inside {what}: "
                            f"{hits[0]}")
