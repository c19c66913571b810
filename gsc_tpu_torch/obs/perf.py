"""Device-cost ledger: FLOPs, bytes, launches and host syncs per entry
point, merged with the run's measured wall into MFU and roofline.

The port of ``gsc_tpu.obs.perf``, same schema (``PERF_SCHEMA_VERSION``
1, ``perf.json`` next to ``metrics.json``, one ``compile_cost`` event per
capture).  The JAX ledger AOT-lowers each watched entry point and mines
the compiled program without running it; the port has no compiled
program, so it observes one real dispatch of each entry point
(``CostLedger.observe``): the first, and again the first that learns
where the first did not.  While the observed call runs, one thread-local
capture watches it, and only watches (results are bit-identical with the
ledger on and off):

- a ``TorchDispatchMode`` (``analysis.launches.CostCounter``): matmul
  FLOPs and the bytes of every aten call's inputs and outputs, the
  ``ops`` histogram, and the tap the hand kernels' wrappers post to
  (``ops.cost``); a kernel counts its own work whether the CUDA kernel or
  its plain version ran, once (the aten calls of a plain version are not
  counted again), and what its count reads from the data is read after
  the observed call;
- on the card, ``torch.profiler`` (device launches per call by kind and
  the kernels' device seconds, ``device_s``) and the sync-debug mode
  (``host_syncs``: the synchronizing operations of the capturing thread
  and of the autograd threads that ran its backward); on the CPU
  ``host_syncs`` counts value reads (``.item()``, ``float()``,
  ``bool()``) and ``launches``/``device_s`` are None with the reason in
  ``no_profile``, as they are where a profiler was already running.
  The wrappers' posts check the profile: one that lost records (the
  card's profiler drops some now and then) leaves ``launches`` and
  ``device_s`` None, with the counts in ``no_profile``.

``flops`` is the matmul FLOPs plus the hand kernels' operation counts,
``bytes_accessed`` the aten bytes plus the kernels' own; ``fusions`` is
None (there is no compiled program: ``launches`` is the op-count proxy,
gauged as ``compile_launches``); ``kernels`` gives each hand kernel's
launches and work; ``collectives`` the payload the mesh's collectives
moved; ``capture_s`` the observed call's wall with the capture's own
work in it (the profiler's records read; the deferred counts aside).
Observations nest (``learn_burst`` inside a replica run's
``chunk_step``): every count goes to every open observation.  The
observed call is left out of ``dispatches`` and ``wall_s_total``
(``exclude``): its wall carries the capture.

Timings arrive as in the JAX package, after the run, from the trainer's
phase totals and the serve latency histograms (``note_timing``), and
derive MFU, bandwidth use and the roofline position against the card's
peaks (``PEAK_ENVELOPES``): the H100 SXM data sheet's, at the rate of the
run's precision policy (``precision``).  Another card gets ``peaks:
null`` and no MFU; the CPU row is a placeholder, marked as one.  A
capture failure is recorded (``{"available": False, "error": ...}``) and
logged, never raised: the dispatch itself runs as always.
"""
from __future__ import annotations

import logging
import subprocess
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import torch

from ..analysis.launches import (CostCounter, Frame, SyncWatch,
                                 profile_counts)
from ..ops.cost import BF16_FLOP_PER_S, F32_FLOP_PER_S, HBM_BYTES_PER_S

log = logging.getLogger("gsc_tpu_torch.obs.perf")

# bump on any breaking change to the perf.json layout; readers
# (tools/obs_report.py, tools/bench_diff.py) key on it
PERF_SCHEMA_VERSION = 1

# peak envelopes for MFU and the roofline.  h100_sxm: the NVIDIA H100 SXM
# data sheet (f32 outside the tensor cores, since the port keeps TF32 off;
# dense bf16 on the tensor cores; HBM3), picked by the run's precision
# policy.  cpu: an order-of-magnitude placeholder for run-over-run
# comparison only, never a utilization claim.
PEAK_ENVELOPES = {
    "h100_sxm": {"f32_flops_per_s": F32_FLOP_PER_S,
                 "bf16_flops_per_s": BF16_FLOP_PER_S,
                 "bytes_per_s": HBM_BYTES_PER_S},
    "cpu": {"flops_per_s": 5e10, "bytes_per_s": 2e10, "placeholder": True},
}


def card_row(name: Optional[str]) -> Optional[str]:
    """The ``PEAK_ENVELOPES`` row of a card's name, or None."""
    if name and "H100" in name and not any(s in name for s in ("PCIe",
                                                               "NVL")):
        return "h100_sxm"
    return None


def card_info(index: int = 0) -> Dict[str, Optional[str]]:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    power limit None where it cannot be read)."""
    info = {"name": torch.cuda.get_device_name(index), "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        name, _, limit = out[index].rpartition(", ")
        info.update(name=name or info["name"], power_limit=limit)
    except (OSError, IndexError, subprocess.SubprocessError):
        pass
    return info


# ----------------------------------------------------------------- capture
_LOCAL = threading.local()


class _Capture:
    """One thread's open observations: the counting mode, the profiler in
    segments (one per span between observations opening and closing, so
    that nested ones get their own launches), and the sync watch."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.frames: List[Frame] = []
        self.counter = CostCounter(self.frames, item_syncs=not self.cuda,
                                   on_full=self._settle)
        self.closed = []    # (frame, on_done), evaluated at the end
        # a deferred count that failed mid-call, recorded at the end
        self.error: Optional[BaseException] = None
        self.prof = None
        self.no_profile = None
        self.watch = None
        self.pushed = False

    def _sync(self):
        if self.cuda:
            SyncWatch.paused_sync(self.device)

    def _start_segment(self):
        if self.no_profile is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        try:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            self.prof = prof
        except Exception as e:  # noqa: BLE001 - a machine that refuses it
            self._drop_profile(f"the profiler did not start: "
                               f"{type(e).__name__}: {e}")

    def _end_segment(self):
        prof, self.prof = self.prof, None
        if prof is None:
            return
        self._sync()
        try:
            prof.__exit__(None, None, None)
            counts = profile_counts(prof)
        except Exception as e:  # noqa: BLE001
            self._drop_profile(f"the profiler failed: {type(e).__name__}: "
                               f"{e}")
            return
        for f in self.frames:
            if f.launches is not None:
                f.add_profile(counts)

    def _drop_profile(self, reason: str):
        self.no_profile = reason
        for f in self.frames:
            f.launches = f.device_s = None
            f.no_profile = reason

    def open(self) -> Frame:
        outer = not self.frames
        if outer:
            if not self.cuda:
                self.no_profile = ("no card: the plain versions run on the "
                                   "CPU and launch nothing")
            elif torch._C._autograd._profiler_enabled():
                self.no_profile = "a profiler was already running"
        else:
            self._end_segment()
        frame = Frame()
        if self.no_profile is not None:
            frame.launches = frame.device_s = None
            frame.no_profile = self.no_profile
        self.frames.append(frame)
        if outer:
            self.counter.__enter__()
            self.pushed = True
            if self.cuda:
                self.watch = SyncWatch(self.counter.threads,
                                       self._on_sync).start()
        self._start_segment()
        return frame

    def _settle(self):
        """The held inputs of the deferred counts passed HOLD_BYTES: run
        the counts (``Frame.settle``) between two profile segments, out
        of every count, and let go of the inputs.  A failure is kept for
        the end, never raised into the dispatch."""
        self._end_segment()
        self.counter.suppress += 1
        try:
            memo = {}
            for f in self.frames + [f for f, _ in self.closed]:
                f.settle(memo)
        except Exception as e:  # noqa: BLE001 - recorded at the end
            self.error = self.error or e
            for f in self.frames + [f for f, _ in self.closed]:
                f.posts.clear()
        finally:
            self.counter.suppress -= 1
            self.counter.release()
        self._start_segment()

    def _on_sync(self, message: str):
        for f in self.frames:
            f.host_syncs += 1

    def close(self, frame: Frame, on_done) -> None:
        """Close ``frame`` (the innermost); ``on_done(frame, kernel work,
        per kernel, error)`` runs once the outermost observation closed,
        outside every mode, where the deferred counts are read."""
        self._end_segment()
        frame.closed_at = time.perf_counter()
        self.frames.remove(frame)
        self.closed.append((frame, on_done))
        if self.frames:
            self._start_segment()
            return
        try:
            if self.watch is not None:
                self.watch.stop()
        finally:
            self.pushed = False
            self.counter.__exit__(None, None, None)
            _LOCAL.capture = None
        memo = {}
        for f, done in self.closed:
            if self.error is not None:
                done(f, None, None, self.error)
                continue
            try:
                work, per = f.evaluate(memo)
            except Exception as e:  # noqa: BLE001 - recorded, not raised
                done(f, None, None, e)
                continue
            done(f, work, per, None)

    def abandon(self) -> None:
        """Undo the whole capture after a failure of its own."""
        prof, self.prof = self.prof, None
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
            except Exception:  # noqa: BLE001
                pass
        if self.watch is not None:
            self.watch.stop()
        if self.pushed:
            self.pushed = False
            self.counter.__exit__(None, None, None)
        self.frames.clear()
        _LOCAL.capture = None


def _capture_for(device: torch.device) -> _Capture:
    cap = getattr(_LOCAL, "capture", None)
    if cap is None:
        cap = _LOCAL.capture = _Capture(device)
    return cap


# ------------------------------------------------------------------ ledger
class CostLedger:
    """Per-run cost ledger + wall-timing merge.

    ``hub`` (a :class:`~gsc_tpu_torch.obs.MetricsHub`) is optional; with
    one, every capture emits a ``compile_cost`` event.  ``precision``
    ("f32" or "bf16", the run's policy) picks the card's peak rate; the
    backend is the observed calls' device's."""

    def __init__(self, hub=None, precision: str = "f32"):
        self.hub = hub
        self.precision = precision
        self._device: Optional[torch.device] = None
        self._card = None
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict] = {}
        self._learned: Dict[str, bool] = {}
        self._timings: Dict[str, Dict[str, float]] = {}
        self._excluded: Dict[str, List[float]] = {}
        self._phases: Dict[str, Dict[str, float]] = {}
        # observations opened per entry: the trainer compares them across
        # a dispatch to leave an observed one out of the timings
        self._opened: Dict[str, int] = {}

    # ------------------------------------------------------------- backend
    def backend(self) -> str:
        """"gpu" when the observed calls ran on the card, else "cpu"."""
        if self._device is not None:
            return "gpu" if self._device.type == "cuda" else "cpu"
        return "gpu" if torch.cuda.is_available() else "cpu"

    def card(self) -> Optional[Dict[str, Optional[str]]]:
        """The card's name and power limit (None on the CPU)."""
        if self.backend() != "gpu":
            return None
        if self._card is None:
            index = (self._device.index if self._device is not None
                     and self._device.index is not None
                     else torch.cuda.current_device())
            self._card = card_info(index)
        return self._card

    def peaks(self) -> Optional[Dict[str, float]]:
        if self.backend() != "gpu":
            return dict(PEAK_ENVELOPES["cpu"])
        row = card_row(self.card()["name"])
        if row is None:
            return None
        env = PEAK_ENVELOPES[row]
        return {"flops_per_s": env["bf16_flops_per_s"
                                   if self.precision == "bf16"
                                   else "f32_flops_per_s"],
                "bytes_per_s": env["bytes_per_s"], "row": row}

    # ------------------------------------------------------------- capture
    def has(self, name: str) -> bool:
        return name in self._entries

    def observations(self, name: str) -> int:
        """Observations of ``name`` opened so far."""
        return self._opened.get(name, 0)

    def wants(self, name: str, learn: bool = True) -> bool:
        """Whether a dispatch of ``name`` (learning or not) is to be
        observed: the first, and the first that learns after one that
        did not."""
        with self._lock:
            return name not in self._entries or (
                learn and self._learned.get(name) is False)

    @contextmanager
    def observe(self, name: str, device=None, learn: bool = True,
                also: Sequence[str] = ()):
        """Observe the dispatch of ``name`` the ``with`` body runs, when
        ``wants(name, learn)``; the entry is recorded under ``name`` and
        every name in ``also``.  Yields whether it observes.  An exception
        of the body propagates and records nothing; a failure of the
        capture itself is recorded and logged."""
        if not self.wants(name, learn):
            yield False
            return
        names = (name,) + tuple(also)
        dev = torch.device(device if device is not None else
                           ("cuda" if torch.cuda.is_available() else "cpu"))
        if self._device is None:
            self._device = dev
        t0 = time.perf_counter()
        cap = frame = None
        try:
            cap = _capture_for(dev)
            frame = cap.open()
        except Exception as e:  # noqa: BLE001 - observability must not kill
            if cap is not None:
                cap.abandon()
            cap = None
            self._fail(names, e)
        with self._lock:
            self._opened[name] = self._opened.get(name, 0) + 1
        ok = False

        def done(f, work, per, err):
            if not ok:
                return
            if err is not None:
                self._fail(names, err)
            else:
                self._record(names, f, work, per, f.closed_at - t0, learn)
        try:
            yield True
            ok = True
        finally:
            if cap is not None:
                try:
                    cap.close(frame, done)
                except Exception as e:  # noqa: BLE001
                    cap.abandon()
                    if ok:
                        self._fail(names, e)

    def capture(self, name: str, fn, *args, device=None, **kwargs):
        """``fn(*args, **kwargs)`` observed as ``name``; returns its
        result (the entry is ``entry(name)``)."""
        with self.observe(name, device=device):
            return fn(*args, **kwargs)

    def _fail(self, names, e: BaseException):
        log.warning("cost-ledger capture of %r failed: %s: %s", names[0],
                    type(e).__name__, e)
        with self._lock:
            for n in names:
                self._entries[n] = {"available": False,
                                    "error": f"{type(e).__name__}: {e}"}

    def _record(self, names, f: Frame, work, per, capture_s, learn: bool):
        if f.launches is not None:
            seen = {k: f.by_kind.get(k, 0) for k in per}
            posted = {k: rec["launches"] for k, rec in per.items()}
            if seen != posted:
                f.launches = f.device_s = None
                f.no_profile = (f"the profiler lost device records: the "
                                f"hand kernels posted {posted}, it "
                                f"recorded {seen}")
        flops = float(f.flops + work.flops)
        nbytes = float(f.bytes + work.bytes)
        col = {op: {"count": c, "bytes": b}
               for op, (c, b) in sorted(f.collectives.items())}
        entry: Dict = {
            "available": True,
            "flops": flops,
            "bytes_accessed": nbytes,
            "fusions": None,
            "ops": {"while": None, **f.ops},
            "collectives": {"ops": col,
                            "count": sum(r["count"] for r in col.values()),
                            "bytes": sum(r["bytes"] for r in col.values())},
            "kernels": per,
            "launches": (None if f.launches is None else
                         {"count": f.launches,
                          "by_kind": {k: v for k, v in f.by_kind.items()
                                      if v}}),
            "device_s": (None if f.device_s is None
                         else round(f.device_s, 9)),
            "host_syncs": f.host_syncs,
            "capture_s": round(capture_s, 3),
        }
        if f.no_profile is not None:
            entry["no_profile"] = f.no_profile
        if flops and nbytes:
            entry["arithmetic_intensity"] = round(flops / nbytes, 4)
        with self._lock:
            for n in names:
                self._entries[n] = entry
                self._learned[n] = bool(learn)
        if self.hub is not None:
            for n in names:
                self.hub.event(
                    "compile_cost", fn=n, flops=flops,
                    bytes_accessed=nbytes, fusions=None, ops=entry["ops"],
                    collectives=entry["collectives"],
                    launches=f.launches, device_s=entry["device_s"],
                    host_syncs=f.host_syncs)
                if f.launches is not None:
                    self.hub.gauge("compile_launches", f.launches, fn=n)

    # ------------------------------------------------------------- timings
    def exclude(self, name: str, seconds: float, count: int = 1):
        """Leave ``count`` dispatches of ``seconds`` (the observed ones)
        out of ``name``'s timings."""
        with self._lock:
            rec = self._excluded.setdefault(name, [0, 0.0])
            rec[0] += count
            rec[1] += seconds

    def note_timing(self, name: str, total_s: float, count: int):
        """Merge the host wall of ``name``'s dispatches (phase totals, the
        serve latency histograms), less the excluded ones, after the run;
        nothing when none is left."""
        n_ex, s_ex = self._excluded.get(name, (0, 0.0))
        count, total_s = int(count) - n_ex, float(total_s) - s_ex
        if count <= 0:
            return
        self._timings[name] = {"total_s": round(max(total_s, 0.0), 6),
                               "count": count}

    def note_phases(self, phases: Dict[str, Dict[str, float]]):
        """Attach the run's cumulative PhaseTimer summary."""
        self._phases = dict(phases or {})

    # ------------------------------------------------------------- summary
    def _derived(self, entry: Dict, timing: Optional[Dict]) -> Dict:
        """MFU + roofline position from the counts x measured wall."""
        out = dict(entry)
        if not timing:
            return out
        out["dispatches"] = timing["count"]
        out["wall_s_total"] = timing["total_s"]
        mean_s = timing["total_s"] / max(timing["count"], 1)
        out["wall_s_mean"] = round(mean_s, 6)
        if not (entry.get("available") and entry.get("flops")
                and mean_s > 0):
            return out
        achieved = entry["flops"] / mean_s
        out["achieved_flops_per_s"] = round(achieved, 1)
        peaks = self.peaks()
        if peaks is None:
            out["mfu"] = None
            return out
        out["mfu"] = round(achieved / peaks["flops_per_s"], 6)
        bytes_a = entry.get("bytes_accessed") or 0.0
        if bytes_a:
            bw = bytes_a / mean_s
            out["achieved_bytes_per_s"] = round(bw, 1)
            out["bw_util"] = round(bw / peaks["bytes_per_s"], 6)
            intensity = entry["flops"] / bytes_a
            ridge = peaks["flops_per_s"] / peaks["bytes_per_s"]
            attainable = min(peaks["flops_per_s"],
                             intensity * peaks["bytes_per_s"])
            out["roofline"] = {
                "intensity": round(intensity, 4),
                "ridge": round(ridge, 4),
                "regime": ("memory_bound" if intensity < ridge
                           else "compute_bound"),
                "roof_multiple": round(attainable / max(achieved, 1e-30),
                                       1),
            }
        return out

    def entry(self, name: str) -> Optional[Dict]:
        e = self._entries.get(name)
        if e is None:
            return None
        return self._derived(e, self._timings.get(name))

    def summary(self) -> Dict:
        """The full schema-versioned perf document."""
        with self._lock:
            entries = dict(self._entries)
        return {
            "schema_version": PERF_SCHEMA_VERSION,
            "ts": round(time.time(), 3),
            "backend": self.backend(),
            "card": self.card(),
            "precision": self.precision,
            "peaks": self.peaks(),
            "run": (self.hub.base_tags.get("run")
                    if self.hub is not None else None),
            "entries": {name: self._derived(e, self._timings.get(name))
                        for name, e in entries.items()},
            "phases": self._phases,
        }

    def write_json(self, path: str) -> str:
        """Atomic ``perf.json`` write (the JAX package's name for it)."""
        from .sinks import write_atomic_json
        return write_atomic_json(path, self.summary())
