"""Pipeline watchdog: a heartbeat monitor over the episode pipeline.

The port of ``gsc_tpu.obs.watchdog.PipelineWatchdog``.  It polls the
hub's ``episode`` heartbeat (beaten after every drained episode) and,
when no episode completes within the wall budget, emits one structured
``stall`` event with the last pipeline phase entered or completed, the
dispatch-to-drain lag, every component's heartbeat age and the
registered probes (prefetch queue depth, producer liveness).  It re-arms
after the next completed episode.  ``escalate_after`` more quiet budget
periods escalate from reporting to acting (``on_escalate``: the trainer
interrupts and restarts the prefetcher).

Ages are read off ``clock`` (default: the hub's clock, which stamps the
beats), and :meth:`poll` runs one pass of the monitor, so a test drives
the watchdog through an injected clock and explicit polls, without wall
sleeps against a budget; :meth:`start` runs the same pass on a daemon
thread every ``poll_s``.

Fleet coverage (the decoupled trainer, ``train --async``): each actor
thread and the learner beat their own heartbeat, registered with
:meth:`PipelineWatchdog.watch_thread`; a thread quiet past its budget
gives one ``stall`` event naming it and the phase
``MetricsHub.note_thread_phase`` last recorded for it, and the
``thread_stalls{thread=}`` counter.  It re-arms on the thread's next
beat.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Optional

from .hub import MetricsHub

log = logging.getLogger("gsc_tpu_torch.obs.watchdog")


class PipelineWatchdog:
    """Emits ``stall`` events when the ``episode`` heartbeat goes quiet.

    ``start_paused=True`` (the trainer wiring) keeps the monitor disarmed
    until :meth:`resume` — evaluation, checkpointing and other between-loop
    work must not count against the episode wall budget.
    """

    def __init__(self, hub: MetricsHub, budget_s: float,
                 beat_name: str = "episode",
                 poll_s: Optional[float] = None,
                 start_paused: bool = False,
                 escalate_after: int = 0,
                 on_escalate: Optional[Callable[[float], None]] = None,
                 on_blackbox: Optional[Callable[[str, float],
                                               None]] = None,
                 clock: Optional[Callable[[], float]] = None):
        if budget_s <= 0:
            raise ValueError(f"watchdog budget must be > 0, got {budget_s}")
        self.hub = hub
        self.clock = clock if clock is not None else hub.clock
        self.budget_s = float(budget_s)
        self.beat_name = beat_name
        # escalation (resilience): after the first stall, ``escalate_after``
        # MORE full budget periods of continued silence move the watchdog
        # from reporting to acting — ``on_escalate(age_s)`` fires ONCE per
        # stall episode (re-armed with the stall flag by the next
        # heartbeat).  The trainer wires a prefetcher interrupt/restart
        # into it; 0 disables escalation (report only).
        self.escalate_after = max(int(escalate_after), 0)
        self.on_escalate = on_escalate
        # black-box hook: ``on_blackbox(beat_name, age_s)`` fires once per
        # escalation; the RunObserver wires its post-mortem dump here so a
        # wedged run leaves blackbox.json, not just a stall line
        self.on_blackbox = on_blackbox
        self._escalated = False
        # poll fast enough to flag a stall well inside one extra budget
        # interval, but never busier than 4 Hz
        self.poll_s = poll_s if poll_s is not None else max(
            min(self.budget_s / 4.0, 1.0), 0.25)
        self._probes: Dict[str, Callable[[], object]] = {}
        # per-thread heartbeats (fleet coverage): name -> budget and the
        # stall state of that thread
        self._watched_lock = threading.Lock()
        self._watched: Dict[str, Dict] = {}   # guarded-by: self._watched_lock
        self._stop = threading.Event()
        self._paused = threading.Event()
        if start_paused:
            self._paused.set()
        self._stalled = False
        self._stalled_at_beat: Optional[float] = None
        self.stall_count = 0
        self._thread = threading.Thread(target=self._run,
                                        name="gsc-pipeline-watchdog",
                                        daemon=True)

    # ------------------------------------------------------------ control
    def register_probe(self, name: str, fn: Callable[[], object]):
        """Attach a diagnostic callable whose value is included in stall
        events (e.g. prefetch queue depth)."""
        self._probes[name] = fn

    def watch_thread(self, name: str, budget_s: Optional[float] = None):
        """Watch one more per-thread heartbeat (an actor thread, the
        learner): the thread beats ``hub.beat(name)`` at its own cadence;
        quiet past ``budget_s`` (default: the main budget) it gives one
        ``stall`` event naming it and its last phase.  Armed from
        registration."""
        self.hub.beat(name)
        with self._watched_lock:
            self._watched[name] = {
                "budget_s": float(budget_s) if budget_s else self.budget_s,
                "stalled": False, "stalled_at_beat": None,
                "escalated": False}

    def unwatch_thread(self, name: str):
        with self._watched_lock:
            self._watched.pop(name, None)

    def unwatch_all_threads(self):
        with self._watched_lock:
            self._watched.clear()

    def watched_threads(self):
        """The names of the watched threads."""
        with self._watched_lock:
            return sorted(self._watched)

    def start(self):
        self.hub.beat(self.beat_name)   # arm: age measured from start
        self._thread.start()
        return self

    def resume(self):
        """Arm the monitor (trainer entering its episode loop).  Beats once
        so paused time never counts toward the budget."""
        self.hub.beat(self.beat_name)
        self._stalled = False
        self._escalated = False
        self._stalled_at_beat = None
        with self._watched_lock:
            for name, st in self._watched.items():
                # paused time never counts toward a thread's budget
                self.hub.beat(name)
                st.update(stalled=False, escalated=False,
                          stalled_at_beat=None)
        self._paused.clear()

    def pause(self):
        """Disarm (trainer left the episode loop)."""
        self._paused.set()

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    # --------------------------------------------------------------- loop
    def _age(self, name: str) -> Optional[float]:
        t = self.hub.beat_time(name)
        return None if t is None else self.clock() - t

    def _run(self):
        while not self._stop.wait(self.poll_s):
            self.poll()

    def poll(self):
        """One pass of the monitor: the stall, re-arm and escalation
        checks of the heartbeat, then of every watched thread's."""
        if self._paused.is_set():
            return
        self._poll_main()
        self._poll_watched()

    def _poll_main(self):
        age = self._age(self.beat_name)
        if age is None:
            return
        # re-arm on any heartbeat newer than the one the last stall was
        # declared against (timestamps, not the current age, so a short
        # recovery between two polls re-arms too)
        if self._stalled and \
                self.hub.beat_time(self.beat_name) != self._stalled_at_beat:
            self._stalled = False
            self._escalated = False
        if age > self.budget_s and not self._stalled:
            self._stalled = True
            self._stalled_at_beat = self.hub.beat_time(self.beat_name)
            self.stall_count += 1
            self._emit_stall(age)
        if (self._stalled and not self._escalated
                and self.escalate_after > 0
                and age > self.budget_s * (1 + self.escalate_after)):
            self._escalated = True
            self._escalate(age)

    def _poll_watched(self):
        """One pass over the per-thread heartbeats: a quiet thread's
        stall event, its re-arm, and past the escalation horizon
        (``budget * (1 + max(escalate_after, 1))``) one black-box dump per
        stall of that thread."""
        with self._watched_lock:
            watched = list(self._watched.items())
        for name, st in watched:
            age = self._age(name)
            if age is None:
                continue
            beat = self.hub.beat_time(name)
            if st["stalled"] and beat != st["stalled_at_beat"]:
                st.update(stalled=False, escalated=False)
            if age > st["budget_s"] and not st["stalled"]:
                st.update(stalled=True, stalled_at_beat=beat)
                self.stall_count += 1
                self._emit_thread_stall(name, age, st["budget_s"])
            if (st["stalled"] and not st["escalated"]
                    and age > st["budget_s"] * (1 + max(
                        self.escalate_after, 1))):
                st["escalated"] = True
                self._blackbox(name, age)

    def _emit_thread_stall(self, name: str, age: float, budget_s: float):
        fields: Dict[str, object] = {
            "thread": name,
            "age_s": round(age, 3),
            "budget_s": budget_s,
            "last_phase": self.hub.thread_phase(name),
            "heartbeats": self.hub.beat_ages(),
            "thread_phases": self.hub.thread_phases(),
        }
        for pname, fn in self._probes.items():
            try:
                fields[pname] = fn()
            except Exception as e:   # a dead probe is itself a diagnostic
                fields[pname] = f"probe-error: {e!r}"
        log.warning("stall: thread %s quiet for %.2f s (budget %.2f s), "
                    "last phase %s", name, age, budget_s,
                    fields["last_phase"])
        self.hub.counter("stalls")
        self.hub.counter("thread_stalls", thread=name)
        self.hub.event("stall", **fields)

    def _blackbox(self, thread: str, age: float):
        cb = self.on_blackbox
        self.hub.counter("blackbox_dumps")
        if cb is not None:
            try:
                cb(thread, age)
            except Exception as e:   # the dump failing must not kill the
                # monitor — the stall evidence is already in the stream
                self.hub.event("blackbox_error", thread=thread,
                               error=repr(e))

    def _escalate(self, age: float):
        """The stall outlived ``escalate_after`` extra budget periods: act.
        The callback runs on this (watchdog) thread and must only poke
        thread-safe handles — the trainer's hook interrupts the prefetcher
        queue, and the training loop does the actual restart."""
        cb = self.on_escalate
        self.hub.counter("watchdog_escalations")
        self.hub.event(
            "escalation", age_s=round(age, 3), budget_s=self.budget_s,
            quiet_periods=self.escalate_after + 1,
            action="callback" if cb is not None else "none")
        if cb is not None:
            try:
                cb(age)
            except Exception as e:   # an escalation that faults must not
                # kill the monitor thread — the stall evidence survives
                self.hub.event("escalation_error", error=repr(e))
        # the pipeline quiet past its escalation horizon: a post-mortem
        self._blackbox(self.beat_name, age)

    def _emit_stall(self, age: float):
        phase, done = self.hub.last_phase
        fields: Dict[str, object] = {
            "age_s": round(age, 3),
            "budget_s": self.budget_s,
            "last_phase": phase,
            "last_phase_state": "completed" if done else "running",
            "episodes_dispatched": self.hub.get_counter(
                "episodes_dispatched"),
            "episodes_drained": self.hub.get_counter("episodes_drained"),
            "heartbeats": self.hub.beat_ages(),
        }
        fields["dispatch_drain_lag"] = (
            fields["episodes_dispatched"] - fields["episodes_drained"])
        if fields["episodes_drained"] == 0:
            # a genuinely overdue FIRST episode still deserves the event
            # (that hang is invisible otherwise), but the first launches
            # build the kernels, which can dominate this interval
            fields["note"] = ("no episode has completed yet — the first "
                              "launches' kernel builds can dominate this "
                              "interval")
        for name, fn in self._probes.items():
            try:
                fields[name] = fn()
            except Exception as e:   # a dead probe is itself a diagnostic
                fields[name] = f"probe-error: {e!r}"
        self.hub.counter("stalls")
        self.hub.event("stall", **fields)
