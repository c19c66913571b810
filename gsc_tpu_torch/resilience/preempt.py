"""Preemption guard: SIGTERM/SIGINT -> snapshot and exit cleanly.

The port of ``gsc_tpu.resilience.preempt``.  The first signal becomes a
flag the training loop polls at episode boundaries: the trainer drains
what is in flight, the CLI writes a checksummed checkpoint and exits 0,
and ``--resume auto`` continues the run with its episode counter.  A
second signal restores the original handlers, so a stuck teardown can
still be killed the ordinary way.  Handlers install in the main thread
only; anywhere else the guard is an inert flag.
"""
from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

log = logging.getLogger("gsc_tpu_torch.resilience.preempt")

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionGuard:
    """Context manager installing graceful-shutdown handlers.

    Must be entered from the main thread (CPython restricts
    ``signal.signal``); anywhere else it degrades to an inert flag that
    never triggers, logging why."""

    def __init__(self, signals=_DEFAULT_SIGNALS):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._previous = {}
        self.signum: Optional[int] = None

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    @property
    def signame(self) -> Optional[str]:
        if self.signum is None:
            return None
        try:
            return signal.Signals(self.signum).name
        except ValueError:
            return str(self.signum)

    def _handle(self, signum, frame):
        if self._event.is_set():
            # second signal: the operator means it — restore the original
            # disposition so the NEXT one terminates the process
            log.warning("second %s during graceful shutdown — restoring "
                        "default handlers", self.signame)
            self._restore()
            return
        self.signum = signum
        self._event.set()
        log.warning("received %s — will snapshot a checkpoint at the next "
                    "episode boundary and exit cleanly", self.signame)

    def __enter__(self) -> "PreemptionGuard":
        try:
            for sig in self.signals:
                self._previous[sig] = signal.signal(sig, self._handle)
        except ValueError as e:   # not the main thread
            log.warning("preemption guard inactive (%s) — signals keep "
                        "their default disposition", e)
            self._restore()
        return self

    def _restore(self):
        for sig, prev in list(self._previous.items()):
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
            self._previous.pop(sig, None)

    def __exit__(self, *exc):
        self._restore()
        return False
