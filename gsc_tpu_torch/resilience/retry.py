"""Bounded exponential-backoff retry of transient dispatch failures.

The port of ``gsc_tpu.resilience.retry`` with one deliberate
difference: only :class:`TransientDispatchError` is retried.  The JAX
package also retries the runtime's own ``XlaRuntimeError``; the port
retries no ``RuntimeError`` of CUDA or torch, because a CUDA error is
sticky on its context (every later call fails too) and retrying one
would hide a kernel fault.  Programming errors and injected hard faults
propagate at once.  The trainer's dispatch raises the transient error at
entry, before any tensor is touched, so a retry dispatches the same
inputs again.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional, Tuple

log = logging.getLogger("gsc_tpu_torch.resilience.retry")


class TransientDispatchError(RuntimeError):
    """A transient dispatch failure (``FaultPlan`` site
    ``dispatch_transient``): the only error the retry layer retries."""


def transient_error_types() -> Tuple[type, ...]:
    """The error types worth retrying."""
    return (TransientDispatchError,)


@dataclasses.dataclass
class RetryPolicy:
    """``attempts`` tries in all; sleep ``min(cap_s, base_s * 2**(k-1))``
    before retry k (k >= 1)."""

    attempts: int = 3
    base_s: float = 0.05
    cap_s: float = 2.0

    def backoff_s(self, attempt: int) -> float:
        return min(self.cap_s, self.base_s * (2.0 ** max(attempt - 1, 0)))


def call_with_retry(fn: Callable, policy: Optional[RetryPolicy] = None,
                    on_retry: Optional[Callable[[int, BaseException, float],
                                                None]] = None,
                    sleep: Callable[[float], None] = time.sleep):
    """``fn()`` with bounded exponential backoff on transient errors.
    ``on_retry(attempt, exc, backoff_s)`` runs before each retry (attempt
    1 is the first retry); ``sleep`` waits out the backoff.  The last
    failure propagates unchanged."""
    policy = policy or RetryPolicy()
    transient = transient_error_types()
    for attempt in range(1, max(policy.attempts, 1) + 1):
        try:
            return fn()
        except transient as e:
            if attempt >= policy.attempts:
                log.error("transient dispatch failure persisted through "
                          "%d attempts: %r", attempt, e)
                raise
            delay = policy.backoff_s(attempt)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            log.warning("transient dispatch failure (attempt %d/%d): %r — "
                        "backing off %.2fs", attempt, policy.attempts, e,
                        delay)
            sleep(delay)
