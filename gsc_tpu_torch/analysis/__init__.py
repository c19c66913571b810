"""Runtime sentinels and launch counts for the port.

The port of ``gsc_tpu.analysis`` without its static linter (``astlint``,
``concur``, ``baseline``, ``findings``; ``tools/gsc_lint.py``), which
reads the JAX package's source:

- :mod:`~gsc_tpu_torch.analysis.launches`: what one observed call
  dispatches (aten FLOPs, bytes and the op histogram, the hand kernels'
  posted work, device launches by kind, host syncs), the counterpart of
  ``analysis.hlo`` for a program that is not compiled; the device-cost
  ledger (``obs.perf``) reads it;
- :mod:`~gsc_tpu_torch.analysis.sentinels`: :class:`CompileMonitor`
  (``compile`` events per kernel-library build and load),
  ``assert_no_retrace`` and ``no_host_sync``.
"""
from .launches import (HAND_KERNELS, LAUNCH_KINDS, OP_KEYS, CostCounter,
                       DeviceProfile, Frame, ProfileCounts, SyncWatch,
                       launch_kind, profile_counts)
from .sentinels import (DEFAULT_WATCH, CompileMonitor, HostSyncError,
                        RetraceError, assert_no_retrace, no_host_sync)

__all__ = [
    "HAND_KERNELS", "LAUNCH_KINDS", "OP_KEYS", "CostCounter",
    "DeviceProfile", "Frame", "ProfileCounts", "SyncWatch", "launch_kind",
    "profile_counts",
    "DEFAULT_WATCH", "CompileMonitor", "HostSyncError", "RetraceError",
    "assert_no_retrace", "no_host_sync",
]
