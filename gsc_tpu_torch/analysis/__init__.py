"""Static analysis, runtime sentinels and launch counts for the port.

The port of ``gsc_tpu.analysis`` (without ``hlo``, which counts XLA
fusions: the port compiles no HLO; ``launches`` is its counterpart):

- :mod:`~gsc_tpu_torch.analysis.astlint`: the linter's driver and rules
  R1-R4 read for PyTorch: host syncs (R1) and global RNG or clock reads
  (R3) reachable from a step entry point (``STEP_ROOTS``, the static twin
  of ``no_host_sync``), products whose accumulation dtype the precision
  policy does not make explicit in ``ops/`` and ``models/`` (R4).  R2
  (donation) and R5 (weak-typed retrace) are dropped
  (``DROPPED_RULES``: eager PyTorch has neither);
- :mod:`~gsc_tpu_torch.analysis.concur`: R6-R10, the JAX package's
  concurrency rules finding for finding (lock-order cycles,
  ``# guarded-by:`` fields, dispatch outside ``dispatch_lock``, blocking
  under a lock, unnamed or non-daemon threads);
- :mod:`~gsc_tpu_torch.analysis.baseline` and
  :mod:`~gsc_tpu_torch.analysis.findings`: the suppression baseline
  (``lint_baseline.json``, a written reason per entry; inline
  ``gsc-lint: disable=R<k> -- <reason>`` markers) and the findings with
  the JAX package's fingerprints;
- :mod:`~gsc_tpu_torch.analysis.lint`: the runner, ``python -m
  gsc_tpu_torch.analysis.lint [paths]`` (``tools/gsc_lint.py``'s flags
  and exit codes; default paths ``gsc_tpu_torch/`` and
  ``chip_smoke.py``);
- :mod:`~gsc_tpu_torch.analysis.launches`: what one observed call
  dispatches (aten FLOPs, bytes and the op histogram, the hand kernels'
  posted work, device launches by kind, host syncs), the counterpart of
  ``analysis.hlo`` for a program that is not compiled; the device-cost
  ledger (``obs.perf``) reads it;
- :mod:`~gsc_tpu_torch.analysis.sentinels`: :class:`CompileMonitor`
  (``compile`` events per kernel-library build and load),
  ``assert_no_retrace`` and ``no_host_sync``.

The linter's modules are stdlib only: a lint run touches no device.
"""
from .astlint import STEP_ROOTS, lint_files, lint_paths
from .baseline import (apply_baseline, inline_suppression, load_baseline,
                       save_baseline)
from .concur import DISPATCH_NAMES, check_concurrency
from .findings import (DROPPED_RULES, RULE_IDS, RULE_TITLES, Finding,
                       LintResult)
from .launches import (HAND_KERNELS, LAUNCH_KINDS, OP_KEYS, CostCounter,
                       DeviceProfile, Frame, ProfileCounts, SyncWatch,
                       launch_kind, profile_counts)
from .sentinels import (DEFAULT_WATCH, CompileMonitor, HostSyncError,
                        RetraceError, assert_no_retrace, no_host_sync)

__all__ = [
    "STEP_ROOTS", "lint_files", "lint_paths",
    "apply_baseline", "inline_suppression", "load_baseline",
    "save_baseline",
    "DISPATCH_NAMES", "check_concurrency",
    "DROPPED_RULES", "RULE_IDS", "RULE_TITLES", "Finding", "LintResult",
    "HAND_KERNELS", "LAUNCH_KINDS", "OP_KEYS", "CostCounter",
    "DeviceProfile", "Frame", "ProfileCounts", "SyncWatch", "launch_kind",
    "profile_counts",
    "DEFAULT_WATCH", "CompileMonitor", "HostSyncError", "RetraceError",
    "assert_no_retrace", "no_host_sync",
]
