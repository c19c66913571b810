"""Resilience: rotating checksummed checkpoints and ``--resume auto``,
fault plans, the rollback guard, preemption and dispatch retry."""
from .ckpt import CheckpointManager, find_resumable
from .faults import FaultInjected, FaultPlan, FaultSpec
from .guard import RollbackGuard, all_finite, poison_tree, tree_copy
from .preempt import PreemptionGuard
from .retry import RetryPolicy, TransientDispatchError, call_with_retry

__all__ = ["CheckpointManager", "find_resumable", "FaultInjected",
           "FaultPlan", "FaultSpec", "RollbackGuard", "all_finite",
           "poison_tree", "tree_copy", "PreemptionGuard", "RetryPolicy",
           "TransientDispatchError", "call_with_retry"]
