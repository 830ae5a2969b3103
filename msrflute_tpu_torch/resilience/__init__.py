"""Fault injection, checkpoint integrity and retry, graceful preemption."""

from .chaos import ChaosSchedule, make_chaos
from .integrity import (CheckpointCorruptionError, CheckpointEscalationError,
                        FailureEscalator, RetryPolicy, run_with_retry)
from .preemption import PreemptionHandler

__all__ = ["ChaosSchedule", "make_chaos", "CheckpointCorruptionError",
           "CheckpointEscalationError", "FailureEscalator", "RetryPolicy",
           "run_with_retry", "PreemptionHandler"]
