"""Fault injection, checkpoint integrity and retry, graceful preemption."""

from .chaos import ChaosSchedule, InfraFaults, make_chaos
from .integrity import (CheckpointCorruptionError, CheckpointEscalationError,
                        DurableIOError, DurableIOLadder, FailureEscalator,
                        RetryPolicy, run_with_retry)
from .preemption import PreemptionHandler

__all__ = ["ChaosSchedule", "InfraFaults", "make_chaos",
           "CheckpointCorruptionError", "CheckpointEscalationError",
           "DurableIOError", "DurableIOLadder", "FailureEscalator",
           "RetryPolicy", "run_with_retry", "PreemptionHandler"]
