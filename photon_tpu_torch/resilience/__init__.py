"""Fault tolerance of the port (from ``photon_tpu/resilience``): the
typed failures (``errors``), seeded fault injection at named boundaries
(``faults``), retry with backoff (``retry``; the serving queue's
dispatch retry) and crash-safe training checkpoints with resume
(``checkpoint``)."""

from __future__ import annotations

from photon_tpu_torch.resilience import faults
from photon_tpu_torch.resilience.checkpoint import (
    TrainingCheckpoint,
    TrainingCheckpointer,
    has_config_final,
    load_config_best,
    load_config_final,
    load_training_checkpoint,
    training_static_key,
)
from photon_tpu_torch.resilience.errors import (
    CheckpointError,
    CircuitOpenError,
    CorruptModelError,
    CorruptShardError,
    DeadlineExceededError,
    InjectedCrash,
    NonFiniteUpdateError,
    OverloadedError,
    PoisonError,
    ResumeMismatchError,
    ShutdownError,
    TrainingInterrupted,
    TransientError,
    is_transient,
)
from photon_tpu_torch.resilience.faults import FaultPlan, FaultSpec
from photon_tpu_torch.resilience.retry import (
    RetryPolicy,
    call_with_retry,
    reset_retry_stats,
    retry_stats,
    retrying_check,
)

__all__ = [
    "CheckpointError",
    "CircuitOpenError",
    "CorruptModelError",
    "CorruptShardError",
    "DeadlineExceededError",
    "FaultPlan",
    "FaultSpec",
    "InjectedCrash",
    "NonFiniteUpdateError",
    "OverloadedError",
    "PoisonError",
    "ResumeMismatchError",
    "RetryPolicy",
    "ShutdownError",
    "TrainingCheckpoint",
    "TrainingCheckpointer",
    "TrainingInterrupted",
    "TransientError",
    "call_with_retry",
    "faults",
    "is_transient",
    "reset_retry_stats",
    "retry_stats",
    "retrying_check",
    "has_config_final",
    "load_config_best",
    "load_config_final",
    "load_training_checkpoint",
    "training_static_key",
]
