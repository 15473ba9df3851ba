"""Fault tolerance of the port (from ``photon_tpu/resilience``): the
typed failures (``errors``), seeded fault injection at named boundaries
(``faults``) and crash-safe training checkpoints with resume
(``checkpoint``). Retry and the serving queue's degraded mode are not
ported yet (ROADMAP Queue A item 4)."""

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
    CorruptModelError,
    CorruptShardError,
    InjectedCrash,
    NonFiniteUpdateError,
    PoisonError,
    ResumeMismatchError,
    TrainingInterrupted,
    TransientError,
)
from photon_tpu_torch.resilience.faults import FaultPlan, FaultSpec

__all__ = [
    "CheckpointError",
    "CorruptModelError",
    "CorruptShardError",
    "FaultPlan",
    "FaultSpec",
    "InjectedCrash",
    "NonFiniteUpdateError",
    "PoisonError",
    "ResumeMismatchError",
    "TrainingCheckpoint",
    "TrainingCheckpointer",
    "TrainingInterrupted",
    "TransientError",
    "faults",
    "has_config_final",
    "load_config_best",
    "load_config_final",
    "load_training_checkpoint",
    "training_static_key",
]
