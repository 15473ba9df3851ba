"""Typed failures of the port (from ``photon_tpu/resilience/errors.py``).

The taxonomy the training and scoring paths raise and the fault
injector fires: a ``TransientError`` is expected to clear on retry, a
``PoisonError`` never does; corrupt artifacts, checkpoint mismatches
and an interrupted run are neither, and reach the caller with enough
context to act on. Stdlib only, so every layer can import it.
"""

from __future__ import annotations


class TransientError(RuntimeError):
    """A failure expected to clear on retry (preemption, flaky RPC)."""


class PoisonError(RuntimeError):
    """A deterministic failure: retrying the same input cannot help."""


class InjectedCrash(RuntimeError):
    """A fault-injection stand-in for a hard process death: raised where
    a real crash would kill the process, so a test can catch it and
    check what a crash would leave on disk."""


class CorruptModelError(RuntimeError):
    """A model or checkpoint artifact failed to decode.

    Raised by ``io.model_io`` loaders instead of the codec's own
    exception (``zipfile.BadZipFile``, an Avro decode error); the message
    names the file and what failed.
    """


class CorruptShardError(RuntimeError):
    """A data shard failed to decode.

    The data-path sibling of ``CorruptModelError``: raised by the Avro
    data readers when a part file's container does not decode; the
    message names the file.
    """


class CheckpointError(RuntimeError):
    """A training checkpoint could not be written or loaded."""


class ResumeMismatchError(CheckpointError):
    """``--resume`` against a checkpoint whose static key does not match
    this run's training configuration: resuming would continue a
    different optimization than the one that wrote it."""


class NonFiniteUpdateError(RuntimeError):
    """A coordinate's first update produced NaN or inf: there is no
    previous iterate to roll back to."""


class TrainingInterrupted(BaseException):
    """Raised by the training CLI's SIGINT/SIGTERM handler to unwind the
    fit. A ``BaseException``, as ``KeyboardInterrupt`` is, so no
    ``except Exception`` on the way up swallows a shutdown request."""

    def __init__(self, signum: int):
        super().__init__(f"training interrupted by signal {signum}")
        self.signum = signum
