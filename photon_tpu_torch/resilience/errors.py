"""Typed failures of the port (from ``photon_tpu/resilience/errors.py``).

The taxonomy the training and scoring paths raise and the fault
injector fires: a ``TransientError`` is expected to clear on retry, a
``PoisonError`` never does; corrupt artifacts, checkpoint mismatches,
an interrupted run and the serving queue's deadline, overload, breaker
and shutdown failures are neither, and reach the caller with enough
context to act on. ``is_transient`` is what the retry layer asks; it
classifies CUDA failures by their error code. Stdlib only, so every
layer can import it.
"""

from __future__ import annotations

import errno as _errno
import re


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


class DeadlineExceededError(RuntimeError):
    """A serve request's deadline expired while it was still queued; it
    failed before any device work was spent on it."""


class OverloadedError(RuntimeError):
    """The serve queue is at its shed watermark: the request was
    rejected at once instead of blocking behind a backlog."""


class CircuitOpenError(RuntimeError):
    """The serve dispatch circuit breaker is open (too many consecutive
    batch failures): requests fail fast until ``reset_breaker``."""


class ShutdownError(RuntimeError):
    """The serve queue was closed (or its bounded drain timed out) with
    this request still queued; it will never be dispatched."""


# CUDA runtime errors (``cudaError_t`` codes and their
# ``cudaGetErrorString`` texts) that the port classifies. A sticky error
# corrupts the CUDA context: every later call in the process fails the
# same way, so a retry in place can only fail again.
STICKY_CUDA_ERRORS: dict[int, str] = {
    214: "uncorrectable ECC error encountered",
    700: "an illegal memory access was encountered",
    702: "the launch timed out and was terminated",
    710: "device-side assert triggered",
    714: "hardware stack error",
    715: "an illegal instruction was encountered",
    716: "misaligned address",
    717: "operation not supported on global/shared address space",
    718: "invalid program counter",
    719: "unspecified launch failure",
}

# The one CUDA error the port retries: another process holds the card
# (exclusive compute mode), which clears when that process lets go.
TRANSIENT_CUDA_ERRORS: dict[int, str] = {
    46: "CUDA-capable device(s) is/are busy or unavailable",
}

# The kernel wrappers raise ``<kernel> launch failed with CUDA error
# <rc>`` with the code that cudaGetLastError returned after the launch.
_LAUNCH_RC = re.compile(r"launch failed with CUDA error (\d+)")

# Host I/O errnos expected to clear on retry (a network filesystem or a
# flaky disk). ENOENT, EACCES or ENOSPC are deterministic for the call.
TRANSIENT_ERRNOS: tuple[int, ...] = (
    _errno.EIO,
    _errno.EAGAIN,
    _errno.EINTR,
    _errno.ETIMEDOUT,
    _errno.ECONNRESET,
    _errno.ENETRESET,
    _errno.ESTALE,
)


def cuda_error_code(exc: BaseException) -> int | None:
    """The ``cudaError_t`` code a failure carries, when it is one the
    port classifies: from a kernel wrapper's ``launch failed with CUDA
    error <rc>``, or from torch's ``CUDA error: <text>`` message."""
    msg = str(exc)
    m = _LAUNCH_RC.search(msg)
    if m:
        return int(m.group(1))
    for table in (STICKY_CUDA_ERRORS, TRANSIENT_CUDA_ERRORS):
        for code, text in table.items():
            if text in msg:
                return code
    return None


def is_transient(exc: BaseException) -> bool:
    """Whether a failure is expected to clear on retry.

    ``TransientError`` (and so every injected transient fault) is
    transient. The port's typed failures (poison, corrupt artifacts,
    checkpoints, the serving errors, an injected crash) never are,
    whatever their message says. A CUDA failure is classified by its
    code: only ``cudaErrorDevicesUnavailable`` (46) is retried; a sticky
    error (``STICKY_CUDA_ERRORS``: an illegal address, a launch failure,
    or a wrapper's ``launch failed with CUDA error <rc>`` for such a
    code) and every other code fail on the first attempt. The JAX
    package's gRPC/absl status markers name nothing on CUDA and are not
    read. Host I/O: a ``ConnectionError`` or an ``OSError`` with a
    ``TRANSIENT_ERRNOS`` errno is transient.
    """
    if isinstance(exc, TransientError):
        return True
    if isinstance(
        exc,
        (
            PoisonError,
            InjectedCrash,
            CorruptModelError,
            CorruptShardError,
            CheckpointError,
            NonFiniteUpdateError,
            DeadlineExceededError,
            OverloadedError,
            CircuitOpenError,
            ShutdownError,
        ),
    ):
        return False
    if isinstance(exc, RuntimeError):
        code = cuda_error_code(exc)
        return code is not None and code in TRANSIENT_CUDA_ERRORS
    if isinstance(exc, ConnectionError):
        return True
    return isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS
