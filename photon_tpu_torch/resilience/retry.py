"""Retry with exponential backoff and deterministic jitter (port of
``photon_tpu/resilience/retry.py``).

The dispatch sites call ``call_with_retry`` (or ``retrying_check``,
which puts a fault-injection point inside the retried call) around
their one fallible step. The policy is narrow:

- Only transient failures are retried: ``TransientError`` (and whatever
  a caller adds to ``retry_on``), plus what the policy's ``classify``
  hook recognizes, by default ``errors.is_transient`` (which classifies
  CUDA failures by their error code). A ``PoisonError``, a sticky CUDA
  error, a shape mismatch, anything deterministic, propagates on the
  first attempt.
- Attempts are capped (``max_attempts``), backoff is exponential with a
  cap, and the jitter comes from an RNG seeded by the call site's name:
  the same run replays the same sleep schedule, distinct sites
  decorrelate.
- The happy path takes no lock and allocates nothing; a clean run
  records zero retry stats.

The counters (``retry_stats``) are always on and process-wide. With
telemetry on, each site also counts ``retry_attempts_total`` and
``retry_exhausted_total`` in the metrics registry (labelled by site)
and marks ``retry.attempt`` / ``retry.exhausted`` instants on the
timeline.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import zlib

import numpy as np

from photon_tpu_torch.resilience import faults
from photon_tpu_torch.resilience.errors import TransientError, is_transient

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with bounded jitter."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5  # delay *= 1 + U(-jitter, +jitter)
    retry_on: tuple = (TransientError,)
    # Predicate for failures whose type cannot identify them (a CUDA
    # error arrives as a plain RuntimeError): a failure retries when it
    # is an instance of ``retry_on`` or ``classify(exc)`` is True. None
    # retries ``retry_on`` types only.
    classify: object = is_transient

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not (0.0 <= self.jitter < 1.0):
            raise ValueError("jitter must be in [0, 1)")

    def delay_for(self, attempt: int, rng) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        base = min(
            self.base_delay_s * self.multiplier ** (attempt - 1),
            self.max_delay_s,
        )
        if self.jitter:
            base *= 1.0 + self.jitter * float(rng.uniform(-1.0, 1.0))
        return max(base, 0.0)


DEFAULT_POLICY = RetryPolicy()

# ``_lock`` guards ``_stats``, written from whichever thread retries
# (the serve worker, a training thread); the happy path never takes it.
_lock = threading.Lock()
_stats = {
    "retries": 0,  # re-invocations performed
    "recovered": 0,  # calls that succeeded after >= 1 retry
    "exhausted": 0,  # calls that failed after the last attempt
    "backoff_seconds": 0.0,
}


def retry_stats() -> dict:
    """Snapshot of the process-wide counters (all zero on a clean run)."""
    with _lock:
        return dict(_stats)


def reset_retry_stats() -> None:
    with _lock:
        for k in _stats:
            _stats[k] = type(_stats[k])()


def _record(key: str, value=1) -> None:
    with _lock:
        _stats[key] += value


def _metric(name: str, site: str, value: float = 1.0) -> None:
    try:
        from photon_tpu_torch import obs

        if obs.enabled():
            obs.REGISTRY.counter(name, site=site).inc(value)
    except Exception:  # noqa: BLE001 - telemetry never aborts a retry
        pass


def _instant(name: str, **args) -> None:
    """Mark a retry event on the timeline (a no-op with telemetry
    off)."""
    try:
        from photon_tpu_torch.obs import trace as obs_trace

        obs_trace.instant(name, cat="retry", **args)
    except Exception:  # noqa: BLE001
        pass


def call_with_retry(
    fn,
    *,
    site: str,
    policy: RetryPolicy = DEFAULT_POLICY,
    seed: int | None = None,
    on_retry=None,
):
    """Call ``fn()``; retry transient failures per ``policy``.

    ``site`` names the call site for the logs and seeds the jitter
    stream (``seed`` overrides it). Non-retryable exceptions propagate
    untouched on the first attempt. ``on_retry(attempt, exc)`` runs
    before each backoff sleep, so a caller keeps its own counter (the
    serve queue's ``dispatch_retries``).
    """
    # The jitter RNG is built at the first failure, keyed by site or
    # seed alone, so the happy path allocates nothing.
    rng = None
    retried = False
    for attempt in range(1, policy.max_attempts + 1):
        try:
            result = fn()
        except BaseException as exc:
            retryable = isinstance(exc, policy.retry_on) or (
                policy.classify is not None
                and isinstance(exc, Exception)
                and policy.classify(exc)
            )
            if not retryable:
                raise
            _record("retries" if attempt < policy.max_attempts
                    else "exhausted")
            _metric("retry_attempts_total", site)
            _instant("retry.attempt", site=site, attempt=attempt,
                     error=type(exc).__name__)
            if attempt >= policy.max_attempts:
                _metric("retry_exhausted_total", site)
                _instant("retry.exhausted", site=site, attempt=attempt)
                logger.warning(
                    "%s: transient failure persisted through %d "
                    "attempt(s): %r", site, attempt, exc)
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            if rng is None:
                rng = np.random.default_rng(
                    zlib.crc32(site.encode("utf-8"))
                    if seed is None else seed
                )
            delay = policy.delay_for(attempt, rng)
            _record("backoff_seconds", delay)
            logger.info(
                "%s: transient failure (attempt %d/%d), retrying in "
                "%.3fs: %r", site, attempt, policy.max_attempts, delay,
                exc)
            time.sleep(delay)
            retried = True
            continue
        if retried:
            _record("recovered")
        return result


def retrying_check(point: str, fn, *, site: str | None = None,
                   policy: RetryPolicy = DEFAULT_POLICY, on_retry=None):
    """``call_with_retry`` with the fault-injection hook for ``point``
    inside the retried call, so an injected transient fault is recovered
    by the same loop a real one would be."""

    def once():
        faults.check(point)
        return fn()

    return call_with_retry(
        once, site=site or point, policy=policy, on_retry=on_retry
    )
