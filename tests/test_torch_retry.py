"""The port's retry layer (``photon_tpu_torch.resilience.retry``) and its
failure classification, against the JAX package's.

The JAX package's ``TestRetry`` (tests/test_resilience.py) case by case,
on the port's copy, plus the same flaky call through both packages: the
same attempts, the same counters and the same backoff schedule (the
jitter stream is seeded by the call site's name in both). Where the two
classify differently by design it is said: the port reads CUDA error
codes where the JAX package reads gRPC/absl status markers.
"""

from __future__ import annotations

import numpy as np
import pytest

from photon_tpu_torch.resilience import (
    CheckpointError,
    InjectedCrash,
    PoisonError,
    RetryPolicy,
    ShutdownError,
    TransientError,
    call_with_retry,
    faults,
    is_transient,
    reset_retry_stats,
    retry_stats,
    retrying_check,
)
from photon_tpu_torch.resilience.errors import (
    STICKY_CUDA_ERRORS,
    cuda_error_code,
)

FAST = RetryPolicy(max_attempts=3, base_delay_s=0.001)
ZERO = {"retries": 0, "recovered": 0, "exhausted": 0,
        "backoff_seconds": 0.0}


@pytest.fixture(autouse=True)
def _clean():
    faults.disarm()
    reset_retry_stats()
    yield
    faults.disarm()
    reset_retry_stats()


def test_transient_recovers_and_counts():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientError("blip")
        return "ok"

    assert call_with_retry(flaky, site="t", policy=FAST) == "ok"
    stats = retry_stats()
    assert stats["retries"] == 2
    assert stats["recovered"] == 1
    assert stats["exhausted"] == 0


def test_exhausted_raises_last_error():
    def dead():
        raise TransientError("never clears")

    with pytest.raises(TransientError):
        call_with_retry(dead, site="t", policy=FAST)
    assert retry_stats()["exhausted"] == 1


def test_non_transient_never_retried():
    calls = []

    def poison():
        calls.append(1)
        raise PoisonError("deterministic")

    with pytest.raises(PoisonError):
        call_with_retry(poison, site="t", policy=FAST)
    assert len(calls) == 1
    assert retry_stats() == ZERO


def test_backoff_schedule_deterministic_and_capped():
    policy = RetryPolicy(max_attempts=6, base_delay_s=0.1, max_delay_s=0.3,
                         jitter=0.5)
    rng_a = np.random.default_rng(11)
    rng_b = np.random.default_rng(11)
    a = [policy.delay_for(i, rng_a) for i in range(1, 6)]
    b = [policy.delay_for(i, rng_b) for i in range(1, 6)]
    assert a == b
    assert all(d <= 0.3 * 1.5 for d in a)
    assert all(d >= 0 for d in a)


def test_clean_run_records_zero():
    assert call_with_retry(lambda: 1, site="t") == 1
    assert retry_stats() == ZERO


def test_real_cuda_transient_is_retried():
    """A real transient fault arrives untyped: torch raises the CUDA
    runtime's text in a plain RuntimeError. The port retries the one
    code it classifies as transient (the card held by another
    process); the JAX package's case raises a gRPC status instead."""
    calls = []

    def busy_once():
        calls.append(1)
        if len(calls) < 2:
            raise RuntimeError("CUDA error: CUDA-capable device(s) is/are "
                               "busy or unavailable")
        return "ok"

    assert call_with_retry(busy_once, site="t", policy=FAST) == "ok"
    stats = retry_stats()
    assert stats["retries"] == 1
    assert stats["recovered"] == 1


@pytest.mark.parametrize("exc", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("serve_score launch failed with CUDA error 719"),
    RuntimeError("CUDA error: out of memory"),
    RuntimeError("INVALID_ARGUMENT: dot shapes"),
    ValueError("bad operand"),
])
def test_deterministic_backend_error_not_retried(exc):
    """Sticky CUDA errors, an out-of-memory, any other error without a
    transient classification: the first attempt raises."""
    calls = []

    def det():
        calls.append(1)
        raise exc

    with pytest.raises(type(exc)):
        call_with_retry(det, site="t", policy=FAST)
    assert len(calls) == 1


def test_classify_none_restores_typed_only_retry():
    typed_only = RetryPolicy(max_attempts=3, base_delay_s=0.001,
                             classify=None)
    calls = []

    def flaky():
        calls.append(1)
        raise RuntimeError("CUDA error: CUDA-capable device(s) is/are "
                           "busy or unavailable")

    with pytest.raises(RuntimeError):
        call_with_retry(flaky, site="t", policy=typed_only)
    assert len(calls) == 1


def test_is_transient_taxonomy():
    assert is_transient(TransientError("blip"))
    assert is_transient(ConnectionResetError("peer reset"))
    assert is_transient(BrokenPipeError("Broken pipe"))
    assert is_transient(RuntimeError(
        "serve_score launch failed with CUDA error 46"))
    # The port's own typed failures are never transient.
    assert not is_transient(PoisonError("busy or unavailable"))
    assert not is_transient(InjectedCrash("busy or unavailable"))
    assert not is_transient(CheckpointError("busy or unavailable"))
    assert not is_transient(ShutdownError("busy or unavailable"))
    assert not is_transient(RuntimeError("plain failure"))
    assert not is_transient(KeyError("x"))
    # gRPC/absl markers name nothing on CUDA: the JAX package retries
    # these, the port does not.
    assert not is_transient(RuntimeError("ABORTED: slice restarting"))
    assert not is_transient(RuntimeError("UNAVAILABLE: Socket closed"))


@pytest.mark.parametrize("code", sorted(STICKY_CUDA_ERRORS))
def test_sticky_cuda_errors_are_never_transient(code):
    """A sticky error corrupts the context: by torch's text and by the
    kernel wrappers' ``launch failed with CUDA error <rc>`` alike."""
    text = RuntimeError(f"CUDA error: {STICKY_CUDA_ERRORS[code]}")
    rc = RuntimeError(f"newton_step launch failed with CUDA error {code}")
    assert cuda_error_code(text) == cuda_error_code(rc) == code
    assert not is_transient(text) and not is_transient(rc)


def test_retrying_check_fires_the_fault_inside_the_retried_call():
    plan = faults.FaultPlan([dict(point="serve.dispatch", nth=1),
                             dict(point="serve.dispatch", nth=2)])
    with faults.injected(plan):
        assert retrying_check("serve.dispatch", lambda: 7,
                              policy=FAST) == 7
        assert [f["call"] for f in faults.fired()] == [1, 2]
    assert retry_stats()["retries"] == 2
    assert retry_stats()["recovered"] == 1


def test_backoff_schedule_equals_the_reference():
    """The same flaky call through both packages' retry loops: the same
    attempts and counters, and the same seconds of backoff, since each
    seeds its jitter with crc32 of the site's name."""
    from photon_tpu.resilience import retry as jax_retry
    from photon_tpu.resilience.errors import TransientError as JaxTransient

    def flaky(err):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) < 4:
                raise err("blip")
            return len(calls)

        return fn

    kw = dict(max_attempts=5, base_delay_s=0.002, max_delay_s=0.01)
    jax_retry.reset_retry_stats()
    theirs = jax_retry.call_with_retry(
        flaky(JaxTransient), site="serve.dispatch",
        policy=jax_retry.RetryPolicy(**kw))
    ours = call_with_retry(flaky(TransientError), site="serve.dispatch",
                           policy=RetryPolicy(**kw))
    assert ours == theirs == 4
    assert retry_stats() == jax_retry.retry_stats()
    jax_retry.reset_retry_stats()
