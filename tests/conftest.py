"""Test harness: force an 8-device virtual CPU mesh before JAX initializes.

The reference tests "multi-node" logic with Spark local[*] mode
(photon-test-utils SparkTestUtils.scala:43-76); the TPU-native equivalent is
an 8-device host-platform CPU mesh, which exercises the same sharding,
collective, and pjit code paths on one host.
"""

import os

# Must be set before jax is first imported anywhere in the test process.
# Explicit assignment (not setdefault): the outer environment may pin
# JAX_PLATFORMS to a real accelerator; tests always run on the virtual
# 8-device CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

# The jaxtyping pytest plugin imports jax before this conftest runs, so the
# env vars above are too late for jax's config defaults — but the XLA backend
# itself is still uninitialized, so explicit config updates take effect.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU mode); the "
        "test skips without one",
    )


@pytest.fixture(scope="session")
def devices():
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 virtual devices, got {len(devs)}"
    return devs


@pytest.fixture(scope="session")
def mesh(devices):
    from jax.sharding import Mesh

    return Mesh(np.array(devices).reshape(4, 2), ("data", "model"))


@pytest.fixture
def rng():
    return np.random.default_rng(20260729)


@pytest.fixture(autouse=True)
def _clean_retry_stats():
    """Zero the process-global retry counters AND the cost-ledger
    accumulators before every test.

    The retry layer's stats dict (``resilience.retry.retry_stats``) is
    process-global by design — production reads it as a health surface —
    which in a test process means one test's injected transients leak
    into the next test's "clean run records zero retries" assertion.
    PRs 8/10 hand-reset it from individual tests; this fixture is that
    idiom factored into the harness: every test STARTS from zero, and
    tests that assert on accumulation within themselves are unaffected.

    The ledger (``photon_tpu.obs.ledger``) gets the same treatment —
    its census/rows/compiles/resident accounts are process-global, and
    the "a ledger-off run registers ZERO programs" contract would be
    unfalsifiable if a previous test's armed run left entries behind.
    The enable flag is restored to the OFF default too (a test that
    arms the ledger must not silently instrument its successors).

    The health layer (``photon_tpu.obs.health``) follows the same
    policy: serve-tap sketches, parked numerics sentinels, and the
    enable flag are process-global, and a prior test's armed pilot run
    must not leak a sketch (or the armed flag) into its successors.

    The segment-reduce kernel's trace-time site registry
    (``ops.segment_reduce._TRACED_SITES``) is cleared too: a forced-
    kernel test's traced shapes must not register phantom census rows
    when a LATER test runs a ledger-armed fused fit.
    """
    from photon_tpu.obs import health, ledger
    from photon_tpu.ops import segment_reduce
    from photon_tpu.resilience.retry import reset_retry_stats

    reset_retry_stats()
    ledger.reset()
    ledger.disable()
    health.reset()
    health.disable()
    segment_reduce._TRACED_SITES.clear()
    yield
