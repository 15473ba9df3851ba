"""Ahead-of-time captures and their counters (port of
``photon_tpu/utils/compile_cache.py``).

The JAX package compiles its programs with XLA, ahead of time where it
can (the serving ladder, the fused fit's warm compile during ingest),
and keeps the executables in a persistent on-disk cache. The port's
counterparts:

- a program is captured, not compiled: a CUDA graph of the serving
  ladder's rung (``serve/programs.py``) or of the fused fit
  (``algorithm/fused_fit.py``), captured during ``prepare`` on the
  ingest pipeline's compile pool (``GameEstimator._warm_capture``).
  ``aot_capture`` runs every such capture as a retried site of the
  ``compile.aot`` fault point, as the reference's ``aot_compile`` does;
- the persistent cache is the kernel library that ``ops/_build.py``
  builds once per source hash under the checkout's ``build/kernels/``:
  a process that finds the library there loads it (a hit), one that
  does not builds it (a miss).

``cache_stats()`` keeps the reference's keys: ``aot_compiles`` and
``aot_compile_seconds`` count the captures that ``aot_capture`` ran
(and, on the CPU, where nothing is captured, the warm stage's build it
stood for), ``aot_failures`` the ones that raised after their retries,
``persistent_hits`` / ``persistent_misses`` the kernel library's loads
and builds. The counters change under the module lock; the capture
itself runs outside it.
"""

from __future__ import annotations

import threading
import time

_lock = threading.Lock()
_stats = {
    "persistent_hits": 0,
    "persistent_misses": 0,
    "aot_compiles": 0,
    "aot_compile_seconds": 0.0,
    "aot_failures": 0,
}
_dir_in_effect: str | None = None


def aot_capture(fn, *, ledger_key: str | None = None):
    """Run ``fn`` (a capture) under ``compile.aot``'s retry: an injected
    or real transient failure re-runs it with backoff, so ``fn`` must
    start afresh on every attempt. Counted in ``cache_stats()``; the
    seconds are booked in the cost ledger's compile account under
    ``ledger_key`` (``aot`` when None). A failure that outlasts the
    retries is counted in ``aot_failures`` and raised."""
    from photon_tpu_torch.resilience import retry

    t0 = time.perf_counter()
    try:
        out = retry.retrying_check("compile.aot", fn,
                                   site="compile_cache.aot_capture")
    except Exception:
        record_failure()
        raise
    seconds = time.perf_counter() - t0
    with _lock:
        _stats["aot_compiles"] += 1
        _stats["aot_compile_seconds"] += seconds
    from photon_tpu_torch.obs import ledger

    ledger.record_compile(ledger_key or "aot", seconds)
    return out


def record_failure() -> None:
    """Count a warm stage that failed outside ``aot_capture``."""
    with _lock:
        _stats["aot_failures"] += 1


def note_library(path: str, *, built: bool) -> None:
    """The kernel library at ``path`` was built (a miss) or found in its
    build directory and loaded (a hit)."""
    import os

    global _dir_in_effect
    with _lock:
        _stats["persistent_misses" if built else "persistent_hits"] += 1
        _dir_in_effect = os.path.dirname(path)


def cache_stats() -> dict:
    """The counters (module docstring), ``hit_rate`` (None before the
    library was needed) and ``dir``, the kernel library's build
    directory."""
    with _lock:
        snap = dict(_stats)
        cache_dir = _dir_in_effect
    total = snap["persistent_hits"] + snap["persistent_misses"]
    return {
        "dir": cache_dir,
        "persistent_hits": snap["persistent_hits"],
        "persistent_misses": snap["persistent_misses"],
        "hit_rate": (snap["persistent_hits"] / total) if total else None,
        "aot_compiles": snap["aot_compiles"],
        "aot_compile_seconds": round(snap["aot_compile_seconds"], 4),
        "aot_failures": snap["aot_failures"],
    }
