"""Device-side convergence traces (port of
``photon_tpu/obs/convergence.py``).

The fused fit (``algorithm/fused_fit.py``, one CUDA-graph replay a fit
on the card) computes a small per-(CD iteration, coordinate)
convergence block as extra outputs and, with telemetry on, hands the
device tensor here without a host sync; a consumer (the snapshot, the
JSONL exporter) fetches it later. The unfused loop deliberately records
nothing: a per-iteration record would add a host sync an iteration.

Metric columns, in order (``METRICS``): the coordinate's final loss and
gradient norm (fixed effects only), the squared change of its score
vector, of its coefficients, and the squared norm of the new table.

Threading: the parked-trace ring and the fit counter are guarded by
``_lock``; the device-to-host fetch runs outside it, and the cached
host copy is installed under it.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np

METRICS = (
    "loss",
    "grad_norm",
    "residual_delta_sq",
    "weight_delta_sq",
    "weight_norm_sq",
)

# Bounded: parked device buffers would otherwise pin device memory.
_MAX_TRACES = 8

_lock = threading.Lock()
_traces: deque = deque(maxlen=_MAX_TRACES)
_fits_recorded = 0


def reset() -> None:
    global _fits_recorded
    with _lock:
        _traces.clear()
        _fits_recorded = 0


def record(coordinates: tuple[str, ...], array) -> None:
    """Park one fit's [num_iters, len(coordinates), len(METRICS)] array
    (a tensor or numpy). No sync, no transfer."""
    global _fits_recorded
    with _lock:
        _traces.append({"coordinates": tuple(coordinates), "array": array})
        _fits_recorded += 1


def _to_numpy(arr) -> np.ndarray:
    detach = getattr(arr, "detach", None)
    if detach is not None:
        return detach().cpu().numpy()
    return np.asarray(arr)


def _series(t: dict) -> dict:
    """Materialize one parked trace; the fetch runs outside the lock and
    is cached per entry."""
    with _lock:
        arr = t.get("np")
        dev = t.get("array")
    if arr is None:
        fetched = _to_numpy(dev)
        with _lock:
            arr = t.get("np")
            if arr is None:
                arr = t["np"] = fetched
                t["array"] = None
    return {
        cid: {m: [float(v) for v in arr[:, j, k]]
              for k, m in enumerate(METRICS)}
        for j, cid in enumerate(t["coordinates"])
    }


def traces() -> list[dict]:
    """Materialized traces, oldest first: per fit
    ``{coordinate: {metric: [per-iteration floats]}}``."""
    with _lock:
        parked = list(_traces)
    return [_series(t) for t in parked]


def snapshot() -> dict:
    """Fit count, metric names and the last fit's series."""
    with _lock:
        n = _fits_recorded
        last = _traces[-1] if _traces else None
    return {
        "fits_recorded": n,
        "metrics": list(METRICS),
        "last": None if last is None else _series(last),
    }
