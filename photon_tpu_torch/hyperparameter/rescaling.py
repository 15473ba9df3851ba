"""Hyperparameter vector rescaling between user space and the unit cube.

Port of ``photon_tpu/hyperparameter/rescaling.py``, the counterpart of
photon-lib hyperparameter/VectorRescaling.scala:150: forward/backward LOG
(base 10) and SQRT transforms on selected indices, and linear scaling of
each dimension into [0, 1] given per-dimension ranges, with the reference's
+1 width adjustment for discrete dimensions. Host-side numpy — these are
tiny vectors manipulated between search iterations.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LOG_TRANSFORM = "LOG"
SQRT_TRANSFORM = "SQRT"


@dataclasses.dataclass(frozen=True)
class DoubleRange:
    """Closed interval (util/DoubleRange.scala)."""

    start: float
    end: float

    def transform(self, fn) -> "DoubleRange":
        return DoubleRange(fn(self.start), fn(self.end))


def transform_forward(vector, transform_map: dict[int, str]) -> np.ndarray:
    out = np.array(vector, dtype=float)
    for index, transform in transform_map.items():
        if transform == LOG_TRANSFORM:
            out[index] = np.log10(out[index])
        elif transform == SQRT_TRANSFORM:
            out[index] = np.sqrt(out[index])
        else:
            raise ValueError(f"Unknown transformation: {transform}")
    return out


def transform_backward(vector, transform_map: dict[int, str]) -> np.ndarray:
    out = np.array(vector, dtype=float)
    for index, transform in transform_map.items():
        if transform == LOG_TRANSFORM:
            out[index] = 10.0 ** out[index]
        elif transform == SQRT_TRANSFORM:
            out[index] = out[index] ** 2
        else:
            raise ValueError(f"Unknown transformation: {transform}")
    return out


def _range_arrays(ranges, discrete_index_set):
    start = np.array([r.start for r in ranges])
    end = np.array([r.end for r in ranges])
    adj = np.array([
        1.0 if i in (discrete_index_set or set()) else 0.0
        for i in range(len(ranges))
    ])
    return start, end, adj


def scale_forward(vector, ranges, discrete_index_set=None) -> np.ndarray:
    """User space -> [0, 1]^d (scaleForward; discrete dims widen by 1)."""
    start, end, adj = _range_arrays(ranges, discrete_index_set)
    return (np.array(vector, dtype=float) - start) / (end - start + adj)


def scale_backward(vector, ranges, discrete_index_set=None) -> np.ndarray:
    """[0, 1]^d -> user space (scaleBackward)."""
    start, end, adj = _range_arrays(ranges, discrete_index_set)
    return np.array(vector, dtype=float) * (end - start + adj) + start


def rescale_priors(priors, ranges, transform_map, discrete_index_set=None):
    """Map prior (candidate, eval) pairs into the unit cube
    (VectorRescaling.rescalePriors)."""
    out = []
    for candidate, value in priors:
        t = transform_forward(candidate, transform_map)
        out.append((scale_forward(t, ranges, discrete_index_set), value))
    return out
