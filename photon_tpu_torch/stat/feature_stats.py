"""Per-feature summary statistics in one pass over a feature matrix
(port of ``photon_tpu/stat/feature_stats.py``).

Counterpart of FeatureDataStatistics (photon-lib
stat/FeatureDataStatistics.scala:44-139), which wraps Spark's
MultivariateOnlineSummarizer: weighted per-feature mean, variance, min,
max and nonzero count over all rows, implicit zeros included. It feeds
``build_normalization_context`` and the training CLI's feature-stats
artifact (GameTrainingDriver.calculateAndSaveFeatureShardStats
:616-647).

Everything runs in host numpy float64, as the reference's does, over
dense, ELL or DualEll features (the tail folded back into its rows)
whose arrays are numpy or tensors on any device.
The variance is Spark's unbiased weighted estimator,
var_j = (sumW / (sumW - 1)) * (E[x^2] - E[x]^2).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.data.dataset import (
    DenseFeatures,
    DualEllFeatures,
    SparseFeatures,
)
from photon_tpu_torch.data.random_effect import _subset_rows_widened


def _host(a, dtype=None) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class FeatureDataStatistics:
    """Reference: stat/FeatureDataStatistics.scala:44."""

    mean: np.ndarray  # [d] weighted mean
    variance: np.ndarray  # [d] unbiased weighted variance
    min: np.ndarray  # [d]
    max: np.ndarray  # [d]
    num_nonzeros: np.ndarray  # [d] weighted nonzero count
    count: float  # total weight
    intercept_index: int | None = None
    # Spark's normL1 = sum w|x| and normL2 = sqrt(sum w x^2), for the
    # feature-stats artifact's metrics map.
    norm_l1: np.ndarray | None = None  # [d]
    norm_l2: np.ndarray | None = None  # [d]

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    @staticmethod
    def from_features(features, weights=None, *,
                      intercept_index: int | None = None
                      ) -> "FeatureDataStatistics":
        if isinstance(features, DenseFeatures):
            x = _host(features.x, np.float64)
            n, d = x.shape
            w = np.ones(n) if weights is None else _host(weights, np.float64)
            sum_w = float(w.sum())
            mean = (w @ x) / sum_w
            ex2 = (w @ (x * x)) / sum_w
            norm_l1 = w @ np.abs(x)
            # The summarizer skips rows of non-positive weight entirely.
            xw = x[w > 0.0]
            if xw.shape[0] == 0:
                mn, mx = np.zeros(d), np.zeros(d)
            else:
                mn, mx = xw.min(axis=0), xw.max(axis=0)
            nnz = (w[:, None] * (x != 0.0)).sum(axis=0)
        elif isinstance(features, (SparseFeatures, DualEllFeatures)):
            idx = _host(features.indices)
            val = _host(features.values, np.float64)
            if isinstance(features, DualEllFeatures):
                tail = (_host(features.tail_rows).astype(np.int64),
                        _host(features.tail_indices),
                        _host(features.tail_values, np.float64))
                idx, val = _subset_rows_widened(idx, val, tail,
                                                np.arange(idx.shape[0]))
            n, d = idx.shape[0], features.d
            w = np.ones(n) if weights is None else _host(weights, np.float64)
            sum_w = float(w.sum())
            # Zero-weight rows are skipped (min/max, nnz, implicit zeros).
            present = (val != 0.0) & (w[:, None] > 0.0)
            n_pos = int((w > 0.0).sum())
            flat_idx = idx[present]
            flat_val = val[present]
            flat_w = np.broadcast_to(w[:, None], idx.shape)[present]
            s1, s2 = np.zeros(d), np.zeros(d)
            nnz, norm_l1 = np.zeros(d), np.zeros(d)
            np.add.at(s1, flat_idx, flat_w * flat_val)
            np.add.at(s2, flat_idx, flat_w * flat_val * flat_val)
            np.add.at(nnz, flat_idx, flat_w)
            np.add.at(norm_l1, flat_idx, flat_w * np.abs(flat_val))
            mean = s1 / sum_w
            ex2 = s2 / sum_w
            # min/max over stored values; an implicit zero counts when a
            # column has a row without that feature.
            mn = np.full(d, np.inf)
            mx = np.full(d, -np.inf)
            np.minimum.at(mn, flat_idx, flat_val)
            np.maximum.at(mx, flat_idx, flat_val)
            rows_per_col = np.zeros(d)
            np.add.at(rows_per_col, flat_idx, 1.0)
            has_zero = rows_per_col < n_pos
            mn = np.where(has_zero, np.minimum(mn, 0.0), mn)
            mx = np.where(has_zero, np.maximum(mx, 0.0), mx)
            mn = np.where(np.isinf(mn), 0.0, mn)
            mx = np.where(np.isinf(mx), 0.0, mx)
        else:
            raise TypeError(f"expected Dense, Sparse or DualEll features, "
                            f"got {type(features).__name__}")
        correction = sum_w / max(sum_w - 1.0, 1.0)
        variance = np.maximum(correction * (ex2 - mean * mean), 0.0)
        return FeatureDataStatistics(
            mean=mean, variance=variance, min=mn, max=mx,
            num_nonzeros=nnz, count=sum_w, intercept_index=intercept_index,
            norm_l1=norm_l1,
            norm_l2=np.sqrt(np.maximum(ex2 * sum_w, 0.0)),
        )
