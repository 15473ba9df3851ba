"""Dense and padded-sparse (ELL) feature matrices and the GLM batch
(port of ``photon_tpu/data/dataset.py``).

A dataset is a struct of tensors on one device. ELL padding slots point
at a valid column with value 0, so the matvec is a gather plus a
multiply-reduce and the transposed matvec an ``index_add_``. Rows carry
(label, offset, weight); weight 0 removes a row from every sum.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from photon_tpu_torch import device as device_mod


@dataclasses.dataclass(frozen=True)
class DenseFeatures:
    x: torch.Tensor  # [n, d]

    @property
    def num_features(self) -> int:
        return self.x.shape[-1]

    @property
    def num_rows(self) -> int:
        return self.x.shape[0]

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        return self.x @ w

    def rmatvec(self, g: torch.Tensor) -> torch.Tensor:
        return self.x.T @ g

    def rmatvec_sq(self, g: torch.Tensor) -> torch.Tensor:
        return (self.x * self.x).T @ g


@dataclasses.dataclass(frozen=True)
class SparseFeatures:
    """ELL layout: per-row id/value slabs of a fixed width ``k``."""

    indices: torch.Tensor  # [n, k] int32
    values: torch.Tensor  # [n, k]
    d: int

    @property
    def num_features(self) -> int:
        return self.d

    @property
    def num_rows(self) -> int:
        return self.indices.shape[0]

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.values * w[self.indices.long()], dim=-1)

    def _scatter(self, contrib: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.d, dtype=contrib.dtype, device=contrib.device)
        return out.index_add_(0, self.indices.reshape(-1).long(),
                              contrib.reshape(-1))

    def rmatvec(self, g: torch.Tensor) -> torch.Tensor:
        return self._scatter(self.values * g[:, None])

    def rmatvec_sq(self, g: torch.Tensor) -> torch.Tensor:
        return self._scatter(self.values * self.values * g[:, None])


Features = Union[DenseFeatures, SparseFeatures]


@dataclasses.dataclass(frozen=True)
class GLMBatch:
    """One coordinate's training rows: features plus (label, offset,
    weight)."""

    features: Features
    labels: torch.Tensor  # [n]
    offsets: torch.Tensor  # [n]
    weights: torch.Tensor  # [n]

    @property
    def num_samples(self) -> int:
        return self.labels.shape[-1]

    @property
    def num_features(self) -> int:
        return self.features.num_features

    def with_offsets(self, offsets: torch.Tensor) -> "GLMBatch":
        return dataclasses.replace(self, offsets=offsets)

    def with_weights(self, weights: torch.Tensor) -> "GLMBatch":
        return dataclasses.replace(self, weights=weights)


def rows_to_ell(rows: list, num_features: int, *, capacity: int | None = None,
                dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (index, value) lists packed into ELL index/value slabs
    of width ``capacity`` (default: the longest row)."""
    k = capacity if capacity is not None else max(
        (len(r) for r in rows), default=1)
    k = max(k, 1)
    n = len(rows)
    indices = np.zeros((n, k), dtype=np.int32)
    values = np.zeros((n, k), dtype=dtype)
    for i, row in enumerate(rows):
        if len(row) > k:
            raise ValueError(f"row {i} has {len(row)} nnz > capacity {k}")
        for j, (idx, val) in enumerate(row):
            if not 0 <= idx < num_features:
                raise ValueError(f"feature index {idx} out of range "
                                 f"[0, {num_features})")
            indices[i, j] = idx
            values[i, j] = val
    return indices, values


def make_sparse_batch(rows: list, num_features: int, labels, offsets=None,
                      weights=None, capacity: int | None = None,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> GLMBatch:
    """A GLMBatch of ELL features from per-row (index, value) lists, on
    ``device`` (default ``cuda``)."""
    dev = device_mod.resolve(device)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    indices, values = rows_to_ell(rows, num_features, capacity=capacity,
                                  dtype=np_dtype)
    n = len(rows)

    def put(a, fill=None):
        if a is None:
            return torch.full((n,), fill, dtype=dtype, device=dev)
        return torch.as_tensor(np.asarray(a, dtype=np_dtype)).to(dev)

    return GLMBatch(
        features=SparseFeatures(torch.from_numpy(indices).to(dev),
                                torch.from_numpy(values).to(dev),
                                num_features),
        labels=put(labels),
        offsets=put(offsets, 0.0),
        weights=put(weights, 1.0),
    )
