"""Dense and padded-sparse (ELL) feature matrices and the GLM batch
(port of ``photon_tpu/data/dataset.py``).

A dataset is a struct of tensors on one device. ELL padding slots point
at a valid column with value 0, so the matvec is a gather plus a
multiply-reduce. Rows carry (label, offset, weight); weight 0 removes a
row from every sum.

The ELL transpose (``rmatvec``, ``rmatvec_sq``: the fixed effect's
gradient and Hessian diagonal) is deterministic by construction. Once
per ``SparseFeatures`` the rows are cut into ``parts`` equal blocks and
the slots sorted by (block, feature id), stably, so each feature's slots
keep row order within a block. Every call multiplies the sorted slots
by their rows' weights, reduces them with
``segment_reduce.sorted_segment_sum`` at the ``fixed_effect`` site into
``parts * d`` sums (the segment-sum kernel on the card, its plain
version on the CPU) and adds the blocks' sums per feature with a torch
``sum``, a reduce without atomics whose order is fixed. The reference's
``.at[].add`` is a scatter-add, which a GPU runs with float atomics
whose order changes from run to run; here every addition has a place
fixed by the data, so two fits on the same data are equal bit for bit.
The blocks are there for the kernel, which gives each tile of output
segments to one thread block: a fixed effect has few features, and
without them its whole reduce would run on one SM.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from photon_tpu_torch import device as device_mod
from photon_tpu_torch.ops import segment_reduce


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


# Output segments the split transpose aims at: about four of the
# segment-sum kernel's smallest tiles (1,024 segments) for each of an
# H100's 132 SMs; at most a quarter of the slots, so that the
# [parts, d] partial sums stay small beside the slots they reduce.
_SPLIT_SEGMENTS = 1 << 19


def transpose_block_rows(num_rows: int, k: int, d: int) -> int:
    """Rows in each block of the transpose of a [num_rows, k] ELL matrix
    with ``d`` features: all of them where ``d`` alone is that many
    segments."""
    target = min(_SPLIT_SEGMENTS, num_rows * k // 4)
    parts = max(1, min(target // max(d, 1), num_rows))
    return -(-num_rows // parts)


@dataclasses.dataclass(frozen=True)
class _TransposePlan:
    """An ELL matrix's slots in ascending stable order of (row block,
    feature id): their int32 keys ``block * d + id``, values and int32
    rows, and the number of row blocks."""

    ids: torch.Tensor  # [n k] int32, sorted
    values: torch.Tensor  # [n k]
    rows: torch.Tensor  # [n k] int32
    parts: int


@dataclasses.dataclass(frozen=True)
class SparseFeatures:
    """ELL layout: per-row id/value slabs of a fixed width ``k``."""

    indices: torch.Tensor  # [n, k] int32
    values: torch.Tensor  # [n, k]
    d: int
    _plan: _TransposePlan | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def num_features(self) -> int:
        return self.d

    @property
    def num_rows(self) -> int:
        return self.indices.shape[0]

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.values * w[self.indices.long()], dim=-1)

    def transpose_plan(self) -> _TransposePlan:
        """The sorted slots that ``rmatvec`` reduces, built on the first
        call (one stable sort on the features' device) and kept: the
        slot ids never change while the features live."""
        if self._plan is None:
            n, k = self.indices.shape
            block_rows = transpose_block_rows(n, k, self.d)
            parts = -(-n // block_rows)
            rows = torch.arange(n * k, device=self.indices.device) // k
            keys = (rows // block_rows) * self.d + self.indices.reshape(-1)
            keys, order = torch.sort(keys, stable=True)
            object.__setattr__(self, "_plan", _TransposePlan(
                keys.to(torch.int32),
                self.values.reshape(-1)[order].contiguous(),
                rows[order].to(torch.int32), parts))
        return self._plan

    def _reduce(self, plan: _TransposePlan,
                slots: torch.Tensor) -> torch.Tensor:
        out = segment_reduce.sorted_segment_sum(
            slots, plan.ids, plan.parts * self.d, site="fixed_effect")
        if plan.parts > 1:
            out = out.view(plan.parts, self.d).sum(0)
        return out.to(slots.dtype)

    def rmatvec(self, g: torch.Tensor) -> torch.Tensor:
        plan = self.transpose_plan()
        return self._reduce(plan, plan.values * g.index_select(0, plan.rows))

    def rmatvec_sq(self, g: torch.Tensor) -> torch.Tensor:
        plan = self.transpose_plan()
        return self._reduce(plan, plan.values * plan.values
                            * g.index_select(0, plan.rows))


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
