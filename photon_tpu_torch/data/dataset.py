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

    ids: torch.Tensor  # [m] int32, sorted
    values: torch.Tensor  # [m]
    rows: torch.Tensor  # [m] int32
    parts: int


def _sorted_transpose(rows: torch.Tensor, ids: torch.Tensor,
                      values: torch.Tensor, num_rows: int,
                      d: int) -> _TransposePlan:
    """The transpose plan of entries given in row order (``rows``
    ascending): one stable sort by (row block, feature id), so each
    feature's entries keep their row order within a block."""
    m = int(rows.shape[0])
    k = -(-m // max(num_rows, 1))
    block_rows = transpose_block_rows(num_rows, max(k, 1), d)
    parts = max(-(-num_rows // block_rows), 1)
    keys = (rows // block_rows) * d + ids.long()
    keys, order = torch.sort(keys, stable=True)
    return _TransposePlan(keys.to(torch.int32),
                          values[order].contiguous(),
                          rows[order].to(torch.int32), parts)


def _transpose_reduce(plan: _TransposePlan, slots: torch.Tensor,
                      d: int) -> torch.Tensor:
    """``[d]`` sums of the plan's weighted slots at the ``fixed_effect``
    site, the row blocks' partial sums added per feature."""
    out = segment_reduce.sorted_segment_sum(
        slots, plan.ids, plan.parts * d, site="fixed_effect")
    if plan.parts > 1:
        out = out.view(plan.parts, d).sum(0)
    return out.to(slots.dtype)


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
            rows = torch.arange(n * k, device=self.indices.device) // k
            object.__setattr__(self, "_plan", _sorted_transpose(
                rows, self.indices.reshape(-1), self.values.reshape(-1),
                n, self.d))
        return self._plan

    def rmatvec(self, g: torch.Tensor) -> torch.Tensor:
        plan = self.transpose_plan()
        return _transpose_reduce(
            plan, plan.values * g.index_select(0, plan.rows), self.d)

    def rmatvec_sq(self, g: torch.Tensor) -> torch.Tensor:
        plan = self.transpose_plan()
        return _transpose_reduce(
            plan, plan.values * plan.values * g.index_select(0, plan.rows),
            self.d)


@dataclasses.dataclass(frozen=True)
class DualEllFeatures:
    """A bounded-width ELL slab plus a COO tail of the entries past its
    width cap (``tail_rows`` ascending), so one wide row does not widen
    every row. The tail's per-row sums in ``matvec`` run over its sorted
    rows through ``segment_reduce.sorted_segment_sum`` (site
    ``dual_ell_tail``); the transposes reduce the slab's and the tail's
    entries together through one plan sorted by (row block, feature id),
    as ``SparseFeatures``' do, at the ``fixed_effect`` site. No float
    atomics: two fits are equal bit for bit."""

    indices: torch.Tensor  # [n, cap] int32; padding -> (0, value 0)
    values: torch.Tensor  # [n, cap]
    tail_rows: torch.Tensor  # [t] int32, ascending
    tail_indices: torch.Tensor  # [t] int32
    tail_values: torch.Tensor  # [t]
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
        base = torch.sum(self.values * w[self.indices.long()], dim=-1)
        tail = self.tail_values * w[self.tail_indices.long()]
        summed = segment_reduce.sorted_segment_sum(
            tail, self.tail_rows, self.num_rows, site="dual_ell_tail")
        return base + summed.to(base.dtype)

    def transpose_plan(self) -> _TransposePlan:
        """The slab's and the tail's entries in row order (a row's slab
        entries before its tail entries), then sorted as
        ``SparseFeatures.transpose_plan`` sorts; built once."""
        if self._plan is None:
            n, cap = self.indices.shape
            dev = self.indices.device
            rows = torch.cat([
                torch.arange(n * cap, device=dev) // cap,
                self.tail_rows.long()])
            ids = torch.cat([self.indices.reshape(-1).long(),
                             self.tail_indices.long()])
            vals = torch.cat([self.values.reshape(-1), self.tail_values])
            rows, order = torch.sort(rows, stable=True)
            object.__setattr__(self, "_plan", _sorted_transpose(
                rows, ids[order], vals[order], n, self.d))
        return self._plan

    def rmatvec(self, g: torch.Tensor) -> torch.Tensor:
        plan = self.transpose_plan()
        return _transpose_reduce(
            plan, plan.values * g.index_select(0, plan.rows), self.d)

    def rmatvec_sq(self, g: torch.Tensor) -> torch.Tensor:
        plan = self.transpose_plan()
        return _transpose_reduce(
            plan, plan.values * plan.values * g.index_select(0, plan.rows),
            self.d)


def ell_to_dual_ell(indices, values, num_features: int, width_cap: int,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> DualEllFeatures:
    """Split a host ELL slab at ``width_cap``: each row's nonzero
    entries are compacted left, the first ``width_cap`` stay in the
    slab and the rest spill to the tail, on ``device`` (default
    ``cuda``)."""
    dev = device_mod.resolve(device)
    indices = np.asarray(indices)
    values = np.asarray(values)
    n, k = indices.shape
    cap = max(min(width_cap, k), 1)
    present = values != 0.0
    order = np.argsort(~present, axis=1, kind="stable")
    idx_c = np.take_along_axis(np.where(present, indices, 0), order, axis=1)
    val_c = np.take_along_axis(np.where(present, values, 0.0), order,
                               axis=1)
    tail_mask = val_c[:, cap:] != 0.0
    rows = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None],
                           tail_mask.shape)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def put(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)

    return DualEllFeatures(
        indices=put(idx_c[:, :cap], np.int32),
        values=put(val_c[:, :cap], np_dtype),
        tail_rows=put(rows[tail_mask], np.int32),
        tail_indices=put(idx_c[:, cap:][tail_mask], np.int32),
        tail_values=put(val_c[:, cap:][tail_mask], np_dtype),
        d=num_features,
    )


Features = Union[DenseFeatures, SparseFeatures, DualEllFeatures]


@dataclasses.dataclass(frozen=True)
class GLMBatch:
    """One coordinate's training rows: features plus (label, offset,
    weight). A row-sharded batch (``parallel.mesh.shard_batch``) holds
    this rank's share of the padded rows and carries its ``mesh`` and
    the ``logical_rows`` of the whole batch; the objective's sums then
    cross the ranks (``ops/glm.py``)."""

    features: Features
    labels: torch.Tensor  # [n]
    offsets: torch.Tensor  # [n]
    weights: torch.Tensor  # [n]
    mesh: object = None  # parallel.mesh.Mesh of a row-sharded batch
    logical_rows: int | None = None  # rows of the whole, unpadded batch

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


def pad_rows(feats: Features, rows: int) -> Features:
    """Dense or ELL features padded with zero rows to ``rows`` rows. A
    ``DualEllFeatures`` tail is not row-aligned and is refused."""
    short = rows - feats.num_rows

    def pad1(a):
        if short == 0:
            return a
        return torch.cat([a, a.new_zeros((short,) + tuple(a.shape[1:]))])

    if isinstance(feats, DenseFeatures):
        return DenseFeatures(pad1(feats.x))
    if isinstance(feats, SparseFeatures):
        return SparseFeatures(pad1(feats.indices), pad1(feats.values),
                              feats.d)
    raise TypeError(
        "pad_batch/shard_batch do not support DualEllFeatures: the COO "
        "tail is not row-aligned, so row sharding would misroute it. "
        "Use plain SparseFeatures for data-axis sharding, or "
        "FeatureShardedSparse for the feature axis.")


def pad_batch(batch: GLMBatch, multiple: int) -> GLMBatch:
    """Pad the sample axis to a multiple (for even device sharding) with
    weight-0 rows; padding rows contribute exactly zero to every
    aggregate."""
    n = batch.num_samples
    rows = n + (-n) % multiple
    if rows == n:
        return batch

    def pad1(a):
        return torch.cat([a, a.new_zeros(rows - n)])

    return dataclasses.replace(
        batch, features=pad_rows(batch.features, rows),
        labels=pad1(batch.labels), offsets=pad1(batch.offsets),
        weights=pad1(batch.weights))  # zeros: inert rows


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
