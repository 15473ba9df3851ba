"""RandomEffectDataset: per-entity data as size-bucketed blocks (port of
the lazy layout of ``photon_tpu/data/random_effect.py``).

Two stages, as in the reference (RandomEffectDataset.scala:264-354):

1. **Plan (host, numpy)**: one sort of the rows by (entity, reservoir
   hash) gives the deterministic reservoir cap (groupDataByKeyAndSample
   :468-527), one pass over (entity, feature) pairs gives every entity's
   subspace projector, and the active entities are grouped into
   size buckets. The plan arrays are byte-identical to the JAX
   planner's.
2. **Device placement (lazy)**: only the small plan arrays go to the
   device. Each bucket's ``[B, R, S]`` design slab is gathered on the
   device from the raw feature tensors: once per dataset into a cache
   (``device_blocks``) while the slabs fit ``_DEVICE_SLAB_BUDGET_BYTES``,
   else inside every solve (``BlockPlan.materialize``).

Scoring is scatter-free: ``score_inv`` maps each canonical row to its
position in the concatenation of every bucket's ``[B, cap]`` score block
followed by the passive rows' scores, so one gather distributes them.

``build_random_effect_dataset`` picks the **materialized** layout by
itself when a subspace is wider than ``DENSE_SUB_DIM_MAX`` or the
configuration sets ``score_table_width_cap`` (as the reference does):
every bucket is built on the host as ELL blocks ``[B, R, k]`` of subspace
slots, with the gram route's window bounds (``block_gram_mults``), and
every row scores through a remapped ``[n, k]`` score table whose rows
past the width cap spill into a COO tail. The lazy layout's ELL slab for
wide subspaces is not ported: a wide lazy bucket raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from photon_tpu_torch.data.dataset import (
    DenseFeatures,
    Features,
    SparseFeatures,
)
from photon_tpu_torch.data.game_data import GameDataset
from photon_tpu_torch.ops import segment_reduce

DEFAULT_BUCKET_CAPS = (16, 64, 256, 1024, 4096)
# Up to this subspace width a bucket's slab is subspace-dense [B, R, S].
DENSE_SUB_DIM_MAX = 128
# Element bound on the one-hot operand that densifies an ELL shard.
ONE_HOT_ELEMENT_BUDGET = 1 << 28
# Total device bytes of cached materialized slabs (device_blocks).
_DEVICE_SLAB_BUDGET_BYTES = 2 << 30


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to photon_tpu_torch yet (ROADMAP Queue A)")


@dataclasses.dataclass(frozen=True)
class RandomEffectDataConfiguration:
    """Per-coordinate random-effect data config
    (CoordinateDataConfiguration.scala:77)."""

    random_effect_type: str
    feature_shard_id: str
    active_data_upper_bound: int | None = None
    active_data_lower_bound: int | None = None
    features_to_samples_ratio: float | None = None
    bucket_caps: tuple = DEFAULT_BUCKET_CAPS
    score_table_width_cap: int | None = None
    # Buckets with fewer entities than this merge upward into the next
    # occupied cap (0 = off).
    min_bucket_entities: int = 0


@dataclasses.dataclass(frozen=True)
class EntityBlocks:
    """One size bucket with its design slab on the device. Padding rows
    carry weight 0; padded slots have ``proj == -1``."""

    entity_codes: torch.Tensor  # [B] int32
    # ELL: x_indices [B, R, k] int32 subspace slots with x_values
    # [B, R, k]; subspace-dense: x_indices is None, x_values [B, R, S].
    x_indices: torch.Tensor | None
    x_values: torch.Tensor  # [B, R, k] or [B, R, S]
    labels: torch.Tensor  # [B, R]
    offsets: torch.Tensor  # [B, R] (residuals included)
    weights: torch.Tensor  # [B, R]; 0 for padding rows
    row_ids: torch.Tensor  # [B, R] int32; 0 for padding rows
    proj: torch.Tensor  # [B, S] int32 feature id per slot; -1 pad
    penalty_mask: torch.Tensor  # [B, S]
    valid_mask: torch.Tensor  # [B, S]
    intercept_slots: torch.Tensor  # [B] int32; -1 if none

    @property
    def num_entities(self) -> int:
        return self.entity_codes.shape[0]

    @property
    def sub_dim(self) -> int:
        return self.proj.shape[-1]

    @property
    def is_dense(self) -> bool:
        return self.x_indices is None


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """One size bucket in lazy form: plan indices plus the raw tensors
    the slab is gathered from. Plan leaves are numpy on the host plan
    and tensors after ``RandomEffectDataset.device_plans``."""

    entity_codes: object  # [B] int32
    row_ids: object  # [B, R] int32 canonical rows; 0 for padding
    row_counts: object  # [B] int32 kept rows per entity
    proj: object  # [B, S] int32 sorted feature ids; -1 pads trail
    intercept_slots: object  # [B] int32; -1 if none
    raw: Features
    raw_labels: torch.Tensor  # [n]
    raw_offsets: torch.Tensor  # [n] base offsets
    raw_weights: torch.Tensor  # [n]

    @property
    def num_entities(self) -> int:
        return self.entity_codes.shape[0]

    @property
    def sub_dim(self) -> int:
        return self.proj.shape[-1]

    def materialize(self, residuals: torch.Tensor | None = None
                    ) -> EntityBlocks:
        """Gather the bucket's training slabs on the device. ``offsets``
        include ``residuals`` when given."""
        b, r = self.row_ids.shape
        s = self.proj.shape[-1]
        dev = self.raw_labels.device
        dtype = self.raw_weights.dtype
        rows = self.row_ids.long()
        row_mask = (torch.arange(r, device=dev)[None, :]
                    < self.row_counts[:, None])
        zero = torch.zeros((), dtype=dtype, device=dev)
        labels = self.raw_labels[rows]
        weights = torch.where(row_mask, self.raw_weights[rows], zero)
        offs = self.raw_offsets[rows]
        if residuals is not None:
            offs = offs + residuals[rows]
        offs = torch.where(row_mask, offs, zero)
        proj = self.proj
        valid = (proj >= 0).to(dtype)
        iota_s = torch.arange(s, device=dev)[None, :]
        penalty = torch.where(iota_s == self.intercept_slots[:, None],
                              zero, valid)
        if s > DENSE_SUB_DIM_MAX:
            raise _not_ported(f"the ELL slab layout (sub_dim {s} > "
                              f"{DENSE_SUB_DIM_MAX})")
        if isinstance(self.raw, DenseFeatures):
            d = self.raw.x.shape[1]
            if b * d * s > ONE_HOT_ELEMENT_BUDGET:
                raise _not_ported("the ELL slab layout (over-budget "
                                  "dense bucket)")
            # x[row, proj[slot]]; -1 pad slots and padding rows give 0.
            xv = self.raw.x[rows[:, :, None],
                            proj.clamp(min=0).long()[:, None, :]]
            keep = row_mask[:, :, None] & (proj >= 0)[:, None, :]
            x_values = torch.where(keep, xv, zero)
        else:
            idx = self.raw.indices[rows]  # [B, R, k]
            val = torch.where(row_mask[:, :, None], self.raw.values[rows],
                              zero)
            k = idx.shape[-1]
            if b * r * k * s > ONE_HOT_ELEMENT_BUDGET:
                raise _not_ported("the ELL slab layout (over-budget sparse "
                                  "bucket)")
            onehot = (idx[:, :, :, None] == proj[:, None, None, :]).to(dtype)
            x_values = torch.einsum("brk,brks->brs", val, onehot)
        return EntityBlocks(
            entity_codes=self.entity_codes,
            x_indices=None,
            x_values=x_values,
            labels=labels,
            offsets=offs,
            weights=weights,
            row_ids=torch.where(row_mask, self.row_ids,
                                torch.zeros_like(self.row_ids)),
            proj=proj,
            penalty_mask=penalty,
            valid_mask=valid,
            intercept_slots=self.intercept_slots,
        )


_PLAN_FIELDS = ("entity_codes", "row_ids", "row_counts", "proj",
                "intercept_slots")


@dataclasses.dataclass(frozen=True)
class RandomEffectDataset:
    """All state of one random-effect coordinate. Lazy: ``blocks`` holds
    the host plan; the ``*_device``/``device_*`` accessors place what
    they return on ``score_codes.device`` once and cache it.
    Materialized: ``blocks`` are ``EntityBlocks`` on the device and rows
    score through ``score_indices``/``score_values`` plus the tail."""

    config: RandomEffectDataConfiguration
    num_entities: int
    entity_keys: tuple  # code -> raw entity key
    blocks: tuple  # BlockPlan per bucket, numpy plan leaves
    max_sub_dim: int
    sub_dims: np.ndarray  # [E]
    proj_all: np.ndarray  # [E, max_sub_dim] int64 feature ids; -1 pad
    num_features: int
    dtype: torch.dtype
    score_codes: torch.Tensor  # [n] int32 owning-entity code per row
    raw: Features | None  # lazy: the raw shard the slabs gather from
    block_codes_np: tuple  # per bucket [B] int32
    block_intercepts_np: tuple  # per bucket [B] int32
    covered_np: np.ndarray  # [n] bool: row kept into some bucket
    score_inv_np: np.ndarray | None  # lazy: [n] int32 flat score position
    # Materialized scoring table: [n, k] subspace slots and values (0
    # outside the subspace), then the COO tail of rows wider than
    # ``score_table_width_cap`` (rows ascending; None when uncapped).
    score_indices: torch.Tensor | None = None
    score_values: torch.Tensor | None = None
    score_tail_rows: torch.Tensor | None = None  # [t] int32
    score_tail_indices: torch.Tensor | None = None  # [t] int32
    score_tail_values: torch.Tensor | None = None  # [t]
    # Most tail entries of one row: the tail reduce's multiplicity bound.
    score_tail_mult: int | None = None
    # Per bucket the gram route's (grad_mult, hess_mult) window bounds,
    # or None where the route cannot engage; empty for lazy datasets.
    block_gram_mults: tuple = ()

    @property
    def num_rows(self) -> int:
        return int(self.score_codes.shape[0])

    @property
    def device(self) -> torch.device:
        return self.score_codes.device

    @property
    def is_lazy(self) -> bool:
        return self.score_indices is None

    def _cached(self, name: str, build):
        value = self.__dict__.get(name)
        if value is None:
            value = build()
            object.__setattr__(self, name, value)
        return value

    def device_plans(self) -> tuple:
        """``blocks`` with device plan tensors (cached); a materialized
        dataset's blocks as they are."""
        if not self.is_lazy:
            return self.blocks
        dev = self.device

        def build():
            return tuple(
                dataclasses.replace(b, **{
                    f: torch.from_numpy(np.asarray(getattr(b, f))).to(dev)
                    for f in _PLAN_FIELDS
                })
                for b in self.blocks
            )

        return self._cached("_device_plans", build)

    def device_blocks(self) -> tuple:
        """Training blocks with their slabs gathered once on the device
        (cached) while the total stays within the slab budget; a bucket
        past it stays a ``BlockPlan`` and gathers inside every solve.
        A materialized dataset's blocks are already on the device."""
        if not self.is_lazy:
            return self.blocks

        def build():
            out, spent = [], 0
            itemsize = torch.empty((), dtype=self.dtype).element_size()
            for b in self.device_plans():
                bb, r = b.row_ids.shape
                s = b.proj.shape[-1]
                k_raw = (b.raw.indices.shape[1]
                         if isinstance(b.raw, SparseFeatures)
                         else b.raw.x.shape[1])
                slab = max(itemsize * bb * r * s,
                           (itemsize + 4) * bb * r * min(k_raw, s))
                if spent + slab <= _DEVICE_SLAB_BUDGET_BYTES:
                    spent += slab
                    b = b.materialize(None)
                out.append(b)
            return tuple(out)

        return self._cached("_device_blocks", build)

    def score_inv_device(self) -> torch.Tensor:
        """[n] int64 inverse score map on the device (cached)."""
        return self._cached(
            "_score_inv", lambda: torch.from_numpy(
                self.score_inv_np.astype(np.int64)).to(self.device))

    def proj_device(self) -> torch.Tensor:
        """[E, max_sub_dim] int32 projector table on the device (cached)."""
        return self._cached(
            "_proj_dev", lambda: torch.from_numpy(
                self.proj_all.astype(np.int32)).to(self.device))

    def covered_row_partition(self):
        """(covered [n] bool, passive rows int32), both host arrays, of a
        lazy dataset."""
        if not self.is_lazy:
            raise ValueError("the row partition is defined for lazy "
                             "datasets")
        return self._cached(
            "_covered", lambda: (
                self.covered_np,
                np.nonzero(~self.covered_np)[0].astype(np.int32)))

    def real_entity_mask(self, block_index: int) -> np.ndarray:
        return self.block_codes_np[block_index] < self.num_entities


# ---------------------------------------------------------------------------
# host planner
# ---------------------------------------------------------------------------


def _stable_type_seed(re_type: str) -> np.uint64:
    """64-bit seed from the REType name (the reference XORs
    REType.hashCode into the sample key, RandomEffectDataset.scala:510)."""
    return np.uint64(zlib.crc32(re_type.encode()) | (0x9E3779B9 << 32))


def _byteswap64_mix(uids: np.ndarray, seed: np.uint64) -> np.ndarray:
    """splitmix64-style hash of sample ids: a fixed pseudo-random order
    over samples, reproducible across re-ingests."""
    z = uids.astype(np.uint64) ^ seed
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _pearson_select(values, indices, labels, active_features, keep,
                    intercept_index, num_features) -> np.ndarray:
    """Keep an entity's ``keep`` features of largest |Pearson corr| with
    the label; the intercept is always kept
    (LocalDataset.filterFeaturesByPearsonCorrelationScore :103)."""
    if keep >= active_features.size:
        return active_features
    r = labels.shape[0]
    pos = np.full(num_features, -1, dtype=np.int64)
    pos[active_features] = np.arange(active_features.size)
    sub = pos[indices]
    valid = (values != 0.0) & (sub >= 0)
    rows = np.broadcast_to(np.arange(r)[:, None], indices.shape)
    cols = np.zeros((r, active_features.size), dtype=np.float64)
    cols[rows[valid], sub[valid]] = values[valid]
    y = labels.astype(np.float64)
    yc = y - y.mean()
    xc = cols - cols.mean(axis=0, keepdims=True)
    num = xc.T @ yc
    den = np.sqrt((xc * xc).sum(axis=0) * (yc * yc).sum()) + 1e-12
    score = np.abs(num / den)
    if intercept_index is not None and pos[intercept_index] >= 0:
        score[pos[intercept_index]] = np.inf
    order = np.argsort(-score, kind="stable")[:keep]
    return np.sort(active_features[order])


@dataclasses.dataclass(frozen=True)
class _ProjectorTable:
    """Flat per-entity subspace projectors: ``keys`` is
    ``entity * stride + feature`` for every pair, sorted, so one
    ``searchsorted`` maps any pair to its slot."""

    keys: np.ndarray  # [total] int64
    offsets: np.ndarray  # [E + 1] int64
    stride: int
    num_entities: int

    @property
    def sub_dims(self) -> np.ndarray:
        return np.diff(self.offsets)

    def lookup(self, codes: np.ndarray, feats: np.ndarray):
        """(entity, feature) -> (slot, found); negative codes never
        match."""
        codes = np.broadcast_to(codes, feats.shape)
        keys = (np.maximum(codes, 0).astype(np.int64) * self.stride
                + feats.astype(np.int64))
        if self.keys.size == 0:
            z = np.zeros(feats.shape, dtype=np.int64)
            return z, np.zeros(feats.shape, dtype=bool)
        pos = np.searchsorted(self.keys, keys)
        pos_c = np.minimum(pos, self.keys.size - 1)
        found = (self.keys[pos_c] == keys) & (codes >= 0)
        slot = pos_c - self.offsets[np.maximum(codes, 0)]
        return np.where(found, slot, 0), found

    @staticmethod
    def from_lists(projs: list, stride: int) -> "_ProjectorTable":
        e = len(projs)
        sizes = np.array([p.size for p in projs], dtype=np.int64)
        offsets = np.zeros(e + 1, dtype=np.int64)
        np.cumsum(sizes, out=offsets[1:])
        if e and offsets[-1]:
            ids = np.repeat(np.arange(e, dtype=np.int64), sizes)
            keys = ids * stride + np.concatenate(
                [p.astype(np.int64) for p in projs if p.size])
        else:
            keys = np.empty(0, dtype=np.int64)
        return _ProjectorTable(keys, offsets, stride, e)


@dataclasses.dataclass
class _Plan:
    codes: np.ndarray  # [n] int64 owning entity per row
    perm: np.ndarray  # [n] rows sorted by (entity, reservoir hash)
    starts: np.ndarray  # [E] start of each entity's sorted span
    counts: np.ndarray  # [E] kept (reservoir-capped) rows per entity
    active: np.ndarray  # [E] bool: the entity trains a model
    table: _ProjectorTable
    proj_all: np.ndarray  # [E, S] feature ids, -1 pad
    sub_dims: np.ndarray  # [E]
    max_sub_dim: int
    intercept_slots_all: np.ndarray  # [E] int32; -1 none
    bucket_members: dict  # cap -> entity codes (ascending)
    num_features: int


def _plan_random_effect(game_data: GameDataset,
                        config: RandomEffectDataConfiguration, *,
                        intercept_index: int | None,
                        extra_features: dict | None) -> _Plan:
    """The vectorized host planning pass (module docstring, stage 1)."""
    tag = game_data.id_tags[config.random_effect_type]
    codes = tag.host_codes().astype(np.int64, copy=False)
    num_entities = tag.num_groups
    n = codes.shape[0]
    ell_idx, ell_val, num_features = game_data.host_shard_coo(
        config.feature_shard_id)
    labels_np = game_data.host_column("labels")
    uids = (game_data.uids.astype(np.int64) if game_data.uids is not None
            else np.arange(n, dtype=np.int64))

    # 1. Deterministic reservoir cap: each entity keeps the
    # active_data_upper_bound rows with the smallest hash keys.
    counts_full = np.bincount(codes, minlength=num_entities).astype(
        np.int64, copy=False)
    upper = config.active_data_upper_bound
    lower = config.active_data_lower_bound
    if upper is not None and bool(counts_full.max(initial=0) > upper):
        seed = _stable_type_seed(config.random_effect_type)
        order_keys = _byteswap64_mix(uids, seed)
        # (code, high hash bits) packed into one int64 sorts as one
        # stable radix sort; ties fall back to row order.
        code_bits = max(int(num_entities - 1).bit_length(), 1)
        if code_bits <= 40:
            hash_bits = 63 - code_bits
            key = (codes << hash_bits) | (
                order_keys >> np.uint64(64 - hash_bits)).astype(np.int64)
            perm = np.argsort(key, kind="stable")
        else:
            perm = np.lexsort((order_keys, codes))
    else:
        sort_codes = (codes.astype(np.int32)
                      if num_entities <= (1 << 31) - 1 else codes)
        perm = np.argsort(sort_codes, kind="stable")
    sorted_codes = codes[perm]
    starts = np.searchsorted(sorted_codes, np.arange(num_entities))
    counts = counts_full if upper is None else np.minimum(counts_full, upper)
    rank_sorted = (np.arange(n, dtype=np.int64)
                   - np.repeat(starts, counts_full)
                   if n else np.empty(0, dtype=np.int64))
    keep_sorted = (np.ones(n, dtype=bool) if upper is None
                   else rank_sorted < upper)
    # Too-small entities train no model (their rows still score).
    active = counts >= (lower or 1)

    # 2. Per-entity subspace projectors.
    stride = num_features
    for arr in (extra_features or {}).values():
        a = np.asarray(arr)
        if a.size:
            stride = max(stride, int(a.max()) + 1)
    proj_mask = keep_sorted & active[sorted_codes]
    rows_p = perm[proj_mask]
    pair_codes = sorted_codes[proj_mask]
    dense_view = isinstance(
        game_data.feature_shards[config.feature_shard_id], DenseFeatures)
    if rows_p.size and dense_view:
        # Dense shards: the active-feature union is a [E, d] presence
        # matrix, one segment-OR over the entity-grouped kept rows.
        if rows_p.size * 2 > ell_val.shape[0]:
            present = (ell_val != 0.0)[rows_p]
        else:
            present = ell_val[rows_p] != 0.0
        presence = np.zeros((num_entities, ell_val.shape[1]), dtype=bool)
        if present.all():
            presence[np.unique(pair_codes)] = True
        else:
            m = rows_p.shape[0]
            seg_starts = np.searchsorted(pair_codes, np.arange(num_entities))
            seg_ends = np.append(seg_starts[1:], m)
            nonempty = seg_starts < seg_ends
            if nonempty.any():
                presence[nonempty] = np.logical_or.reduceat(
                    present, seg_starts[nonempty], axis=0)
        rows_e, cols_f = np.nonzero(presence)
        uniq = rows_e.astype(np.int64) * np.int64(stride) + cols_f
    elif rows_p.size:
        iv = ell_idx[rows_p]
        present = ell_val[rows_p] != 0.0
        pair_keys = (
            np.broadcast_to(pair_codes[:, None], iv.shape)[present]
            * np.int64(stride) + iv[present].astype(np.int64))
        uniq = np.unique(pair_keys)
    else:
        uniq = np.empty(0, dtype=np.int64)

    if extra_features or config.features_to_samples_ratio is not None:
        e_of = uniq // stride
        f_of = uniq % stride
        e_starts = np.searchsorted(e_of, np.arange(num_entities))
        e_ends = np.searchsorted(e_of, np.arange(num_entities), side="right")
        projs = [f_of[e_starts[e]:e_ends[e]] for e in range(num_entities)]
        ratio = config.features_to_samples_ratio
        for e in np.nonzero(active)[0]:
            act = projs[e]
            if ratio is not None:
                rows_e = perm[starts[e]:starts[e] + counts[e]]
                keep = max(int(ratio * rows_e.size), 1)
                act = _pearson_select(
                    ell_val[rows_e], ell_idx[rows_e], labels_np[rows_e],
                    act, keep, intercept_index, num_features)
            # A warm-start model's support stays in the subspace.
            if extra_features and e in extra_features:
                act = np.union1d(
                    act, np.asarray(extra_features[e], dtype=act.dtype))
            projs[e] = act
        table = _ProjectorTable.from_lists(projs, stride)
    else:
        offsets = np.zeros(num_entities + 1, dtype=np.int64)
        offsets[1:] = np.searchsorted(uniq // stride,
                                      np.arange(num_entities), side="right")
        table = _ProjectorTable(uniq, offsets, stride, num_entities)

    sub_dims = table.sub_dims
    max_sub_dim = max(int(sub_dims.max()) if num_entities else 1, 1)
    proj_all = np.full((num_entities, max_sub_dim), -1, dtype=np.int64)
    if table.keys.size:
        row_of = np.repeat(np.arange(num_entities), sub_dims)
        col_of = np.arange(table.keys.size) - np.repeat(
            table.offsets[:-1], sub_dims)
        proj_all[row_of, col_of] = table.keys % stride
    if intercept_index is not None and num_entities:
        slots, found = table.lookup(
            np.arange(num_entities),
            np.full(num_entities, intercept_index, dtype=np.int64))
        intercept_slots_all = np.where(found, slots, -1).astype(np.int32)
    else:
        intercept_slots_all = np.full(num_entities, -1, dtype=np.int32)

    # 3. Size-bucket membership.
    bucket_members = _assign_buckets(counts, active, config.bucket_caps,
                                     config.min_bucket_entities)
    return _Plan(codes=codes, perm=perm, starts=starts, counts=counts,
                 active=active, table=table, proj_all=proj_all,
                 sub_dims=sub_dims, max_sub_dim=max_sub_dim,
                 intercept_slots_all=intercept_slots_all,
                 bucket_members=bucket_members, num_features=num_features)


def _assign_buckets(counts: np.ndarray, active: np.ndarray,
                    bucket_caps: tuple, min_bucket_entities: int = 0) -> dict:
    """cap -> member entity codes (ascending). Entities above the
    largest cap round up to a power of two. With ``min_bucket_entities``
    an undersized bucket merges upward into the next occupied cap; the
    largest bucket never merges."""
    caps = np.asarray(sorted(bucket_caps), dtype=np.int64)
    active_ids = np.nonzero(active)[0]
    r = counts[active_ids]
    pos = np.searchsorted(caps, r)
    pow2 = np.left_shift(
        np.int64(1),
        np.ceil(np.log2(np.maximum(r, 1).astype(np.float64))).astype(
            np.int64))
    cap_of = np.where(pos < caps.size,
                      caps[np.minimum(pos, caps.size - 1)], pow2)
    members = {int(c): active_ids[cap_of == c] for c in np.unique(cap_of)}
    floor = int(min_bucket_entities or 0)
    if floor > 0 and len(members) > 1:
        occupied = sorted(members)
        merged: dict = {}
        pending = None
        for i, cap in enumerate(occupied):
            ids = members[cap]
            if pending is not None:
                ids = np.union1d(pending, ids)
                pending = None
            if ids.size < floor and i < len(occupied) - 1:
                pending = ids
            else:
                merged[cap] = ids
        members = merged
    return members


def _bucket_rows(plan: _Plan, members: np.ndarray):
    """(rows_flat, t_of, r_of, counts_b): the kept canonical rows of the
    member entities, grouped by entity in reservoir order, with their
    (bucket slot, within-entity rank) coordinates."""
    m_starts = plan.starts[members]
    m_counts = plan.counts[members]
    total = int(m_counts.sum())
    if total == 0:
        empty = np.empty(0, dtype=np.int64)
        return empty, empty.copy(), empty.copy(), m_counts
    t_of = np.repeat(np.arange(members.size, dtype=np.int64), m_counts)
    span_base = np.cumsum(m_counts) - m_counts
    r_of = np.arange(total, dtype=np.int64) - span_base[t_of]
    rows_flat = plan.perm[m_starts[t_of] + r_of]
    return rows_flat, t_of, r_of, m_counts


def _compact_left(slot: np.ndarray, val: np.ndarray, found: np.ndarray,
                  k_out: int):
    """Left-compact each row's found ELL entries; truncate or pad to
    ``k_out`` columns."""
    order = np.argsort(~found, axis=1, kind="stable")
    slot_c = np.take_along_axis(np.where(found, slot, 0), order, axis=1)
    val_c = np.take_along_axis(np.where(found, val, 0.0), order, axis=1)
    k = slot_c.shape[1]
    if k_out > k:
        slot_c = np.pad(slot_c, ((0, 0), (0, k_out - k)))
        val_c = np.pad(val_c, ((0, 0), (0, k_out - k)))
    return slot_c[:, :k_out].astype(np.int32), val_c[:, :k_out]


def _score_table_arrays(codes: np.ndarray, ell_idx: np.ndarray,
                        ell_val: np.ndarray, table: _ProjectorTable,
                        width_cap: int | None):
    """The materialized score table of every row: (si, sv, tail). Each
    row's entries inside its entity's subspace, remapped to slots and
    left-compacted; with ``width_cap`` the entries past the cap go to a
    COO tail ``(rows, slots, values)`` sorted by row (None when
    uncapped)."""
    slot, found = table.lookup(codes[:, None], ell_idx)
    found = found & (ell_val != 0.0)
    k_comp = max(int(found.sum(axis=1).max(initial=0)), 1)
    if width_cap is None:
        si, sv = _compact_left(slot, ell_val, found, k_comp)
        return si, sv, None
    k_slab = max(min(width_cap, k_comp), 1)
    si_f, sv_f = _compact_left(slot, ell_val, found, k_comp)
    si, sv = si_f[:, :k_slab], sv_f[:, :k_slab]
    over_i, over_v = si_f[:, k_slab:], sv_f[:, k_slab:]
    mask = over_v != 0.0
    if mask.any():
        row_of = np.broadcast_to(
            np.arange(codes.shape[0], dtype=np.int64)[:, None], mask.shape)
        tr = row_of[mask]
        ti = over_i[mask].astype(np.int64)
        tv = over_v[mask]
        o = np.argsort(tr, kind="stable")  # the tail reduce wants sorted rows
        tail = (tr[o], ti[o], tv[o])
    else:
        tail = (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, ell_val.dtype))
    return si, sv, tail


def _gram_window_bounds(bi: np.ndarray, bv: np.ndarray, sub_dim: int):
    """HOST (grad_mult, hess_mult) window bounds of one bucket's ELL
    slabs for the gram route, or None when the route can never engage
    there (the bucket densifies up front, or its pair pass is over
    budget). Only nonzero entries count: the device side sends zero
    products to the drop segment."""
    b, cap, k = bi.shape
    s = int(sub_dim)
    if s <= DENSE_SUB_DIM_MAX and b * cap * k * s <= ONE_HOT_ELEMENT_BUDGET:
        return None
    if b * cap * k * k > segment_reduce.GRAM_ELEMENT_BUDGET:
        return None
    nz = bv != 0.0
    grad_counts = hess_counts = None
    # Entity chunks bound the [chunk, cap, k, k] int64 pair ids.
    step = max(1, (1 << 22) // max(cap * k * k, 1))
    for lo in range(0, b, step):
        hi = min(lo + step, b)
        ent = np.arange(lo, hi, dtype=np.int64)[:, None, None]
        nzc = nz[lo:hi]
        bic = bi[lo:hi].astype(np.int64)
        gids = (ent * s + bic)[nzc]
        gc = segment_reduce.window_counts_np(gids, b * s)
        grad_counts = gc if grad_counts is None else grad_counts + gc
        pair_nz = nzc[:, :, :, None] & nzc[:, :, None, :]
        pids = (ent[..., None] * (s * s) + bic[:, :, :, None] * s
                + bic[:, :, None, :])[pair_nz]
        hc = segment_reduce.window_counts_np(pids, b * s * s)
        hess_counts = hc if hess_counts is None else hess_counts + hc
    return (segment_reduce.window_bound_from_counts(grad_counts.max()),
            segment_reduce.window_bound_from_counts(hess_counts.max()))


def build_random_effect_dataset(
    game_data: GameDataset,
    config: RandomEffectDataConfiguration,
    *,
    intercept_index: int | None = None,
    extra_features: dict | None = None,
    lazy: bool | None = None,
) -> RandomEffectDataset:
    """Plan one random-effect coordinate on the host and build its
    dataset on ``game_data``'s device. ``extra_features`` maps an entity
    code to feature ids that must stay in its subspace (a warm-start
    model's support, RandomEffectDataset.scala:390-426). ``lazy`` picks
    the layout; by default it is lazy unless the configuration sets
    ``score_table_width_cap`` or a subspace is wider than
    ``DENSE_SUB_DIM_MAX``."""
    feats = game_data.feature_shards[config.feature_shard_id]
    plan = _plan_random_effect(game_data, config,
                               intercept_index=intercept_index,
                               extra_features=extra_features)
    if lazy is None:
        # A width cap says heavy entities dominate max_sub_dim: the lazy
        # scorer's [n, S] gathers would bring back what the cap bounds.
        # Wide subspaces stay materialized too.
        lazy = (config.score_table_width_cap is None
                and plan.max_sub_dim <= DENSE_SUB_DIM_MAX)
    tag = game_data.id_tags[config.random_effect_type]
    n = plan.codes.shape[0]

    bucket_host = []
    covered = np.zeros(n, dtype=bool)
    for cap in sorted(plan.bucket_members):
        members = plan.bucket_members[cap]
        rows_flat, t_of, r_of, counts_b = _bucket_rows(plan, members)
        brow = np.zeros((members.size, cap), dtype=np.int32)
        brow[t_of, r_of] = rows_flat
        s = max(int(plan.sub_dims[members].max(initial=0)), 1)
        bucket_host.append(dict(
            members=members.astype(np.int32), brow=brow,
            counts=counts_b.astype(np.int32),
            proj=plan.proj_all[members][:, :s].astype(np.int32),
            intercepts=plan.intercept_slots_all[members],
            rows_flat=rows_flat, t_of=t_of, r_of=r_of))
        covered[rows_flat] = True
    common = dict(
        config=config,
        num_entities=tag.num_groups,
        entity_keys=tag.inverse,
        max_sub_dim=plan.max_sub_dim,
        sub_dims=plan.sub_dims,
        proj_all=plan.proj_all,
        num_features=plan.num_features,
        dtype=game_data.dtype,
        block_codes_np=tuple(bh["members"] for bh in bucket_host),
        block_intercepts_np=tuple(bh["intercepts"] for bh in bucket_host),
        covered_np=covered,
    )
    if not lazy:
        return _build_materialized(game_data, config, plan, bucket_host,
                                   common)

    score_inv = np.empty(n, dtype=np.int32)
    base = 0
    for bh in bucket_host:
        cap = bh["brow"].shape[1]
        score_inv[bh["rows_flat"]] = (
            base + bh["t_of"] * cap + bh["r_of"]).astype(np.int32)
        base += bh["brow"].size
    passive = np.nonzero(~covered)[0]
    if base + passive.size >= 2**31:
        raise OverflowError(
            f"flat score layout has {base + passive.size} elements, which "
            "overflows the int32 inverse score map")
    score_inv[passive] = base + np.arange(passive.size, dtype=np.int32)
    blocks = tuple(
        BlockPlan(
            entity_codes=bh["members"],
            row_ids=bh["brow"],
            row_counts=bh["counts"],
            proj=bh["proj"],
            intercept_slots=bh["intercepts"],
            raw=feats,
            raw_labels=game_data.labels,
            raw_offsets=game_data.offsets,
            raw_weights=game_data.weights,
        )
        for bh in bucket_host)
    return RandomEffectDataset(blocks=blocks, score_codes=tag.codes,
                               raw=feats, score_inv_np=score_inv, **common)


def _build_materialized(game_data: GameDataset,
                        config: RandomEffectDataConfiguration, plan: _Plan,
                        bucket_host: list, common: dict
                        ) -> RandomEffectDataset:
    """The materialized layout: each bucket's ELL blocks remapped to
    subspace slots on the host and copied to the device, and the score
    table with its tail."""
    dev, dtype = game_data.device, game_data.dtype
    ell_idx, ell_val, _ = game_data.host_shard_coo(config.feature_shard_id)
    labels_np = game_data.host_column("labels")
    offsets_np = game_data.host_column("offsets")
    weights_np = game_data.host_column("weights")

    def put(a: np.ndarray, to=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, to)

    blocks, gram_mults = [], []
    for bh in bucket_host:
        members = bh["members"]
        b, cap = bh["brow"].shape
        rows_flat, t_of, r_of = bh["rows_flat"], bh["t_of"], bh["r_of"]
        s = bh["proj"].shape[1]
        wi, wv = ell_idx[rows_flat], ell_val[rows_flat]
        slot, found = plan.table.lookup(plan.codes[rows_flat][:, None], wi)
        found = found & (wv != 0.0)
        k = max(int(found.sum(axis=1).max(initial=0)), 1)
        ri, rv = _compact_left(slot, wv, found, k)
        bi = np.zeros((b, cap, k), dtype=np.int32)
        bv = np.zeros((b, cap, k), dtype=ell_val.dtype)
        bi[t_of, r_of] = ri
        bv[t_of, r_of] = rv
        gram_mults.append(_gram_window_bounds(bi, bv, s))
        bl = np.zeros((b, cap), dtype=labels_np.dtype)
        bo = np.zeros((b, cap), dtype=offsets_np.dtype)
        bw = np.zeros((b, cap), dtype=weights_np.dtype)
        bl[t_of, r_of] = labels_np[rows_flat]
        bo[t_of, r_of] = offsets_np[rows_flat]
        bw[t_of, r_of] = weights_np[rows_flat]
        bint = bh["intercepts"]
        valid = (np.arange(s)[None, :]
                 < plan.sub_dims[members][:, None]).astype(np.float32)
        penalty = valid.copy()
        has_int = bint >= 0
        penalty[has_int, bint[has_int]] = 0.0
        blocks.append(EntityBlocks(
            entity_codes=put(members),
            x_indices=put(bi),
            x_values=put(bv, dtype),
            labels=put(bl, dtype),
            offsets=put(bo, dtype),
            weights=put(bw, dtype),
            row_ids=put(bh["brow"]),
            proj=put(bh["proj"]),
            penalty_mask=put(penalty, dtype),
            valid_mask=put(valid, dtype),
            intercept_slots=put(bint),
        ))

    si, sv, tail = _score_table_arrays(
        plan.codes, ell_idx, ell_val, plan.table,
        config.score_table_width_cap)
    tail_arrays = dict(score_tail_rows=None, score_tail_indices=None,
                       score_tail_values=None, score_tail_mult=None)
    if tail is not None:
        tail_arrays = dict(
            score_tail_rows=put(tail[0].astype(np.int32)),
            score_tail_indices=put(tail[1].astype(np.int32)),
            score_tail_values=put(tail[2], dtype),
            # Tail rows are sorted: one bincount prices the widest row.
            score_tail_mult=(int(np.bincount(tail[0]).max())
                             if tail[0].size else 1),
        )
    return RandomEffectDataset(
        blocks=tuple(blocks),
        score_codes=put(plan.codes.astype(np.int32)),
        raw=None,
        score_inv_np=None,
        score_indices=put(si),
        score_values=put(sv, dtype),
        block_gram_mults=tuple(gram_mults),
        **tail_arrays,
        **common,
    )
