"""GAME model objects and the per-row scorers of a random-effect
coordinate (port of ``photon_tpu/models/game.py``).

A random-effect coordinate is one padded ``[E, S]`` coefficient matrix:
entity ``e``'s coefficient for its subspace slot ``s`` sits at
``coefficients[e, s]`` and ``proj_all[e, s]`` names the original feature
id of that slot (-1 pad). Scoring a row gathers its entity's weight row
and projector row by the row's entity code; code -1 (an entity the model
never trained) contributes nothing.

On a lazy training dataset (``RandomEffectModel.score_dataset``) the
rows kept into buckets score from the cached bucket slabs, one batched
product per bucket, and the passive rest from the raw features; one
gather through the dataset's inverse score map puts every score in
canonical row order. On a materialized dataset every row scores through
its remapped score table, and the rows past the table's width cap add
their COO tail through the segment-sum kernel
(``score_entity_table_with_tail``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.data.dataset import DenseFeatures, SparseFeatures
from photon_tpu_torch.data.random_effect import (
    DENSE_SUB_DIM_MAX,
    EntityBlocks,
    RandomEffectDataset,
)
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.ops import precision as precision_mod
from photon_tpu_torch.ops import segment_reduce
from photon_tpu_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """Global GLM plus the feature shard it scores against
    (model/FixedEffectModel.scala:33)."""

    model: GeneralizedLinearModel
    feature_shard_id: str

    @property
    def task(self) -> TaskType:
        return self.model.task


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """All per-entity GLMs of one random-effect type as a padded matrix
    (model/RandomEffectModel.scala:36)."""

    coefficients: torch.Tensor  # [E, S]
    random_effect_type: str
    feature_shard_id: str
    task: TaskType
    proj_all: np.ndarray  # [E, S] original feature ids; -1 pad
    variances: torch.Tensor | None = None  # [E, S]
    entity_keys: tuple = ()

    @property
    def num_entities(self) -> int:
        return self.coefficients.shape[0]

    def score_dataset(self, dataset: RandomEffectDataset) -> torch.Tensor:
        """Model contribution per canonical row of ``dataset``."""
        if not dataset.is_lazy:
            tail = None
            if dataset.score_tail_rows is not None:
                tail = (dataset.score_tail_rows, dataset.score_tail_indices,
                        dataset.score_tail_values)
            return score_entity_table_with_tail(
                self.coefficients, dataset.score_codes,
                dataset.score_indices, dataset.score_values, tail,
                tail_multiplicity=dataset.score_tail_mult)
        z = _score_via_buckets(self.coefficients, dataset)
        if z is not None:
            return z
        return score_raw_features(self.coefficients, dataset.score_codes,
                                  dataset.raw, dataset.proj_device())


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Ordered composite of coordinate sub-models
    (model/GameModel.scala:32); the total score is the sum of the
    coordinates' scores."""

    models: dict

    def __getitem__(self, coordinate_id: str):
        return self.models[coordinate_id]

    def __contains__(self, coordinate_id: str) -> bool:
        return coordinate_id in self.models

    def items(self):
        return self.models.items()

    def updated(self, coordinate_id: str, model) -> "GameModel":
        new = dict(self.models)
        new[coordinate_id] = model
        return GameModel(new)

    @property
    def task(self) -> TaskType:
        for m in self.models.values():
            return m.task
        raise ValueError("empty GAME model")


def _score_dtype(w: torch.Tensor) -> torch.dtype:
    """Scores are f32 for f32 and bf16 tables, f64 for f64 tables."""
    return torch.promote_types(w.dtype, torch.float32)


def _gather_rows(w: torch.Tensor, proj: torch.Tensor, codes: torch.Tensor):
    """Each row's weight and projector rows, gathered at its entity
    code (row 0 for a cold code), and the known-entity mask."""
    known = (codes >= 0) & (codes < w.shape[0])
    safe = torch.where(known, codes, torch.zeros_like(codes)).long()
    return w[safe], proj[safe].long(), known


def _score_raw_dense(
    w: torch.Tensor, codes: torch.Tensor, x: torch.Tensor, proj: torch.Tensor
) -> torch.Tensor:
    """Dense-shard random-effect scores: per row,
    ``sum_s w[code, s] * x[proj[code, s]]``, slots whose projector falls
    outside ``[0, d)`` giving 0. ``x[proj]`` is rounded to the table
    dtype after the exact gather, the product is formed in the table
    dtype and summed in f32. Returns [n] f32 (f64 for an f64 table)."""
    n, d = x.shape
    if w.shape[0] == 0:
        return torch.zeros(n, dtype=_score_dtype(w), device=x.device)
    wrow, prow, known = _gather_rows(w, proj, codes)
    inside = (prow >= 0) & (prow < d)
    xg = torch.gather(x, 1, prow.clamp(0, max(d - 1, 0)))
    xg = torch.where(inside, xg, torch.zeros_like(xg))
    z = precision_mod.acc_sum(
        precision_mod.like_storage(xg, wrow) * wrow, dim=-1
    ).to(_score_dtype(w))
    return z * known.to(z.dtype)


def _score_raw_sparse(
    w: torch.Tensor,
    codes: torch.Tensor,
    indices: torch.Tensor,
    values: torch.Tensor,
    proj: torch.Tensor,
) -> torch.Tensor:
    """ELL-shard random-effect scores: per row and slot,
    ``contrib[s] = sum_k values[k] * [indices[k] == proj[code, s]]`` in
    f32 (duplicate ids add up, pad slots match nothing), rounded to the
    table dtype, then multiplied by the weight in f32 and summed.
    Returns [n] f32 (f64 for an f64 table)."""
    n = indices.shape[0]
    if w.shape[0] == 0:
        return torch.zeros(n, dtype=_score_dtype(w), device=indices.device)
    wrow, prow, known = _gather_rows(w, proj, codes)
    match = (indices.long()[:, :, None] == prow[:, None, :]) & (
        prow[:, None, :] >= 0
    )
    dt = _score_dtype(w)
    contrib = (values.to(dt)[:, :, None] * match).sum(dim=1)
    z = (
        precision_mod.like_storage(contrib, wrow).to(dt) * wrow.to(dt)
    ).sum(dim=-1)
    return z * known.to(dt)


def score_raw_features(w: torch.Tensor, codes: torch.Tensor, feats,
                       proj_dev: torch.Tensor) -> torch.Tensor:
    """Scores straight off the raw feature tensors (every row)."""
    if isinstance(feats, DenseFeatures):
        return _score_raw_dense(w, codes, feats.x, proj_dev)
    if isinstance(feats, SparseFeatures):
        return _score_raw_sparse(w, codes, feats.indices, feats.values,
                                 proj_dev)
    raise TypeError(f"lazy scoring expects Dense or Sparse features, got "
                    f"{type(feats).__name__}")


# Element bound of the one-hot operand in ``score_entity_table``.
_SCORE_ONE_HOT_BUDGET = 1 << 28


def score_entity_table(w: torch.Tensor, codes: torch.Tensor,
                       indices: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """Scores of rows given subspace-remapped ELL arrays:
    ``z_i = sum_j values[i, j] * w[codes[i], indices[i, j]]``, each
    product in the table dtype, summed with an f32 accumulator for a
    bf16 table. Up to ``DENSE_SUB_DIM_MAX`` slots (and a bounded operand)
    the weights are picked by a one-hot contraction, as the reference
    picks them; above, by one gather. Both pick the same values."""
    n, k = indices.shape
    if w.shape[0] == 0:
        return torch.zeros(n, dtype=values.dtype, device=values.device)
    s = w.shape[1]
    if s <= DENSE_SUB_DIM_MAX and n * k * s <= _SCORE_ONE_HOT_BUDGET:
        rows = w[codes.long()]  # [n, S]
        onehot = (indices.long()[:, :, None]
                  == torch.arange(s, device=w.device)).to(rows.dtype)
        picked = torch.einsum("nks,ns->nk", onehot, rows)
    else:
        # rows[i, indices[i, j]] as one flat gather: no [n, S] rows.
        flat = codes.long()[:, None] * s + indices.long()
        picked = w.reshape(-1)[flat]
    return precision_mod.acc_sum(
        precision_mod.like_storage(values, picked) * picked, dim=-1)


def score_tail(w: torch.Tensor, codes: torch.Tensor, tail, num_rows: int,
               tail_multiplicity: int | None = None) -> torch.Tensor:
    """The [num_rows] scores of a width-capped table's COO tail
    ``(rows, slots, values)``, rows sorted ascending, summed by
    ``sorted_segment_sum`` (the kernel on the card; f32 sums for f32 and
    bf16 values). ``tail_multiplicity`` is the most tail entries of one
    row."""
    tr, ti, tv = tail
    flat = codes[tr.long()].long() * w.shape[1] + ti.long()
    picked = w.reshape(-1)[flat]
    contrib = precision_mod.like_storage(tv, picked) * picked
    return segment_reduce.sorted_segment_sum(
        contrib, tr, num_rows, multiplicity=tail_multiplicity or 1,
        site="segment_reduce/score_tail")


def score_entity_table_with_tail(w: torch.Tensor, codes: torch.Tensor,
                                 indices: torch.Tensor, values: torch.Tensor,
                                 tail, tail_multiplicity: int | None = None
                                 ) -> torch.Tensor:
    """``score_entity_table`` plus the scores of a width-capped table's
    COO tail (``score_tail``); ``tail`` is None for an uncapped table."""
    base = score_entity_table(w, codes, indices, values)
    if tail is None or w.shape[0] == 0:
        return base
    summed = score_tail(w, codes, tail, base.shape[0], tail_multiplicity)
    return base + summed.to(base.dtype)


def bucket_score_parts(w: torch.Tensor, slabs, codes) -> list:
    """Per bucket, the flat [B * cap] scores of its slab rows."""
    parts = []
    for xv, cd in zip(slabs, codes):
        idx = cd.long().clamp(0, w.shape[0] - 1)
        we = w[idx][:, :xv.shape[-1]].to(xv.dtype)
        parts.append(
            precision_mod.acc_einsum("brs,bs->br", xv, we).reshape(-1))
    return parts


def passive_raw_scores(w, pr, score_codes, feats, proj_dev) -> torch.Tensor:
    """Raw-feature scores of the passive row subset ``pr``, in the
    coefficients' dtype."""
    codes_p = score_codes[pr]
    if isinstance(feats, DenseFeatures):
        sub = DenseFeatures(feats.x[pr])
    else:
        sub = SparseFeatures(feats.indices[pr], feats.values[pr], feats.d)
    return score_raw_features(w, codes_p, sub, proj_dev).to(w.dtype)


def _gather_score(w, slabs, codes, inv, pr, score_codes, feats, proj_dev):
    """One gather puts the concatenated bucket and passive scores in
    canonical row order."""
    parts = bucket_score_parts(w, slabs, codes)
    if pr is not None:
        parts.append(passive_raw_scores(w, pr, score_codes, feats, proj_dev))
    return torch.cat(parts)[inv].to(w.dtype)


def _score_via_buckets(w: torch.Tensor, ds: RandomEffectDataset):
    """Bucket-slab scoring, or None when a bucket's slab is not cached
    (then every row scores from the raw features)."""
    blocks = ds.device_blocks()
    if not all(isinstance(eb, EntityBlocks) for eb in blocks):
        return None
    _, passive = ds.covered_row_partition()
    if not blocks and not passive.size:
        return torch.zeros(ds.num_rows, dtype=w.dtype, device=w.device)
    pr = (torch.from_numpy(passive.astype(np.int64)).to(w.device)
          if passive.size else None)
    return _gather_score(
        w, tuple(eb.x_values for eb in blocks),
        tuple(p.entity_codes for p in ds.device_plans()),
        ds.score_inv_device(), pr, ds.score_codes, ds.raw,
        ds.proj_device())


def remap_random_effect_model(model: RandomEffectModel, *,
                              entity_keys: tuple,
                              proj_all: np.ndarray) -> RandomEffectModel:
    """Re-lay a model onto another dataset's entity vocabulary and slot
    order, routing each coefficient by (entity key, feature id); what the
    new layout lacks is dropped and what it adds starts at zero
    (RandomEffectCoordinate.scala:200 warm-start semantics)."""
    e_new, s_new = proj_all.shape
    dev = model.coefficients.device
    w_old = model.coefficients.detach().cpu().numpy()
    v_old = (None if model.variances is None
             else model.variances.detach().cpu().numpy())
    w = np.zeros((e_new, s_new), dtype=w_old.dtype)
    v = None if v_old is None else np.zeros((e_new, s_new), w_old.dtype)
    old_vocab = {str(k): i for i, k in enumerate(model.entity_keys)}
    max_feat = 0
    for p in (proj_all, model.proj_all):
        if p.size:
            max_feat = max(max_feat, int(p.max(initial=0)))
    lut = np.full(max_feat + 1, -1, dtype=np.int64)
    for en, key in enumerate(entity_keys):
        eo = old_vocab.get(str(key))
        if eo is None:
            continue
        old_p = model.proj_all[eo]
        old_valid = old_p >= 0
        lut[old_p[old_valid]] = np.nonzero(old_valid)[0]
        new_p = proj_all[en]
        new_valid = new_p >= 0
        src = lut[new_p[new_valid]]
        dst = np.nonzero(new_valid)[0]
        hit = src >= 0
        w[en, dst[hit]] = w_old[eo, src[hit]]
        if v is not None:
            v[en, dst[hit]] = v_old[eo, src[hit]]
        lut[old_p[old_valid]] = -1
    return dataclasses.replace(
        model,
        coefficients=torch.from_numpy(w).to(dev),
        variances=None if v is None else torch.from_numpy(v).to(dev),
        proj_all=proj_all,
        entity_keys=entity_keys,
    )
