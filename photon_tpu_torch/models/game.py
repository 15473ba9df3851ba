"""GAME model objects and the per-row scorers of a random-effect
coordinate (port of ``photon_tpu/models/game.py``).

A random-effect coordinate is one padded ``[E, S]`` coefficient matrix:
entity ``e``'s coefficient for its subspace slot ``s`` sits at
``coefficients[e, s]`` and ``proj_all[e, s]`` names the original feature
id of that slot (-1 pad). Scoring a row gathers its entity's weight row
and projector row by the row's entity code; code -1 (an entity the model
never trained) contributes nothing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.ops import precision as precision_mod
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


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Ordered composite of coordinate sub-models
    (model/GameModel.scala:32); the total score is the sum of the
    coordinates' scores."""

    models: dict

    def __getitem__(self, coordinate_id: str):
        return self.models[coordinate_id]

    def items(self):
        return self.models.items()

    @property
    def task(self) -> TaskType:
        for m in self.models.values():
            return m.task
        raise ValueError("empty GAME model")


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
    dtype and summed in f32. Returns [n] f32."""
    n, d = x.shape
    if w.shape[0] == 0:
        return torch.zeros(n, dtype=torch.float32, device=x.device)
    wrow, prow, known = _gather_rows(w, proj, codes)
    inside = (prow >= 0) & (prow < d)
    xg = torch.gather(x, 1, prow.clamp(0, max(d - 1, 0)))
    xg = torch.where(inside, xg, torch.zeros_like(xg))
    z = precision_mod.acc_sum(
        precision_mod.like_storage(xg, wrow) * wrow, dim=-1
    ).float()
    return z * known.float()


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
    Returns [n] f32."""
    n = indices.shape[0]
    if w.shape[0] == 0:
        return torch.zeros(n, dtype=torch.float32, device=indices.device)
    wrow, prow, known = _gather_rows(w, proj, codes)
    match = (indices.long()[:, :, None] == prow[:, None, :]) & (
        prow[:, None, :] >= 0
    )
    contrib = (values.float()[:, :, None] * match).sum(dim=1)
    z = (
        precision_mod.like_storage(contrib, wrow).float() * wrow.float()
    ).sum(dim=-1)
    return z * known.float()
