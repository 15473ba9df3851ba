"""GameTransformer: score new data with a trained GAME model (port of
``photon_tpu/transformers/__init__.py``).

Counterpart of photon-api transformers/GameTransformer.scala:150: model
plus dataset to per-row scores, optionally evaluated. The fixed effects
score by a gather-dot against the dataset's feature tensors; a random
effect joins its entities by key (rows of unseen entities score 0) and
scores straight off the raw shard (dense and ELL shards, subspaces up to
``DENSE_SUB_DIM_MAX`` slots) or through a remapped score table (a
``DualEllFeatures`` shard's tail widens its rows, or rides the table's
COO tail under a width cap). With a ``mesh`` (``parallel/mesh.py``)
each rank scores its share of the rows and the shares are gathered, so
every rank holds every row's score (a table with a COO tail is not
row-aligned: every rank scores it whole).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.data.dataset import DenseFeatures, SparseFeatures
from photon_tpu_torch.data.game_data import GameDataset
from photon_tpu_torch.data.random_effect import (
    DENSE_SUB_DIM_MAX,
    remap_for_scoring,
    scoring_codes,
)
from photon_tpu_torch.evaluation.suite import (
    EvaluationResults,
    EvaluationSuite,
    make_suite,
)
from photon_tpu_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    score_entity_table_with_tail,
    score_raw_features,
)
from photon_tpu_torch.parallel.mesh import (
    Mesh,
    maybe_row_shard,
    shard_features,
)


def _gathered(mesh: Mesh | None, n: int, score):
    """``score`` (model -> scores of this rank's rows) as a scorer of
    every row: the ranks' shares gathered on a mesh."""
    if mesh is None:
        return score
    return lambda m: mesh.gather_rows(score(m), n)


def fixed_effect_scorer(data: GameDataset, feature_shard_id: str,
                        mesh: Mesh | None = None):
    """model -> per-row scores of a fixed-effect sub-model on ``data``;
    on a mesh each rank scores its share of the rows (a
    ``DualEllFeatures`` shard whole, on every rank)."""
    feats = data.feature_shards[feature_shard_id]
    if not isinstance(feats, (DenseFeatures, SparseFeatures)):
        mesh = None
    local = feats if mesh is None else shard_features(feats, mesh)

    def scorer(m: FixedEffectModel) -> torch.Tensor:
        return m.model.coefficients.compute_score(local)

    return _gathered(mesh, data.num_samples, scorer)


def random_effect_scorer(data: GameDataset, *, re_type: str,
                         feature_shard_id: str, entity_keys: tuple,
                         proj_all, width_cap: int | None = None,
                         mesh: Mesh | None = None):
    """model -> per-row scores of a random-effect sub-model on ``data``:
    the lazy path (only the [n] entity codes and the [E, S] projector go
    to the device) for dense and ELL shards up to ``DENSE_SUB_DIM_MAX``
    slots without a width cap, else the remapped score table. On a mesh
    each rank scores its share of the rows, unless the table has a COO
    tail."""
    feats = data.feature_shards[feature_shard_id]
    proj_all = np.asarray(proj_all)
    sub_dim = proj_all.shape[1] if proj_all.ndim == 2 else 0
    n = data.num_samples
    if (width_cap is None and sub_dim <= DENSE_SUB_DIM_MAX
            and isinstance(feats, (DenseFeatures, SparseFeatures))):
        codes = torch.from_numpy(scoring_codes(
            data, re_type, entity_keys).astype(np.int32)).to(data.device)
        proj_dev = torch.from_numpy(
            proj_all.astype(np.int32)).to(data.device)
        if mesh is not None:
            (codes,) = maybe_row_shard(mesh, codes)
            feats = shard_features(feats, mesh)

        def lazy(m: RandomEffectModel) -> torch.Tensor:
            return score_raw_features(m.coefficients, codes, feats, proj_dev)

        return _gathered(mesh, n, lazy)

    codes, idx, vals, tail = remap_for_scoring(
        data, re_type=re_type, feature_shard_id=feature_shard_id,
        entity_keys=entity_keys, proj_all=proj_all, width_cap=width_cap)
    if tail is not None:
        mesh = None
    elif mesh is not None:
        codes, idx, vals = maybe_row_shard(mesh, codes, idx, vals)

    def table(m: RandomEffectModel) -> torch.Tensor:
        return score_entity_table_with_tail(m.coefficients, codes, idx,
                                            vals, tail)

    return _gathered(mesh, n, table)


def make_submodel_scorer(sub_model, data: GameDataset,
                         width_cap: int | None = None,
                         mesh: Mesh | None = None):
    """A scorer for one trained sub-model (GameModel.score's arms)."""
    if isinstance(sub_model, RandomEffectModel):
        return random_effect_scorer(
            data,
            re_type=sub_model.random_effect_type,
            feature_shard_id=sub_model.feature_shard_id,
            entity_keys=sub_model.entity_keys,
            proj_all=sub_model.proj_all,
            width_cap=width_cap,
            mesh=mesh,
        )
    if isinstance(sub_model, FixedEffectModel):
        return fixed_effect_scorer(data, sub_model.feature_shard_id, mesh)
    raise TypeError(f"unknown sub-model type: {sub_model}")


def evaluation_suite(data: GameDataset, evaluators) -> EvaluationSuite:
    """The suite of ``evaluators`` over a dataset's labels, offsets,
    weights and id tags. It runs in the labels' dtype, as the
    reference's does (f32 from the Avro readers), so a metric matches
    the reference's sums, not exact float64 ones."""
    return make_suite(
        evaluators,
        data.labels,
        offsets=data.offsets,
        weights=data.weights,
        group_ids={
            name: (tag.codes, tag.num_groups)
            for name, tag in data.id_tags.items()
        },
        dtype=data.labels.dtype,
    )


def evaluate_scores(data: GameDataset, scores, evaluators
                    ) -> EvaluationResults | None:
    """Evaluate raw model scores against a dataset's labels (the
    GameTransformer validation path :186-192), shared with the batch
    scorer of ``cli/score.py``."""
    if not evaluators:
        return None
    return evaluation_suite(data, evaluators).evaluate(
        torch.as_tensor(scores))


@dataclasses.dataclass(frozen=True)
class GameTransformer:
    """Reference: transformers/GameTransformer.scala (transform
    :150-197). ``mesh`` (a ``parallel.mesh.Mesh`` or None) scores a
    share of the rows a rank; every rank gets every row's score."""

    model: GameModel
    mesh: Mesh | None = None

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(
                f"GameTransformer mesh must be a parallel.mesh.Mesh or "
                f"None, got {type(self.mesh).__name__}")

    def score(self, data: GameDataset) -> torch.Tensor:
        """Summed sub-model scores per row: the raw model contribution,
        without the offset (GameModel.score semantics)."""
        total = None
        for _, m in self.model.items():
            s = make_submodel_scorer(m, data, mesh=self.mesh)(m)
            total = s if total is None else total + s
        if total is None:
            raise ValueError("empty GAME model")
        return total

    def transform(self, data: GameDataset, evaluators=None
                  ) -> tuple[torch.Tensor, EvaluationResults | None]:
        """Score, and evaluate against the dataset's labels when
        ``evaluators`` are given."""
        scores = self.score(data)
        return scores, evaluate_scores(data, scores, evaluators)
