"""GameEstimator: the fit() API of GAME training on one device (port of
``photon_tpu/estimators/game_estimator.py``).

``fit`` builds the per-coordinate datasets once (the random-effect plan
is the expensive host step, cached across the configs of a sequence),
then runs one coordinate descent per optimization configuration, each
warm-started from the previous one's model (GameEstimator.scala:452-468).
The first is seeded by ``initial_model``, remapped onto this data's
entity vocabulary and subspaces.

Waiting (ROADMAP Queue A): mesh execution, checkpoint/resume,
validation and evaluation, streaming ingest, the event emitter, and the
whole-fit fused program (its torch counterpart is a CUDA-graph capture
of a fit).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Union

from photon_tpu_torch import device as device_mod
from photon_tpu_torch import optim
from photon_tpu_torch.algorithm.coordinate import FixedEffectCoordinate
from photon_tpu_torch.algorithm.coordinate_descent import (
    CoordinateDescent,
    CoordinateDescentResult,
)
from photon_tpu_torch.algorithm.problems import (
    GLMOptimizationConfiguration,
    GLMOptimizationProblem,
)
from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_tpu_torch.data.game_data import GameDataset
from photon_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
)
from photon_tpu_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    remap_random_effect_model,
)
from photon_tpu_torch.ops import precision as precision_mod
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.types import TaskType

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinateConfiguration:
    """FixedEffectDataConfiguration plus its optimization config."""

    feature_shard_id: str
    optimization: GLMOptimizationConfiguration = dataclasses.field(
        default_factory=GLMOptimizationConfiguration)


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinateConfiguration:
    """RandomEffectDataConfiguration plus its optimization config."""

    data: RandomEffectDataConfiguration
    optimization: GLMOptimizationConfiguration = dataclasses.field(
        default_factory=GLMOptimizationConfiguration)


CoordinateConfiguration = Union[FixedEffectCoordinateConfiguration,
                                RandomEffectCoordinateConfiguration]


@dataclasses.dataclass(frozen=True)
class _FixedEffectModelAdapter:
    """FixedEffectCoordinate speaks bare GLMs; the GAME loop exchanges
    shard-tagged FixedEffectModels."""

    inner: FixedEffectCoordinate
    feature_shard_id: str

    def train(self, residuals=None, initial_model=None, *, seed: int = 0):
        init = initial_model.model if initial_model is not None else None
        glm, diag = self.inner.train(residuals, init, seed=seed)
        return FixedEffectModel(glm, self.feature_shard_id), diag

    def score(self, model: FixedEffectModel):
        return self.inner.score(model.model)


@dataclasses.dataclass(frozen=True)
class GameFitResult:
    """One (configuration, trained model) pair of the config sequence."""

    model: GameModel
    config: dict
    evaluation: None
    descent: CoordinateDescentResult


class GameEstimator:
    """Reference: estimators/GameEstimator.scala:55. ``coordinate_configs``
    is ordered; its key order is the default update sequence. Training
    runs on ``device`` (default ``cuda``), which must be the device of
    the ``GameDataset`` passed to ``fit``."""

    def __init__(
        self,
        task: TaskType,
        coordinate_configs: dict,
        *,
        update_sequence: list | None = None,
        num_iterations: int = 1,
        normalization: dict | None = None,
        intercept_indices: dict | None = None,
        locked_coordinates: set | None = None,
        incremental_training: bool = False,
        non_finite_guard: bool = False,
        precision: str = "float32",
        device=None,
    ):
        self.device = device_mod.resolve(device)
        self.task = task
        self.coordinate_configs = dict(coordinate_configs)
        self.update_sequence = (list(update_sequence)
                                if update_sequence is not None
                                else list(coordinate_configs))
        for cid in self.update_sequence:
            if cid not in self.coordinate_configs:
                raise KeyError(f"update sequence id {cid!r} has no config")
        self.num_iterations = num_iterations
        self.normalization = dict(normalization or {})
        self.intercept_indices = dict(intercept_indices or {})
        self.locked_coordinates = set(locked_coordinates or ())
        self.incremental_training = incremental_training
        self.non_finite_guard = bool(non_finite_guard)
        self.precision = precision_mod.resolve(precision)
        if precision_mod.is_mixed(self.precision):
            raise optim.not_ported("bf16 training")
        self._fit_cache = None

    def _shard_norm(self, shard: str) -> NormalizationContext:
        return self.normalization.get(shard, NormalizationContext())

    def _build_datasets(self, data: GameDataset,
                        initial_model: GameModel | None) -> dict:
        """The per-coordinate datasets. A prior model's per-entity
        feature support joins the subspaces
        (RandomEffectDataset.scala:390-426), so its coefficients keep
        their slots under warm start."""
        out = {}
        for cid, cfg in self.coordinate_configs.items():
            if not isinstance(cfg, RandomEffectCoordinateConfiguration):
                out[cid] = data.shard_batch(cfg.feature_shard_id)
                continue
            extra = None
            if initial_model is not None and cid in initial_model:
                prior = initial_model[cid]
                if isinstance(prior, RandomEffectModel):
                    tag = data.id_tags[cfg.data.random_effect_type]
                    extra = {}
                    for eo, key in enumerate(prior.entity_keys):
                        code = tag.vocab.get(str(key))
                        if code is not None:
                            p = prior.proj_all[eo]
                            extra[code] = p[p >= 0]
            out[cid] = build_random_effect_dataset(
                data, cfg.data,
                intercept_index=self.intercept_indices.get(
                    cfg.data.feature_shard_id),
                extra_features=extra,
            )
        return out

    def _build_coordinates(self, datasets: dict, opt_configs: dict,
                           priors: dict) -> dict:
        """CoordinateFactory.build (CoordinateFactory.scala:52)."""
        coords = {}
        for cid, cfg in self.coordinate_configs.items():
            opt = opt_configs.get(cid, cfg.optimization)
            if isinstance(cfg, RandomEffectCoordinateConfiguration):
                coords[cid] = RandomEffectCoordinate(
                    datasets[cid], self.task, opt,
                    self._shard_norm(cfg.data.feature_shard_id),
                    prior=priors.get(cid), precision=self.precision)
            else:
                problem = GLMOptimizationProblem(
                    task=self.task, config=opt,
                    normalization=self._shard_norm(cfg.feature_shard_id),
                    intercept_index=self.intercept_indices.get(
                        cfg.feature_shard_id),
                    prior=priors.get(cid))
                coords[cid] = _FixedEffectModelAdapter(
                    FixedEffectCoordinate(datasets[cid], problem),
                    cfg.feature_shard_id)
        return coords

    def prepare(self, data: GameDataset,
                initial_model: GameModel | None = None) -> dict:
        """Build (or reuse, for the same objects) the per-coordinate
        datasets of ``data``."""
        if data.device != self.device:
            raise ValueError(f"the dataset is on {data.device} but the "
                             f"estimator trains on {self.device}")
        key = (data, initial_model)
        if self._fit_cache is not None and all(
                a is b for a, b in zip(self._fit_cache[0], key)):
            return self._fit_cache[1]
        self._fit_cache = None
        datasets = self._build_datasets(data, initial_model)
        self._fit_cache = (key, datasets)
        return datasets

    def _on_layout(self, model, ds):
        """``model`` re-laid onto ``ds`` unless it already shares its
        entity keys and projectors (the within-fit warm start)."""
        if not isinstance(model, RandomEffectModel):
            return model
        if model.entity_keys is ds.entity_keys and model.proj_all is (
                ds.proj_all):
            return model
        return remap_random_effect_model(
            model, entity_keys=ds.entity_keys, proj_all=ds.proj_all)

    def fit(self, data: GameDataset,
            opt_config_sequence: list | None = None,
            initial_model: GameModel | None = None) -> list:
        """Train one GAME model per optimization configuration; each
        config warm-starts from the previous config's model."""
        if self.incremental_training:
            self._validate_incremental(initial_model)
        datasets = self.prepare(data, initial_model)
        if opt_config_sequence is None:
            opt_config_sequence = [{}]
        if initial_model is not None:
            for cid in self.update_sequence:
                if cid in initial_model:
                    initial_model = initial_model.updated(
                        cid, self._on_layout(initial_model[cid],
                                             datasets[cid]))
        priors = {}
        if self.incremental_training:
            for cid in self.update_sequence:
                if cid in self.locked_coordinates:
                    continue
                m = initial_model[cid]
                priors[cid] = (m if isinstance(m, RandomEffectModel)
                               else m.model.coefficients)
        results = []
        prev_model = initial_model
        for i, opt_configs in enumerate(opt_config_sequence):
            coords = self._build_coordinates(datasets, opt_configs, priors)
            cd = CoordinateDescent(
                self.update_sequence, self.num_iterations,
                locked_coordinates=self.locked_coordinates,
                non_finite_guard=self.non_finite_guard)
            initial_models = {}
            if prev_model is not None:
                for cid in self.update_sequence:
                    if cid in prev_model:
                        initial_models[cid] = self._on_layout(
                            prev_model[cid], datasets[cid])
            logger.info("GameEstimator: config %d/%d", i + 1,
                        len(opt_config_sequence))
            descent = cd.run(coords, initial_models or None,
                             seed=i * self.num_iterations)
            results.append(GameFitResult(
                model=descent.best_model,
                config={cid: opt_configs.get(
                    cid, self.coordinate_configs[cid].optimization)
                    for cid in self.update_sequence},
                evaluation=None,
                descent=descent,
            ))
            prev_model = descent.model
        return results

    def _validate_incremental(self, initial_model: GameModel | None) -> None:
        """Incremental-training invariants (GameEstimator.scala:241-382)."""
        if initial_model is None:
            raise ValueError("incremental training is enabled but no initial "
                             "model provided")
        to_train = [c for c in self.update_sequence
                    if c not in self.locked_coordinates]
        missing = [c for c in to_train if c not in initial_model]
        if missing:
            raise ValueError("coordinate sets don't match for incremental "
                             f"training; missing coordinates: "
                             f"{', '.join(missing)}")
        for cid in to_train:
            cfg = self.coordinate_configs[cid]
            m = initial_model[cid]
            if isinstance(cfg, RandomEffectCoordinateConfiguration):
                if not isinstance(m, RandomEffectModel):
                    raise ValueError(f"incremental training error: "
                                     f"coordinate {cid!r} is random-effect "
                                     "but the initial model is not")
                if (m.feature_shard_id != cfg.data.feature_shard_id
                        or m.random_effect_type
                        != cfg.data.random_effect_type):
                    raise ValueError(f"incremental training error: shard or "
                                     f"type mismatch for coordinate {cid!r}")
                if m.variances is None:
                    raise ValueError(f"incremental training error: "
                                     f"coordinate {cid!r} missing variance "
                                     "information")
            else:
                if isinstance(m, RandomEffectModel):
                    raise ValueError(f"incremental training error: "
                                     f"coordinate {cid!r} is fixed-effect "
                                     "but the initial model is random-effect")
                if m.feature_shard_id != cfg.feature_shard_id:
                    raise ValueError(f"incremental training error: feature "
                                     f"shard ID mismatch for coordinate "
                                     f"{cid!r}")
                if m.model.coefficients.variances is None:
                    raise ValueError(f"incremental training error: "
                                     f"coordinate {cid!r} missing variance "
                                     "information")
