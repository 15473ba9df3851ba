"""GameEstimator: the fit() API of GAME training (port of
``photon_tpu/estimators/game_estimator.py``).

``fit`` builds the per-coordinate datasets once (the random-effect plan
is the expensive host step, cached across the configs of a sequence),
then runs one coordinate descent per optimization configuration, each
warm-started from the previous one's model (GameEstimator.scala:452-468).
The first is seeded by ``initial_model``, remapped onto this data's
entity vocabulary and subspaces.

With validation data every update is evaluated and each configuration
returns its best model by the primary evaluator; ``select_best`` picks
across configurations (GameTrainingDriver.scala:753-793). A
``TrainingCheckpointer`` commits a recovery point after every outer
iteration, and ``resume`` restarts from one.

The random-effect coordinates plan concurrently and reach the device in
one packed transfer (``data/pipeline.py``).

``listeners`` (callables taking an ``events`` event) receive a
``CoordinateUpdateEvent`` per coordinate update and a ``FitEndEvent``
per configuration. With telemetry on, ``prepare`` and each
``fit/config:<i>`` are spans. A configuration with no validation,
checkpointer, resume or non-finite guard runs the whole-fit fused
program (``algorithm.fused_fit.FusedFit``: one CUDA-graph replay a fit
on the card, captured once per static structure and warm-start twin and
cached in ``_fused_cache``) unless ``fuse_ineligibility_reasons`` names
a reason (listeners, down-sampling, fixed-effect box constraints,
materialized random-effect datasets); every other fit runs the unfused
``CoordinateDescent``. With telemetry and the cost ledger both on, a
fused fit books ``fused_fit`` and ``materialize`` rows (its own
accounting), and an unfused fit its updates' windows to per-coordinate
``coordinate_descent`` rows, the rest of its wall to the
``unattributed`` row and its slabs' resident bytes
(``algorithm.coordinate_descent.FitLedgerFeed``: one sync a fit on the
card); the validation rescoring of a (re)loaded model is booked under
``eval/score`` and ``eval/suite``.

``evaluate_model`` scores any ``GameModel`` (a serving generation, a
candidate) on validation data through the same scorers and metrics a
fit records; its ``score_sink`` hands the evaluated scores and labels
to a host consumer such as ``obs.health.calibration_sink``.

``precision="bfloat16"`` trains with the reference's mixed-precision
policy (``ops/precision.py``, reference :311-319): random-effect slabs
stored bf16, solver state in the labels' dtype, f32 accumulators, and in
the fused fit bf16 score carries; it is part of the fused static key.

An eligible ``prepare`` (no validation, initial model, incremental
training or listener, the pipelined ingest) starts the fused fit's warm
capture before it plans (``_warm_capture``, on the ingest pipeline's
compile pool): the graph of a skeleton generation whose plan shapes the
shape oracle predicts, which the first fused fit adopts when the built
shapes match (``FusedFit._consume_aot``). ``prepare`` waits for the
stage at its end, inside the ``compile_wait`` stage (the part its
planning did not hide): a capture in flight breaks if any thread
synchronizes the whole device or flushes the allocator's cache, so none
outlives the call. A failing warm stage is logged and counted
(``compile_cache.cache_stats()["aot_failures"]``); the fit then captures
at its first run. A fit that does not take the fused program drops the
artifact first.

``mesh`` (default ``"auto"``: every rank of the ``torch.distributed``
process group when one is up with more than one rank, as the
reference's default spans every device) trains data- and
entity-parallel (``parallel/mesh.py``): ``prepare`` gives each rank its
share of every fixed-effect batch's rows and of every random-effect
bucket's entities, validation scorers score a share of the rows each,
and every model, score and evaluation is the same, bit for bit, on
every rank. A mesh fit runs the unfused loop with the reference's
reason, and no warm capture. Only rank 0 writes a checkpoint; the
others wait for it at a barrier. A ``DualEllFeatures`` fixed effect
stays whole on every rank. A fixed effect with ``feature_sharding``
``"column"`` (or ``"auto"`` above ``AUTO_COLUMN_SHARDING_THRESHOLD``
features, where normalization or a DualEll tail does not block it) is
sharded over its FEATURE axis on a mesh instead
(``parallel.mesh.FeatureShardedSparse``): each rank holds its feature
range of the features, the coefficients and the optimizer's state, the
rows whole, and the solved slices are gathered into one whole model.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import os
import time
from collections import OrderedDict
from typing import Union

import numpy as np
import torch

from photon_tpu_torch import device as device_mod
from photon_tpu_torch import obs
from photon_tpu_torch.algorithm.coordinate import FixedEffectCoordinate
from photon_tpu_torch.algorithm.coordinate_descent import (
    CoordinateDescent,
    CoordinateDescentResult,
    FitLedgerFeed,
    ValidationContext,
)
from photon_tpu_torch.algorithm.problems import (
    GLMOptimizationConfiguration,
    GLMOptimizationProblem,
)
from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_tpu_torch.data.dataset import DualEllFeatures, GLMBatch
from photon_tpu_torch.data.game_data import GameDataset
from photon_tpu_torch.data.pipeline import PIPELINE_STATS, packable
from photon_tpu_torch.data.random_effect import (
    PendingRandomEffectDataset,
    RandomEffectDataConfiguration,
    RandomEffectDataset,
    _plan_arrays_to_device,
    build_random_effect_dataset,
)
from photon_tpu_torch.evaluation.evaluators import EvaluatorSpec
from photon_tpu_torch.evaluation.suite import EvaluationResults
from photon_tpu_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    remap_random_effect_model,
)
from photon_tpu_torch.ops import precision as precision_mod
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.parallel.mesh import (
    SITE_CHECKPOINT_BARRIER,
    resolve_mesh,
    shard_batch,
    shard_features_by_column,
    shard_random_effect_dataset,
)
from photon_tpu_torch.resilience import checkpoint as ckpt_mod
from photon_tpu_torch.resilience.errors import ResumeMismatchError
from photon_tpu_torch.transformers import (
    evaluation_suite,
    fixed_effect_scorer,
    random_effect_scorer,
)
from photon_tpu_torch.types import TaskType

logger = logging.getLogger(__name__)

# Program contracts (``python -m photon_tpu_torch.analysis --semantic``):
# the fused cache's static key (a lambda grid is one entry; an optimizer
# swap or a precision switch another), and the unfused coordinate update,
# whose ops are the same set for any lambda and warm start. The unfused
# solvers branch on the host by design; each sync is one their counters
# count, and the check holds the syncs it sees to those counters.
PROGRAM_AUDIT = [
    dict(
        name="fused-cache-key",
        entry="estimators.game_estimator.GameEstimator._fused_for "
        "(fused_static_key discipline)",
        builder="build_fused_cache_keys",
        max_programs=1,
        stable_under=("lambda_grid",),
        recompiles_on=("optimizer_swap", "precision"),
    ),
    dict(
        name="unfused-coordinate-update",
        entry="algorithm.problems.run_impl (via GLMOptimizationProblem.run)",
        builder="build_unfused_update",
        max_programs=1,
        stable_under=("lambda_grid", "warm_start"),
        recompiles_on=("optimizer_swap",),
        hot_loop=True,
        host_syncs=(
            "photon_tpu_torch.optim.lbfgs:host_syncs",
            "photon_tpu_torch.optim.batched:host_syncs",
            "photon_tpu_torch.algorithm.random_effect:host_syncs",
        ),
        host_sync_reason=(
            "the unfused loop's L-BFGS branches on the host (one fetch a "
            "line-search probe and two an iteration) and its batched "
            "solvers ask whether a lane still runs once a step: the "
            "fused fit's graph is the sync-free route"),
        port_differs={
            "program": "an eager program (its set of distinct ops): "
            "eager dispatch compiles nothing per call",
            "host_syncs": "declared: the reference's jitted update has "
            "no host boundary",
        },
    ),
]

# Feature count above which "auto" feature sharding goes column-wise on a
# mesh (the reference's threshold, index/FeatureIndexingDriver.scala:40-41).
AUTO_COLUMN_SHARDING_THRESHOLD = 200_000

# Fused whole-fit programs kept per estimator. Each pins its captured
# graphs (and their memory pools); the slabs are shared across entries
# through the generation's ``_fused_mat_share``, so the bound limits
# graphs, not slab memory.
_FUSED_CACHE_SIZE = 8

# The primary evaluator of each task when none is configured
# (GameEstimator.scala:673 prepareValidationEvaluators).
_DEFAULT_EVALUATOR = {
    TaskType.LOGISTIC_REGRESSION: "AUC",
    TaskType.LINEAR_REGRESSION: "RMSE",
    TaskType.POISSON_REGRESSION: "POISSON_LOSS",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: "AUC",
}


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinateConfiguration:
    """FixedEffectDataConfiguration plus its optimization config.
    ``feature_sharding`` is the coefficients' placement on a mesh, as
    the reference names it: ``"replicated"`` (rows sharded, the
    coefficients on every rank), ``"column"`` or ``"auto"`` (column
    above ``AUTO_COLUMN_SHARDING_THRESHOLD`` features); without a mesh
    every mode is replicated."""

    feature_shard_id: str
    optimization: GLMOptimizationConfiguration = dataclasses.field(
        default_factory=GLMOptimizationConfiguration)
    feature_sharding: str = "replicated"

    def __post_init__(self):
        if self.feature_sharding not in ("replicated", "column", "auto"):
            raise ValueError(
                f"feature_sharding must be 'replicated', 'column' or "
                f"'auto', got {self.feature_sharding!r}")


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinateConfiguration:
    """RandomEffectDataConfiguration plus its optimization config."""

    data: RandomEffectDataConfiguration
    optimization: GLMOptimizationConfiguration = dataclasses.field(
        default_factory=GLMOptimizationConfiguration)


CoordinateConfiguration = Union[FixedEffectCoordinateConfiguration,
                                RandomEffectCoordinateConfiguration]


def _resolve_pending(out: dict, device) -> dict:
    """Place every deferred build: the builds whose arrays the int32
    buffer carries share ONE packed transfer, each finalized on its
    view; the others (float64 materialized builds) copy on their own."""
    pending = {cid: d for cid, d in out.items()
               if isinstance(d, PendingRandomEffectDataset)}
    packed = {cid: p for cid, p in pending.items()
              if all(packable(a) for a in p.flat)}
    if packed:
        all_flat: list = []
        spans = {}
        for cid, p in packed.items():
            spans[cid] = (len(all_flat), len(all_flat) + len(p.flat))
            all_flat.extend(p.flat)
        devs = _plan_arrays_to_device(all_flat, device)
        for cid, p in packed.items():
            out[cid] = p.finalize(devs.view(*spans[cid]))
    for cid, p in pending.items():
        if cid not in packed:
            out[cid] = p.finalize(_plan_arrays_to_device(p.flat, device))
    return out


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
    """One (configuration, trained model) pair of the config sequence.
    ``descent`` and ``seconds`` are None for a configuration rebuilt from
    its checkpoint on resume."""

    model: GameModel  # the best-by-validation model of the descent
    config: dict
    evaluation: EvaluationResults | None
    descent: CoordinateDescentResult | None
    # Host seconds of the descent (it syncs at every validation).
    seconds: float | None = None


class GameEstimator:
    """Reference: estimators/GameEstimator.scala:55. ``coordinate_configs``
    is ordered; its key order is the default update sequence. Training
    runs on ``device`` (default ``cuda``: this rank's card under a
    launcher), which must be the device of the ``GameDataset`` passed
    to ``fit``; ``mesh`` is a ``parallel.mesh.resolve_mesh`` setting."""

    def __init__(
        self,
        task: TaskType,
        coordinate_configs: dict,
        *,
        update_sequence: list | None = None,
        num_iterations: int = 1,
        normalization: dict | None = None,
        intercept_indices: dict | None = None,
        evaluators: list[str | EvaluatorSpec] | None = None,
        locked_coordinates: set | None = None,
        incremental_training: bool = False,
        non_finite_guard: bool = False,
        precision: str = "float32",
        device=None,
        listeners=None,
        mesh="auto",
    ):
        self.device = device_mod.resolve(device)
        self.mesh = mesh
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
        self.evaluators = list(evaluators or [])
        self.locked_coordinates = set(locked_coordinates or ())
        self.incremental_training = incremental_training
        self.non_finite_guard = bool(non_finite_guard)
        self.precision = precision_mod.resolve(precision)
        # Training-event fan-out (EventEmitter.scala:24 for the GAME
        # path): None without listeners.
        self.emitter = None
        if listeners:
            from photon_tpu_torch.events import EventEmitter

            self.emitter = EventEmitter(listeners)
        self._fit_cache = None
        self._fused_cache = None
        self._fused_mat_share = None
        self._aot_future = None

    def resolve_mesh(self):
        """The ``mesh`` setting as a ``Mesh`` or None (resolved once)."""
        if not hasattr(self, "_resolved_mesh"):
            self._resolved_mesh = resolve_mesh(self.mesh, device=self.device)
        return self._resolved_mesh

    def _shard_norm(self, shard: str) -> NormalizationContext:
        return self.normalization.get(shard, NormalizationContext())

    def _fixed_effect_batch(self, data: GameDataset, cid: str, cfg, mesh):
        """A fixed-effect coordinate's batch: on a mesh, this rank's
        share of its rows (``shard_batch``), or the whole batch for a
        ``DualEllFeatures`` shard, which is not row-aligned (reference
        :401-410)."""
        if mesh is not None and self._wants_column_sharding(data, cfg):
            return self._build_column_sharded_batch(data, cfg, mesh)
        batch = data.shard_batch(cfg.feature_shard_id)
        if mesh is None:
            return batch
        if isinstance(batch.features, DualEllFeatures):
            logger.info("coordinate %s: DualEll features are not "
                        "row-shardable; leaving replicated", cid)
            return batch
        return shard_batch(batch, mesh)

    def _wants_column_sharding(self, data: GameDataset, cfg) -> bool:
        """``feature_sharding`` on a mesh: ``column`` always; ``auto``
        above ``AUTO_COLUMN_SHARDING_THRESHOLD`` features unless a
        blocker keeps it replicated (logged; an explicit ``column``
        raises at the blocker instead). Reference :470-489."""
        mode = cfg.feature_sharding
        if mode == "column":
            return True
        if mode == "auto":
            feats = data.feature_shards[cfg.feature_shard_id]
            if feats.num_features <= AUTO_COLUMN_SHARDING_THRESHOLD:
                return False
            why = self._column_sharding_blocker(data, cfg.feature_shard_id)
            if why is not None:
                logger.info(
                    "shard %s: auto feature sharding staying replicated "
                    "(%s)", cfg.feature_shard_id, why)
                return False
            return True
        return False

    def _column_sharding_blocker(self, data: GameDataset,
                                 shard: str) -> str | None:
        """Why ``shard`` can't go column-sharded, or None if it can."""
        norm = self.normalization.get(shard)
        if norm is not None and not norm.is_identity:
            return "feature normalization is active"
        if data.host_shard_tail(shard) is not None:
            return "DualEll overflow tail present"
        return None

    def _build_column_sharded_batch(self, data: GameDataset, cfg, mesh):
        """The feature-axis-sharded (tp) fixed-effect batch: this rank's
        feature range of the shard's entries (``shard_features_by_column``,
        built from the host ELL view), the rows whole, with no row mesh:
        the row sums stay local (reference :502-530)."""
        shard = cfg.feature_shard_id
        why = self._column_sharding_blocker(data, shard)
        if why is not None:
            raise ValueError(
                f"coordinate shard {shard!r}: column feature sharding is "
                f"unsupported here ({why}); normalize at ingest / raise the "
                "DualEll slab width cap, or use replicated sharding")
        idx, val, d = data.host_shard_coo(shard)
        feats = shard_features_by_column(idx, val, d, mesh,
                                         dtype=data.labels.dtype)
        return GLMBatch(feats, data.labels, data.offsets, data.weights)

    def _build_datasets(self, data: GameDataset,
                        initial_model: GameModel | None) -> dict:
        """The per-coordinate datasets. A prior model's per-entity
        feature support joins the subspaces
        (RandomEffectDataset.scala:390-426), so its coefficients keep
        their slots under warm start.

        The random-effect coordinates plan concurrently on the ingest
        pipeline's plan pool (each planner's row passes and buckets on
        the chunk pool, ``data/pipeline.py``); the results are collected
        in the dict order, so the plans are bit-identical to the serial
        path. No pool thread makes a CUDA call: every build defers its
        placement, and all of them reach the device afterwards in one
        packed transfer. ``PHOTON_TPU_SERIAL_INGEST=1`` restores the
        in-line path.

        On a mesh each fixed-effect batch is this rank's share of the
        rows and each random-effect dataset this rank's share of every
        bucket's entities, once placed (``parallel/mesh.py``)."""
        from photon_tpu_torch.data import pipeline
        from photon_tpu_torch.resilience import faults

        mesh = self.resolve_mesh()

        def build_one(cid: str, cfg):
            # A planner thunk dying on the plan pool propagates through
            # consume_futures.
            faults.check("ingest.plan")
            if not isinstance(cfg, RandomEffectCoordinateConfiguration):
                return self._fixed_effect_batch(data, cid, cfg, mesh)
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
            return build_random_effect_dataset(
                data, cfg.data,
                intercept_index=self.intercept_indices.get(
                    cfg.data.feature_shard_id),
                extra_features=extra,
                defer_transfer=True,
            )

        futs = {
            cid: pipeline.plan_executor.submit(build_one, cid, cfg)
            for cid, cfg in self.coordinate_configs.items()
            if isinstance(cfg, RandomEffectCoordinateConfiguration)
        }
        planned = dict(zip(futs, pipeline.consume_futures(futs.values())))
        out = {cid: planned[cid] if cid in planned else build_one(cid, cfg)
               for cid, cfg in self.coordinate_configs.items()}
        out = _resolve_pending(out, self.device)
        if mesh is not None:
            for cid, ds in out.items():
                if isinstance(ds, RandomEffectDataset):
                    out[cid] = shard_random_effect_dataset(ds, mesh)
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

    def _build_validation(self, datasets: dict,
                          validation: GameDataset) -> ValidationContext:
        """The validation suite in the labels' dtype and one scorer per
        coordinate over the training datasets' entity layouts
        (prepareValidationDatasetAndEvaluators, :649-673). On a mesh
        each scorer scores a share of the rows a rank and gathers them
        (reference :805-845)."""
        mesh = self.resolve_mesh()
        suite = evaluation_suite(
            validation, self.evaluators or [_DEFAULT_EVALUATOR[self.task]])
        scorers = {}
        for cid, cfg in self.coordinate_configs.items():
            if isinstance(cfg, RandomEffectCoordinateConfiguration):
                ds = datasets[cid]
                scorers[cid] = random_effect_scorer(
                    validation,
                    re_type=cfg.data.random_effect_type,
                    feature_shard_id=cfg.data.feature_shard_id,
                    entity_keys=ds.entity_keys,
                    proj_all=ds.proj_all,
                    width_cap=cfg.data.score_table_width_cap,
                    mesh=mesh,
                )
            else:
                scorers[cid] = fixed_effect_scorer(
                    validation, cfg.feature_shard_id, mesh)
        return ValidationContext(suite=suite, scorers=scorers)

    @staticmethod
    def _score_with_validation(val_ctx: ValidationContext,
                               model: GameModel,
                               score_sink=None) -> EvaluationResults:
        """Evaluate a (re)loaded model on the validation data. With the
        cost ledger on, each coordinate's scoring is booked under
        ``eval/score`` and the suite under ``eval/suite`` (host windows:
        nothing waits for the card).

        ``score_sink`` (optional) receives the evaluated scores (the
        model's scores plus the offsets, as the suite judged them) and
        the labels as host numpy, after the metrics: both come back in
        one device-to-host copy, after the suite's own sync."""
        from photon_tpu_torch.obs import ledger

        armed = ledger.enabled()
        total = None
        for cid, m in model.items():
            t0 = time.perf_counter() if armed else 0.0
            vs = val_ctx.scorers[cid](m)
            total = vs if total is None else total + vs
            if armed:
                t1 = time.perf_counter()
                ledger.record_dispatch("eval/score", t1 - t0, phase="eval",
                                       coordinate=cid, start=t0, end=t1)
        t0 = time.perf_counter() if armed else 0.0
        out = val_ctx.suite.evaluate(total)
        if armed:
            t1 = time.perf_counter()
            ledger.record_dispatch("eval/suite", t1 - t0, phase="eval",
                                   start=t0, end=t1)
        if score_sink is not None:
            suite = val_ctx.suite
            host = torch.stack((suite._z(total), suite.labels)).cpu()
            z, labels = host.numpy()
            score_sink(z, labels)
        return out

    def evaluate_model(self, model: GameModel, data: GameDataset,
                       validation: GameDataset, *,
                       initial_model: GameModel | None = None,
                       score_sink=None) -> EvaluationResults:
        """Evaluate any ``GameModel`` (a serving generation, a
        candidate) on ``validation`` with this estimator's evaluators:
        the scorers and metric path a ``fit(validation=...)`` run
        records, so two models are compared by one ruler.

        ``data`` gives the per-coordinate layouts the scorers map onto
        (the dataset the candidate trained on); pass the fit's
        ``initial_model`` to reuse ``prepare``'s cache. A random-effect
        model whose entity vocabulary or projectors differ from the
        layout's is remapped by (entity key, feature id) first: entities
        the layout lacks score through the fixed effect alone.
        ``score_sink`` receives the evaluated host scores and labels
        (``_score_with_validation``)."""
        datasets, val_ctx = self.prepare(
            data, validation=validation, initial_model=initial_model)
        if val_ctx is None:
            raise ValueError("evaluate_model needs a validation dataset")
        for cid in self.update_sequence:
            if cid not in model:
                continue
            m = model[cid]
            if not isinstance(m, RandomEffectModel):
                continue
            ds = datasets[cid]
            if (tuple(str(k) for k in m.entity_keys)
                    != tuple(str(k) for k in ds.entity_keys)
                    or not np.array_equal(np.asarray(m.proj_all),
                                          np.asarray(ds.proj_all))):
                model = model.updated(cid, remap_random_effect_model(
                    m, entity_keys=ds.entity_keys, proj_all=ds.proj_all))
        return self._score_with_validation(val_ctx, model,
                                           score_sink=score_sink)

    def _full_config(self, opt_configs: dict) -> dict:
        return {cid: opt_configs.get(
            cid, self.coordinate_configs[cid].optimization)
            for cid in self.update_sequence}

    def _rebuild_completed_config(self, checkpointer, resume, i,
                                  opt_configs, val_ctx) -> GameFitResult:
        """A configuration completed before the interruption: its best
        model from the retained config-final checkpoint, its evaluation
        by rescoring that model."""
        model = ckpt_mod.load_config_final(
            self._checkpoint_directory(checkpointer, resume), i,
            resume.static_key, self.device)
        return GameFitResult(
            model=model, config=self._full_config(opt_configs),
            evaluation=(self._score_with_validation(val_ctx, model)
                        if val_ctx is not None else None),
            descent=None)

    def _finalize_from_checkpoint(self, checkpointer, resume, i,
                                  opt_configs, val_ctx) -> GameFitResult:
        """The crash window after a configuration's last-iteration
        checkpoint but before its config-final artifact: the descent
        finished, so the result comes from the chain (the retained best,
        else the checkpoint's model), and the missing config-final is
        written so later resumes take the normal path."""
        best_model = None
        if val_ctx is not None:
            best_model = ckpt_mod.load_config_best(
                self._checkpoint_directory(checkpointer, resume), i,
                resume.static_key, self.device)
        if best_model is None:
            best_model = resume.model
        logger.info(
            "GameEstimator: config %d completed its descent before the "
            "interruption but never retained its final artifact; "
            "finalizing it from the checkpoint chain", i)
        result = GameFitResult(
            model=best_model, config=self._full_config(opt_configs),
            evaluation=(self._score_with_validation(val_ctx, best_model)
                        if val_ctx is not None else None),
            descent=None)
        if checkpointer is not None:
            self._coordinated_write(lambda: checkpointer.save_config_final(
                best_model, config_index=i))
        return result

    def _coordinated_write(self, write) -> None:
        """A checkpoint write, on rank 0 alone on a mesh (the models are
        the same on every rank); the other ranks wait for it at a
        barrier, so none reads a checkpoint before it is committed."""
        mesh = self.resolve_mesh()
        if mesh is None or mesh.is_coordinator:  # photon: ignore[spmd-host-divergence] -- rank 0 writes the file alone; every rank then meets the same barrier
            write()
        if mesh is not None:
            mesh.barrier(site=SITE_CHECKPOINT_BARRIER)

    @staticmethod
    def _checkpoint_directory(checkpointer, resume) -> str:
        return (checkpointer.directory if checkpointer is not None
                else os.path.dirname(resume.path))

    def prepare(self, data: GameDataset,
                validation: GameDataset | None = None,
                initial_model: GameModel | None = None):
        """Build (or reuse, for the same objects) the per-coordinate
        datasets of ``data`` and the validation context; returns
        ``(datasets, val_ctx)``, ``val_ctx`` None without validation."""
        for ds in (data, validation):
            if ds is not None and ds.device != self.device:
                raise ValueError(f"the dataset is on {ds.device} but the "
                                 f"estimator trains on {self.device}")
        key = (data, initial_model, validation)
        if self._fit_cache is not None and all(
                a is b for a, b in zip(self._fit_cache[0], key)):
            return self._fit_cache[1]
        self._fit_cache = None
        # A new generation: every fused program and the shared slabs
        # are stale together (and would pin the old device arrays).
        self._fused_cache = None
        self._fused_mat_share = None
        from photon_tpu_torch.data import pipeline

        # A superseded warm artifact is dropped here, on the calling
        # thread (its graph frees memory, which no capture may meet).
        self._drop_warm()
        # The raw data's transfer (and a streamed dataset's window
        # copies and assembly) were recorded when the dataset was built,
        # before this prepare: they survive the reset.
        PIPELINE_STATS.reset(keep=("raw_transfer", "stream_transfer",
                                   "stream_assemble"))
        if self._warm_capture_eligible(validation, initial_model):
            self._aot_future = pipeline.compile_executor.submit(
                self._warm_capture, data)
        with obs.span("prepare"):
            datasets = self._build_datasets(data, initial_model)
            val_ctx = (self._build_validation(datasets, validation)
                       if validation is not None else None)
            if self._aot_future is not None:
                # The warm stage's remainder, past the planning.
                with PIPELINE_STATS.stage("compile_wait"):
                    concurrent.futures.wait([self._aot_future])
        self._fit_cache = (key, (datasets, val_ctx))
        return datasets, val_ctx

    def _fused_for(self, coords, datasets):
        """The fused whole-fit program for this coordinate structure, or
        None when ``fuse_ineligibility_reasons`` names a reason. Cached
        per (dataset generation, static key) in a small LRU: a lambda
        grid replays the same graphs with new weights, and a grid that
        alternates static keys round-robins among cached programs."""
        from photon_tpu_torch.algorithm.fused_fit import (
            FusedFit,
            fuse_ineligibility_reasons,
            fused_static_key,
        )

        if fuse_ineligibility_reasons(coords, mesh=self.resolve_mesh(),
                                      emitter=self.emitter):
            return None
        key = fused_static_key(coords, self.update_sequence,
                               self.num_iterations,
                               self.locked_coordinates, self.precision)
        cache, share = self._fused_cache, self._fused_mat_share
        if (cache is None or share is None
                or share["datasets"] is not datasets):
            cache = self._fused_cache = OrderedDict()
            share = self._fused_mat_share = {"datasets": datasets}
        fused = cache.get(key)
        if fused is not None:
            cache.move_to_end(key)
            return self._attach_aot(fused)
        fused = FusedFit(coords, self.update_sequence, self.num_iterations,
                         self.locked_coordinates, mat_share=share,
                         precision=self.precision)
        fused.static_key = key
        cache[key] = fused
        while len(cache) > _FUSED_CACHE_SIZE:
            cache.popitem(last=False)
        return self._attach_aot(fused)

    def _attach_aot(self, fused):
        """Hand prepare's pending warm capture to the fused program,
        whose first run takes it (``FusedFit._consume_aot``)."""
        if self._aot_future is not None and fused._aot_future is None:
            fused._aot_future, self._aot_future = self._aot_future, None
        return fused

    def _drop_warm(self) -> None:
        """Drop a warm artifact no fused fit will take, on this thread
        (waiting for it, if a caller cut a prepare short)."""
        fut, self._aot_future = self._aot_future, None
        if fut is not None and not fut.cancel():
            fut.result()

    def _warm_capture_eligible(self, validation, initial_model) -> bool:
        """Whether ``prepare`` starts the warm capture: exactly the
        reference's reasons (:698-718). It targets the first fit of a
        validation-free ``fit``; a listener, an initial model (whose
        support changes the subspace shapes) or incremental training
        make it useless by construction, the serial ingest has no pool
        to run it on, and a mesh fit runs unfused."""
        from photon_tpu_torch.data import pipeline

        return (validation is None and initial_model is None
                and not self.incremental_training
                and self.emitter is None
                and not pipeline.serial_ingest()
                and self.resolve_mesh() is None)

    def _warm_capture(self, data: GameDataset) -> dict | None:
        """The warm stage, on the compile pool (reference
        ``_warm_compile``, :720-803): skeleton datasets at the shapes the
        oracle predicts stand in for the coordinates, and inside the
        ``compile`` stage the fused program of their static key is
        built and, on the card, its graph captured
        (``FusedFit.warm``, through ``compile_cache.aot_capture``).
        Returns ``{"key", "statics", "captured"}``, or None where the
        oracle or the fused path declines or the stage failed (logged
        and counted; the first fit then captures)."""
        from photon_tpu_torch.algorithm.fused_fit import (
            FusedFit,
            fuse_ineligibility_reasons,
            fused_static_key,
        )
        from photon_tpu_torch.data.random_effect import (
            skeleton_random_effect_dataset,
        )
        from photon_tpu_torch.utils import compile_cache

        # The skeletons and the eligibility come before the ``compile``
        # stage: a declined prediction leaves compile_seconds at 0.
        try:
            skeleton: dict = {}
            for cid, cfg in self.coordinate_configs.items():
                if isinstance(cfg, RandomEffectCoordinateConfiguration):
                    ds = skeleton_random_effect_dataset(data, cfg.data)
                    if ds is None:
                        return None
                    skeleton[cid] = ds
                else:
                    if self._wants_column_sharding(data, cfg):
                        return None  # reference :762-763
                    skeleton[cid] = data.shard_batch(cfg.feature_shard_id)
            coords = self._build_coordinates(skeleton, {}, {})
            if fuse_ineligibility_reasons(coords, emitter=self.emitter):
                return None
            fused = FusedFit(coords, self.update_sequence,
                             self.num_iterations, self.locked_coordinates,
                             precision=self.precision)
            key = fused_static_key(coords, self.update_sequence,
                                   self.num_iterations,
                                   self.locked_coordinates, self.precision)
        except Exception as exc:  # noqa: BLE001 — the stage is best-effort
            compile_cache.record_failure()
            logger.warning("warm capture skipped: %r", exc, exc_info=True)
            return None
        try:
            with PIPELINE_STATS.stage("compile"):
                built = compile_cache.aot_capture(
                    lambda: fused.warm(coords, self.device),
                    ledger_key="fused_fit/fit")
        except Exception as exc:  # noqa: BLE001 — counted by aot_capture
            logger.warning("warm capture failed; the first fit captures: "
                           "%r", exc, exc_info=True)
            return None
        return {"key": key, **built}

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
            validation: GameDataset | None = None,
            opt_config_sequence: list | None = None,
            initial_model: GameModel | None = None, *,
            init_model=None, checkpointer=None, resume=None) -> list:
        """Train one GAME model per optimization configuration; each
        config warm-starts from the previous config's model.

        ``init_model`` is the day-over-day form of ``initial_model``: a
        ``GameModel`` or the path of a native ``.npz`` checkpoint; pass
        at most one of the two. ``checkpointer`` (a
        ``TrainingCheckpointer``) commits a recovery point after every
        outer iteration; ``resume`` (a loaded ``TrainingCheckpoint``)
        restarts from one. Its static key must match this estimator and
        config sequence (``ResumeMismatchError``); completed configs are
        rebuilt from their retained artifacts and the interrupted one
        continues at its next iteration with the same seeds.
        """
        if init_model is not None:
            if initial_model is not None:
                raise ValueError(
                    "pass exactly one of initial_model / init_model")
            if isinstance(init_model, str):
                from photon_tpu_torch.io.model_io import load_initial_model

                init_model, digest = load_initial_model(
                    init_model, device=self.device)
                logger.info("warm start from init model (digest %s...)",
                            digest[:12])
            initial_model = init_model
        if self.incremental_training:
            self._validate_incremental(initial_model)
        datasets, val_ctx = self.prepare(data, validation, initial_model)
        if opt_config_sequence is None:
            opt_config_sequence = [{}]

        start_config = 0
        resume_iteration = 0
        if resume is not None:
            expected = ckpt_mod.training_static_key(self,
                                                    opt_config_sequence)
            if resume.static_key != expected:
                raise ResumeMismatchError(
                    "checkpoint was written by a different training "
                    f"configuration (manifest static key "
                    f"{resume.static_key[:12]}..., this run "
                    f"{expected[:12]}...): change the config back, or "
                    "start fresh / warm-start instead of resuming")
            start_config = resume.config_index
            resume_iteration = resume.iteration + 1
            if resume_iteration >= self.num_iterations:
                start_config += 1
                resume_iteration = 0
            if start_config >= len(opt_config_sequence) and (
                    ckpt_mod.has_config_final(
                        self._checkpoint_directory(checkpointer, resume),
                        len(opt_config_sequence) - 1)):
                raise ValueError(
                    "checkpoint records the final configuration's last "
                    "iteration: training already completed; nothing to "
                    "resume")
            # The checkpoint holds the whole mid-descent state.
            initial_model = resume.model

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
        # Crash safety needs a host boundary after every outer iteration
        # (the checkpoint write, the non-finite guard's sync); the fused
        # fit has none until it completes, so these ride the unfused loop.
        needs_host_boundary = (checkpointer is not None or resume is not None
                               or self.non_finite_guard)
        for i, opt_configs in enumerate(opt_config_sequence):
            if i < start_config:
                if (i == resume.config_index
                        and resume.iteration + 1 >= self.num_iterations
                        and not ckpt_mod.has_config_final(
                            self._checkpoint_directory(checkpointer,
                                                       resume), i)):
                    results.append(self._finalize_from_checkpoint(
                        checkpointer, resume, i, opt_configs, val_ctx))
                else:
                    results.append(self._rebuild_completed_config(
                        checkpointer, resume, i, opt_configs, val_ctx))
                continue
            coords = self._build_coordinates(datasets, opt_configs, priors)
            fused = (self._fused_for(coords, datasets)
                     if val_ctx is None and not needs_host_boundary
                     else None)
            if fused is None:
                self._drop_warm()
            cd = CoordinateDescent(
                self.update_sequence, self.num_iterations,
                locked_coordinates=self.locked_coordinates,
                non_finite_guard=self.non_finite_guard,
                emitter=self.emitter)
            initial_models = {}
            if prev_model is not None:
                for cid in self.update_sequence:
                    if cid in prev_model:
                        initial_models[cid] = self._on_layout(
                            prev_model[cid], datasets[cid])
            logger.info("GameEstimator: config %d/%d", i + 1,
                        len(opt_config_sequence))
            # Resuming mid-config with validation: the retained best
            # seeds the tracking, so a pre-crash best is not lost.
            initial_best = None
            if (resume is not None and i == start_config
                    and resume_iteration > 0 and val_ctx is not None):
                best = ckpt_mod.load_config_best(
                    self._checkpoint_directory(checkpointer, resume), i,
                    resume.static_key, self.device)
                if best is not None:
                    initial_best = (
                        best, self._score_with_validation(val_ctx, best))
            on_iteration = None
            if checkpointer is not None:
                # The best commits before the iteration's manifest; it is
                # rewritten only when it changed.
                saved_best = [initial_best[0] if initial_best else None]

                def on_iteration(it, model, best, _ci=i):
                    def write():
                        if best is not None and best is not saved_best[0]:
                            checkpointer.save_best(best, config_index=_ci)
                        checkpointer.save(model, config_index=_ci,
                                          iteration=it)

                    self._coordinated_write(write)
                    if best is not None:
                        saved_best[0] = best
            from photon_tpu_torch.obs import ledger

            # The unfused loop's cost-ledger feed, only with telemetry and
            # the ledger on: off, the fit makes no extra launch, sync or
            # row. A fused fit books its own rows.
            feed = (FitLedgerFeed(self.device)
                    if fused is None and obs.enabled() and ledger.enabled()
                    else None)
            t0 = time.perf_counter()
            with obs.span(f"fit/config:{i}"):
                if fused is not None:
                    descent = fused.run(coords, initial_models or None)
                else:
                    descent = cd.run(
                        coords, initial_models or None, val_ctx,
                        seed=i * self.num_iterations,
                        start_iteration=(resume_iteration
                                         if i == start_config else 0),
                        on_iteration=on_iteration,
                        initial_best=initial_best, ledger_feed=feed)
                if feed is not None:
                    feed.close(slab_bytes=sum(
                        ds.slab_nbytes() for ds in datasets.values()
                        if isinstance(ds, RandomEffectDataset)))
            result = GameFitResult(
                model=descent.best_model,
                config=self._full_config(opt_configs),
                evaluation=descent.best_evaluation,
                descent=descent,
                seconds=time.perf_counter() - t0,
            )
            results.append(result)
            if checkpointer is not None:
                self._coordinated_write(
                    lambda: checkpointer.save_config_final(
                        descent.best_model, config_index=i))
            if self.emitter is not None:
                from photon_tpu_torch.events import FitEndEvent

                self.emitter.send_event(
                    FitEndEvent(config_index=i, result=result))
            prev_model = descent.model
        return results

    def select_best(self, results: list) -> GameFitResult:
        """The best config by the validation primary metric
        (selectBestModel, GameTrainingDriver.scala:753-793); the first
        config without validation."""
        best = results[0]
        for r in results[1:]:
            if r.evaluation is not None and (
                    best.evaluation is None
                    or best.evaluation.primary_evaluator.better_than(
                        r.evaluation.primary_evaluation,
                        best.evaluation.primary_evaluation)):
                best = r
        return best

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
