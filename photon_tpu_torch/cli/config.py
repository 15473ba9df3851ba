"""The training configuration: a JSON or YAML document to typed configs
(port of ``photon_tpu/cli/config.py``).

Counterpart of the reference's scopt flags and typed coordinate
configurations (io/scopt/ScoptGameTrainingParametersParser.scala:42,
io/CoordinateConfiguration.scala:25-70), in the JAX package's
vocabulary: optimizer, regularization type and its lambda grid, active
data bounds, update sequence, normalization, evaluators, output modes.

JSON always reads. YAML needs PyYAML, imported only for a YAML file.
Every optimizer option of the reference's file runs: TRON (with its
``max_cg_iterations``), ``L1`` and ``ELASTIC_NET`` regularization (with
``alpha``, the L1 fraction), ``variance_computation`` and
``down_sampling_rate``. ``box_constraints``, a ``[lower, upper]`` pair
of numbers or of per-feature lists, goes to L-BFGS-B; the reference's
file reader leaves that key unread. A regularization's
``weight_range`` and ``alpha_range`` are the tuner's search intervals,
and ``hyperparameter_tuning`` (``mode`` NONE, RANDOM or BAYESIAN,
``iterations``, ``seed``) runs the tuner after the lambda grid. An
option the port does not run yet raises ``NotImplementedError`` naming
its ROADMAP item when the file is loaded: ``feature_sharding``
``column`` (item 12's second part). ``mesh`` (default ``auto``) is the
estimator's ``parallel.mesh.resolve_mesh`` setting; a count other than
the process group's size raises when the estimator resolves it.
``profile_dir`` runs the fit under ``torch.profiler``
(``obs.trace.profile_session``) and writes its Chrome trace there.
"""

from __future__ import annotations

import dataclasses
import itertools
import json

from photon_tpu_torch import optim
from photon_tpu_torch.algorithm.problems import (
    GLMOptimizationConfiguration,
    VarianceComputationType,
)
from photon_tpu_torch.data.random_effect import RandomEffectDataConfiguration
from photon_tpu_torch.device import COLUMN_SHARDING_NOT_PORTED
from photon_tpu_torch.estimators.game_estimator import (
    FixedEffectCoordinateConfiguration,
    GameEstimator,
    RandomEffectCoordinateConfiguration,
)
from photon_tpu_torch.ops.normalization import NormalizationType
from photon_tpu_torch.types import TaskType

# The ROADMAP Queue A item of each unported option.
MULTI_DEVICE_ITEM = 12


@dataclasses.dataclass(frozen=True)
class CoordinateSpec:
    """One coordinate's parsed config and its lambda grid, expanded in
    descending order (io/CoordinateConfiguration.scala:62)."""

    config: object  # Fixed/RandomEffectCoordinateConfiguration
    lambdas: tuple[float, ...]

    def expanded(self) -> list[GLMOptimizationConfiguration]:
        base = self.config.optimization
        if not self.lambdas:
            return [base]
        return [base.with_regularization_weight(lam)
                for lam in sorted(self.lambdas, reverse=True)]


def _parse_box(cid: str, box) -> tuple | None:
    """``[lower, upper]``, each a number or a per-feature list."""
    if box is None:
        return None
    if len(box) != 2:
        raise ValueError(f"coordinate {cid!r}: box_constraints must be "
                         f"[lower, upper], got {box!r}")
    return tuple(tuple(float(v) for v in b) if isinstance(b, list)
                 else float(b) for b in box)


def _parse_optimizer(cid: str, d: dict) -> optim.OptimizerConfig:
    kind = optim.OptimizerType(d.get("type", "LBFGS").upper())
    kw = {key: d[key] for key in (
        "tolerance", "max_iterations", "num_corrections",
        "max_improvement_failures", "max_cg_iterations",
        "max_line_search_iterations") if key in d}
    kw["box_constraints"] = _parse_box(cid, d.get("box_constraints"))
    if kind == optim.OptimizerType.TRON:
        return optim.OptimizerConfig.tron(**kw)
    return optim.OptimizerConfig.lbfgs(**kw)


def _parse_regularization(d: dict):
    kind = optim.RegularizationType(d.get("type", "NONE").upper())
    weights = d.get("weights", d.get("weight", ()))
    if isinstance(weights, (int, float)):
        weights = (float(weights),)
    alpha = (d.get("alpha") if kind == optim.RegularizationType.ELASTIC_NET
             else None)
    return (optim.RegularizationContext(kind, alpha),
            tuple(float(w) for w in weights))


def _parse_range(d: dict, key: str) -> tuple[float, float] | None:
    """A regularization's ``weight_range`` / ``alpha_range``: the tuner's
    search interval for that coordinate."""
    return tuple(float(v) for v in d[key]) if key in d else None


def parse_coordinate(cid: str, d: dict) -> CoordinateSpec:
    reg_dict = d.get("regularization", {})
    reg, lambdas = _parse_regularization(reg_dict)
    opt_cfg = GLMOptimizationConfiguration(
        optimizer=_parse_optimizer(cid, d.get("optimizer", {})),
        regularization=reg,
        regularization_weight=lambdas[0] if lambdas else 0.0,
        down_sampling_rate=float(d.get("down_sampling_rate", 1.0)),
        variance_computation=VarianceComputationType(
            d.get("variance_computation", "NONE").upper()),
        regularization_weight_range=_parse_range(reg_dict, "weight_range"),
        elastic_net_param_range=_parse_range(reg_dict, "alpha_range"),
        incremental_weight=float(d.get("incremental_weight", 1.0)),
    )
    shard = d.get("feature_shard", "features")
    kind = d.get("type", "fixed").lower()
    if kind in ("fixed", "fixed_effect", "fixed-effect"):
        sharding = str(d.get("feature_sharding", "replicated")).lower()
        if sharding == "column":
            raise optim.not_ported(
                f"coordinate {cid!r}: feature_sharding 'column' "
                f"({COLUMN_SHARDING_NOT_PORTED})", MULTI_DEVICE_ITEM)
        cfg = FixedEffectCoordinateConfiguration(shard, opt_cfg,
                                                 feature_sharding=sharding)
    elif kind in ("random", "random_effect", "random-effect"):
        cfg = RandomEffectCoordinateConfiguration(
            RandomEffectDataConfiguration(
                random_effect_type=d["random_effect_type"],
                feature_shard_id=shard,
                active_data_upper_bound=d.get("active_data_upper_bound"),
                active_data_lower_bound=d.get("active_data_lower_bound"),
                features_to_samples_ratio=d.get("features_to_samples_ratio"),
            ),
            opt_cfg,
        )
    else:
        raise ValueError(f"coordinate {cid!r}: unknown type {kind!r}")
    return CoordinateSpec(cfg, lambdas)


@dataclasses.dataclass
class TrainingConfig:
    """A parsed training configuration (GameTrainingDriver params)."""

    task: TaskType
    coordinates: dict[str, CoordinateSpec]
    update_sequence: list[str]
    num_iterations: int
    input_format: str  # "avro" | "libsvm"
    train_path: str
    validation_path: str | None
    output_dir: str
    id_tags: list[str] | None
    normalization: NormalizationType
    evaluators: list[str]
    model_output_mode: str  # NONE | BEST | EXPLICIT | TUNED | ALL
    warm_start_model_dir: str | None
    locked_coordinates: set[str]
    incremental_training: bool
    data_validation: str
    feature_index_dir: str | None
    # Multi-bag shards (AvroDataReader.readMerged): shard -> record
    # feature-bag fields, or shard -> {bags: [...], intercept: bool};
    # None reads the single TrainingExampleAvro 'features' bag.
    # id_columns exposes top-level record fields as id tags.
    feature_shards: dict | None
    id_columns: list[str] | None
    # Daily input (trainDir/yyyy/MM/dd): "yyyymmdd-yyyymmdd" / "N-M".
    date_range: str | None
    days_range: str | None
    # Per-shard FeatureSummarizationResultAvro under <dir>/<shard>/.
    data_summary_dir: str | None = None
    # torch.profiler trace of the fit (obs.trace.profile_session).
    profile_dir: str | None = None
    # Reserved-column remapping (InputColumnsNames.scala:80-88).
    input_columns: dict[str, str] | None = None
    # {mode: NONE | RANDOM | BAYESIAN, iterations, seed}
    # (runHyperparameterTuning, GameTrainingDriver.scala:677-719).
    hyperparameter_tuning: dict | None = None
    # The estimator's mesh setting (parallel.mesh.resolve_mesh).
    mesh: str | int = "auto"

    def shard_bags(self) -> dict[str, list[str]] | None:
        if self.feature_shards is None:
            return None
        out = {}
        for shard, spec in self.feature_shards.items():
            if isinstance(spec, dict):
                if "bags" not in spec:
                    raise ValueError(
                        f"feature shard {shard!r}: dict spec needs a "
                        "'bags' list (and optional 'intercept' bool)")
                bags = spec["bags"]
            else:
                bags = spec
            if isinstance(bags, str) or not all(
                    isinstance(b, str) for b in bags):
                raise ValueError(
                    f"feature shard {shard!r}: bags must be a list of "
                    f"record field names, got {bags!r}")
            out[shard] = list(bags)
        return out

    def shard_intercepts(self) -> dict[str, bool]:
        if self.feature_shards is None:
            return {}
        return {shard: bool(spec.get("intercept", True))
                for shard, spec in self.feature_shards.items()
                if isinstance(spec, dict)}

    @staticmethod
    def load(path: str) -> "TrainingConfig":
        raw = _read_config_file(path)
        coords = {cid: parse_coordinate(cid, c)
                  for cid, c in raw["coordinates"].items()}
        inp = raw.get("input", {})
        return TrainingConfig(
            task=TaskType(raw["task"].upper()),
            coordinates=coords,
            update_sequence=list(raw.get("update_sequence", list(coords))),
            num_iterations=int(raw.get("num_iterations", 1)),
            input_format=inp.get("format", "avro"),
            train_path=raw["input"]["train_path"],
            validation_path=inp.get("validation_path"),
            output_dir=raw["output_dir"],
            id_tags=inp.get("id_tags"),
            normalization=NormalizationType(
                raw.get("normalization", "NONE").upper()),
            evaluators=list(raw.get("evaluators", [])),
            model_output_mode=raw.get("model_output_mode", "BEST").upper(),
            warm_start_model_dir=raw.get("warm_start_model_dir"),
            locked_coordinates=set(raw.get("locked_coordinates", ())),
            incremental_training=bool(raw.get("incremental_training",
                                              False)),
            data_validation=str(
                raw.get("data_validation", "DISABLED")).upper(),
            feature_index_dir=inp.get("feature_index_dir"),
            feature_shards=inp.get("feature_shards"),
            id_columns=inp.get("id_columns"),
            date_range=inp.get("date_range"),
            days_range=inp.get("days_range"),
            data_summary_dir=raw.get("data_summary_dir"),
            profile_dir=raw.get("profile_dir"),
            input_columns=inp.get("input_columns"),
            hyperparameter_tuning=raw.get("hyperparameter_tuning"),
            mesh=raw.get("mesh", "auto"),
        )

    def opt_config_sequence(self) -> list[dict]:
        """The Cartesian product of the per-coordinate lambda grids, one
        full GAME optimization configuration each
        (GameTrainingDriver.prepareGameOptConfigs :658-667)."""
        ids = list(self.coordinates)
        grids = [self.coordinates[cid].expanded() for cid in ids]
        return [dict(zip(ids, combo)) for combo in itertools.product(*grids)]

    def build_estimator(self, normalization_contexts=None,
                        intercept_indices=None, device=None
                        ) -> GameEstimator:
        return GameEstimator(
            self.task,
            {cid: spec.config for cid, spec in self.coordinates.items()},
            update_sequence=self.update_sequence,
            num_iterations=self.num_iterations,
            normalization=normalization_contexts or {},
            intercept_indices=intercept_indices or {},
            evaluators=self.evaluators or None,
            locked_coordinates=self.locked_coordinates,
            incremental_training=self.incremental_training,
            device=device,
            mesh=self.mesh,
        )


def _read_config_file(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return json.loads(text)
    try:
        import yaml
    except ImportError as exc:
        raise ImportError(
            f"{path}: a YAML training config needs PyYAML, which is not "
            "installed; write the config as JSON (a .json file) "
            "instead") from exc
    return yaml.safe_load(text)
