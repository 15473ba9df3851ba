"""The single-GLM lambda-sweep driver, the legacy Driver (port of
``photon_tpu/cli/glm.py``).

Counterpart of the reference's deprecated top-level driver
(photon-client Driver.scala:60) and its engine entry
``ModelTraining.trainGeneralizedLinearModel`` (photon-api
ModelTraining.scala:100): one generalized linear model (no random effects),
trained for a DESCENDING list of regularization weights with warm starts
between them, validated with the legacy metric map (Evaluation.scala:31-110
— MAE/MSE/RMSE for regression facets, AUC/AUPR/peak-F1 for binary
classifiers, per-datum log loss), and the best lambda selected per task
(ModelSelection.scala: AUC for classifiers, RMSE for linear regression,
Poisson loss for Poisson regression).

Stage structure mirrors DriverStage (DriverStage.scala:45): PREPROCESSED
(read + optional feature summarization + normalization) -> TRAINED (the
warm-started sweep) -> VALIDATED (metric maps + selection). Constrained
coefficients (the legacy ``constraintMap``) map to ``--coefficient-bounds``,
solved by the bound-constrained L-BFGS. Each stage's seconds are logged
and written to ``glm-summary.json`` under ``seconds``.

It trains on ``cuda`` unless ``--device cpu`` is given. The data are
ELL shards, so every fixed-effect gradient there launches the
segment-sum kernel (``SparseFeatures.rmatvec``, site ``fixed_effect``).

Usage:
    python -m photon_tpu_torch.cli.glm --train data.avro \
        --task LOGISTIC_REGRESSION --lambdas 10,1,0.1 --validate val.avro \
        --output-dir out/ [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import time


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="photon_tpu_torch.cli.glm", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--train", required=True, help="training data file/dir")
    p.add_argument("--validate", help="validation data file/dir")
    p.add_argument("--format", default="avro", choices=("avro", "libsvm"))
    p.add_argument("--task", required=True,
                   help="LINEAR_REGRESSION | LOGISTIC_REGRESSION | "
                        "POISSON_REGRESSION | SMOOTHED_HINGE_LOSS_LINEAR_SVM")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--regularization", default="L2",
                   choices=("NONE", "L1", "L2", "ELASTIC_NET"))
    p.add_argument("--lambdas", default="1.0",
                   help="comma-separated regularization weights")
    p.add_argument("--alpha", type=float, default=0.5,
                   help="elastic-net L1 fraction")
    p.add_argument("--optimizer", default="LBFGS", choices=("LBFGS", "TRON"))
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--tolerance", type=float, default=1e-7)
    p.add_argument("--normalization", default="NONE",
                   help="NONE | SCALE_WITH_STANDARD_DEVIATION | "
                        "SCALE_WITH_MAX_MAGNITUDE | STANDARDIZATION")
    p.add_argument("--coefficient-bounds", default=None,
                   help="lower,upper box applied to every coefficient "
                        "(legacy constraintMap; uses the bound-constrained "
                        "L-BFGS)")
    p.add_argument("--summarization-output-dir", default=None,
                   help="write per-feature statistics here (legacy "
                        "summarization stage)")
    p.add_argument("--model-output-mode", default="ALL",
                   choices=("ALL", "BEST", "NONE"))
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--log-file", default=None)
    p.add_argument("--verbose", action="store_true")
    return p.parse_args(argv)


# Legacy metric-map families per task (Evaluation.scala:64-110).
_SELECTION_KEY = {
    "LOGISTIC_REGRESSION": "AUC",
    "SMOOTHED_HINGE_LOSS_LINEAR_SVM": "AUC",
    "LINEAR_REGRESSION": "RMSE",
    "POISSON_REGRESSION": "POISSON_LOSS",
}
_METRICS = {
    "LINEAR_REGRESSION": ["MAE", "MSE", "RMSE"],
    "LOGISTIC_REGRESSION": [
        "AUC", "AUPR", "PEAK_F1", "LOGISTIC_LOSS", "F1=0.5", "PRECISION=0.5",
        "RECALL=0.5", "ACCURACY=0.5",
    ],
    "SMOOTHED_HINGE_LOSS_LINEAR_SVM": ["AUC", "AUPR", "PEAK_F1"],
    "POISSON_REGRESSION": ["POISSON_LOSS", "MAE", "MSE", "RMSE"],
}


def main(argv=None) -> int:
    args = _parse_args(argv)
    t_start = time.time()

    from photon_tpu_torch.cli.common import cli_logging

    log = logging.getLogger("photon.glm")
    with cli_logging(args.verbose, args.log_file):
        return _run(args, log, t_start)


def _run(args, log, t_start) -> int:
    import numpy as np
    import torch

    from photon_tpu_torch import device as device_mod
    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm.problems import (
        GLMOptimizationConfiguration,
        GLMOptimizationProblem,
    )
    from photon_tpu_torch.data.libsvm import read_libsvm
    from photon_tpu_torch.evaluation.suite import make_suite
    from photon_tpu_torch.io.avro_data import read_training_examples
    from photon_tpu_torch.io.model_io import (
        save_feature_stats,
        save_game_model,
    )
    from photon_tpu_torch.models.game import FixedEffectModel, GameModel
    from photon_tpu_torch.ops.normalization import (
        NormalizationType,
        build_normalization_context,
    )
    from photon_tpu_torch.stat import FeatureDataStatistics
    from photon_tpu_torch.types import TaskType

    dev = device_mod.resolve(args.device)
    task = TaskType(args.task.upper())
    task_name = task.name
    lambdas = sorted(
        (float(s) for s in args.lambdas.split(",") if s.strip()),
        reverse=True,  # descending: each model warm-starts the next
    )
    if not lambdas:
        raise ValueError("--lambdas is empty")
    os.makedirs(args.output_dir, exist_ok=True)
    seconds: dict = {}

    @contextlib.contextmanager
    def stage(name: str):
        """Logs and records the stage's seconds, ending in a device sync
        so that the card's queued work is counted where it ran."""
        t0 = time.perf_counter()
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0
        log.info("%s executed in %.3f s", name, seconds[name])

    # ---- stage PREPROCESSED (Driver.scala preprocess) --------------------
    with stage("preprocess"):
        if args.format == "libsvm":
            # -1/+1 -> 0/1 label mapping is a BINARY convention; regression
            # labels legitimately go negative and must pass through.
            binary = task in (
                TaskType.LOGISTIC_REGRESSION,
                TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
            )
            train_batch = read_libsvm(
                args.train, binary_labels_to01=binary, device=dev)
            imap = None
            val_batch = (
                read_libsvm(
                    args.validate,
                    num_features=train_batch.num_features - 1,
                    binary_labels_to01=binary, device=dev,
                )
                if args.validate else None
            )
            intercept = train_batch.num_features - 1
        else:
            train_game, imap = read_training_examples(args.train,
                                                      device=dev)
            train_batch = train_game.shard_batch("features")
            val_batch = None
            if args.validate:
                val_game, _ = read_training_examples(
                    args.validate, index_map=imap, device=dev)
                val_batch = val_game.shard_batch("features")
            intercept = imap.intercept_index

        norm = None
        norm_type = NormalizationType(args.normalization.upper())
        stats = None
        if (norm_type != NormalizationType.NONE
                or args.summarization_output_dir):
            stats = FeatureDataStatistics.from_features(
                train_batch.features, train_batch.weights,
                intercept_index=intercept,
            )
        if args.summarization_output_dir:
            if imap is None:
                log.warning(
                    "summarization skipped: libsvm input has no feature "
                    "names (identity index)")
            else:
                save_feature_stats(
                    args.summarization_output_dir, stats, imap)
                log.info("feature stats written to %s",
                         args.summarization_output_dir)
        if norm_type != NormalizationType.NONE:
            def put(a):
                return torch.as_tensor(np.asarray(a),
                                       dtype=train_batch.labels.dtype,
                                       device=dev)

            norm = build_normalization_context(
                norm_type,
                mean=put(stats.mean),
                variance=put(stats.variance),
                min_=put(stats.min),
                max_=put(stats.max),
                intercept_index=intercept,
            )

    # ---- stage TRAINED (ModelTraining.trainGeneralizedLinearModel) -------
    box = None
    if args.coefficient_bounds:
        lo, hi = (float(x) for x in args.coefficient_bounds.split(","))
        d = train_batch.num_features
        box = (torch.full((d,), lo, dtype=train_batch.labels.dtype,
                          device=dev),
               torch.full((d,), hi, dtype=train_batch.labels.dtype,
                          device=dev))
    reg_type = optim.RegularizationType(args.regularization.upper())
    use_tron = args.optimizer == "TRON"
    if use_tron and box is not None:
        # TRON handles the box by projecting after each accepted step,
        # which can terminate at non-KKT points on bound-active problems;
        # the gradient-projection LBFGSB solver is the correct tool, so
        # bounded configs are routed there regardless of --optimizer.
        log.warning(
            "--coefficient-bounds with --optimizer TRON: routing to the "
            "bound-constrained L-BFGS-B solver (TRON's projection-after-"
            "step semantics can stall at non-KKT points)")
        use_tron = False
    opt_cfg = (
        optim.OptimizerConfig.tron(max_iterations=args.max_iterations)
        if use_tron
        else optim.OptimizerConfig.lbfgs(
            tolerance=args.tolerance, max_iterations=args.max_iterations,
            box_constraints=box)
    )

    models: list[tuple[float, object]] = []
    with stage("train lambda sweep"):
        prev = None
        for lam in lambdas:
            cfg = GLMOptimizationConfiguration(
                optimizer=opt_cfg,
                regularization=optim.RegularizationContext(
                    reg_type,
                    alpha=(
                        args.alpha
                        if reg_type == optim.RegularizationType.ELASTIC_NET
                        else None
                    ),
                ),
                regularization_weight=lam,
            )
            kwargs = {} if norm is None else {"normalization": norm}
            problem = GLMOptimizationProblem(
                task, cfg, intercept_index=intercept, **kwargs,
            )
            solution = problem.run(train_batch, prev)
            prev = solution.model.coefficients  # warm start (ModelTraining)
            models.append((lam, solution.model))
            log.info("lambda %g trained (%d iterations)", lam,
                     int(solution.result.iterations))

    # ---- stage VALIDATED (Evaluation.evaluate + ModelSelection) ----------
    metrics_by_lambda: dict[str, dict[str, float]] = {}
    best_lambda = lambdas[0]
    if val_batch is not None:
        with stage("validate"):
            suite = make_suite(
                _METRICS[task_name],
                val_batch.labels,
                offsets=val_batch.offsets,
                weights=val_batch.weights,
                dtype=val_batch.labels.dtype,
            )
            key = _SELECTION_KEY[task_name]
            best_val = None
            for lam, model in models:
                scores = model.coefficients.compute_score(
                    val_batch.features)
                res = suite.evaluate(scores)
                metrics_by_lambda[repr(lam)] = res.evaluations
                v = res.evaluations[key]
                better = (
                    best_val is None
                    or (v > best_val if key == "AUC" else v < best_val)
                )
                if better:
                    best_val, best_lambda = v, lam
            log.info("best lambda %g by %s = %g", best_lambda, key, best_val)

    # ---- outputs ---------------------------------------------------------
    from photon_tpu_torch.data.index_map import IndexMap

    save_map = imap
    if save_map is None:  # libsvm: identity-named features + intercept
        save_map = IndexMap.identity(
            train_batch.num_features - 1, add_intercept=True)

    def save(model, sub):
        gm = GameModel({"global": FixedEffectModel(model, "features")})
        save_game_model(gm, os.path.join(args.output_dir, sub),
                        {"features": save_map}, task=task)

    with stage("save models"):
        if args.model_output_mode == "ALL":
            for lam, model in models:
                save(model, f"models/lambda={lam:g}")
        if args.model_output_mode in ("ALL", "BEST"):
            save(dict(models)[best_lambda], "best-model")
    summary = {
        "task": task_name,
        "lambdas": lambdas,
        "best_lambda": best_lambda,
        "metrics": metrics_by_lambda,
        "stages": ["PREPROCESSED", "TRAINED"]
        + (["VALIDATED"] if val_batch is not None else []),
        "wall_clock_seconds": round(time.time() - t_start, 2),
        "device": str(dev),
        "seconds": seconds,
    }
    with open(os.path.join(args.output_dir, "glm-summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
