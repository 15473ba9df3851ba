"""GAME training from the command line: a config and data files in, a
directory of Avro GAME models out (port of ``photon_tpu/cli/train.py``).

Counterpart of GameTrainingDriver (photon-client
cli/game/training/GameTrainingDriver.scala:54, run :363-516), in the
reference's order: read the data (single-bag or multi-bag Avro, libsvm,
daily directories) -> data validation -> warm-start model -> feature
stats and normalization contexts -> the lambda grid's fit with
validation, under crash-safe checkpoints -> hyperparameter tuning
(``hyperparameter_tuning``: RANDOM or BAYESIAN candidates, each a full
fit) -> model selection -> the models (Avro layout plus
``checkpoint.npz``), ``training-summary.json`` and the per-group
evaluations. It runs on ``cuda`` unless ``--device cpu`` is given;
every random-effect Newton solve launches the CUDA Newton kernel there,
and every fixed-effect transpose on a sparse shard the segment-sum
kernel. The last line of standard output is the JSON the
reference prints; ``training-summary.json`` also holds each stage's
seconds.

With ``--stream-dir DIR`` the training data comes from DIR's Avro
shards through the out-of-core streaming ingest (``data/stream.py``):
bounded-memory windows of ``--stream-window`` shards against an
integrity manifest, a bounded-loss quarantine (``--max-bad-shards``,
``--max-bad-fraction``), transient I/O retried, and a cursor that
``--resume-ingest`` resumes; its work directory is ``ingest-work``
under the checkpoint directory, else the output directory.

Options the port does not run yet raise ``NotImplementedError`` naming
their ROADMAP Queue A item: telemetry and monitoring (``--telemetry``,
``--trace``, ``--flight-dir``, ``--no-flight``, ``--monitor-port``,
``--fleet-dir``: item 10) and ``--distributed`` (item 12), besides the
config options ``cli/config.py`` lists. The JAX package's ``--backend``
is ``--device`` here.

Usage:
    python -m photon_tpu_torch.cli.train --config train.json \
        [--checkpoint-dir DIR | --resume DIR] [--init-model PATH] \
        [--stream-dir DIR [--resume-ingest] [--stream-window N] \
         [--max-bad-shards N] [--max-bad-fraction F]] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="photon_tpu_torch.cli.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--config", required=True,
                        help="JSON (or, with PyYAML, YAML) training "
                             "configuration")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                        help="commit an atomic recovery point (model npz "
                             "+ manifest) after every outer CD iteration")
    parser.add_argument("--resume", default=None, metavar="DIR",
                        help="resume an interrupted run from DIR's "
                             "checkpoint (implies --checkpoint-dir DIR; "
                             "the manifest's static key must match this "
                             "run's configuration)")
    parser.add_argument("--init-model", default=None, metavar="PATH",
                        help="warm start from a GameModel: a native "
                             "checkpoint .npz or an Avro model directory")
    parser.add_argument("--stream-dir", default=None, metavar="DIR",
                        help="out-of-core streaming ingest: train from "
                             "DIR's Avro shards in bounded-memory "
                             "windows with per-shard integrity checks, "
                             "transient-I/O retry and a resumable "
                             "cursor, instead of the config's "
                             "train_path")
    parser.add_argument("--resume-ingest", action="store_true",
                        help="resume a killed streaming ingest from its "
                             "committed cursor (window spills are "
                             "reloaded; the resumed dataset is byte-"
                             "identical to the uninterrupted run's). "
                             "Requires --stream-dir")
    parser.add_argument("--stream-window", type=int, default=1,
                        metavar="N",
                        help="shards per streaming window (decode of "
                             "window k+1 overlaps window k's device "
                             "copy; default 1 = the cursor commits at "
                             "every shard boundary)")
    parser.add_argument("--max-bad-shards", type=int, default=0,
                        metavar="N",
                        help="quarantine budget: tolerate up to N "
                             "corrupt shards (skipped, counted and "
                             "reported as ingested_fraction; default 0 "
                             "= abort on the first corrupt shard)")
    parser.add_argument("--max-bad-fraction", type=float, default=0.0,
                        metavar="F",
                        help="quarantine budget as a fraction of the "
                             "shard count (combined with "
                             "--max-bad-shards by max)")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--log-file", default=None,
                        help="also write logs to this file (PhotonLogger "
                             "equivalent, util/PhotonLogger.scala:34)")
    parser.add_argument("--telemetry", default=None, metavar="PATH",
                        help="telemetry JSONL (item 10)")
    parser.add_argument("--trace", default=None, metavar="PATH",
                        help="Chrome-trace timeline (item 10)")
    parser.add_argument("--flight-dir", default=None, metavar="DIR",
                        help="crash flight recorder (item 10)")
    parser.add_argument("--no-flight", action="store_true",
                        help="turn the flight recorder off (item 10)")
    parser.add_argument("--monitor-port", type=int, default=None,
                        metavar="PORT", help="live /metrics (item 10)")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-process training (item 12)")
    parser.add_argument("--fleet-dir", default=None, metavar="DIR",
                        help="fleet observability bundles (item 10)")
    args = parser.parse_args(argv)

    from photon_tpu_torch import optim
    from photon_tpu_torch.cli.config import MULTI_DEVICE_ITEM, TELEMETRY_ITEM

    for flag, value in (("--telemetry", args.telemetry),
                        ("--trace", args.trace),
                        ("--flight-dir", args.flight_dir),
                        ("--no-flight", args.no_flight or None),
                        ("--monitor-port", args.monitor_port),
                        ("--fleet-dir", args.fleet_dir)):
        if value is not None:
            raise optim.not_ported(f"{flag} (telemetry and monitoring)",
                                   TELEMETRY_ITEM)
    if args.distributed:
        raise optim.not_ported("--distributed (multi-process training)",
                               MULTI_DEVICE_ITEM)
    if (args.resume and args.checkpoint_dir
            and os.path.abspath(args.resume)
            != os.path.abspath(args.checkpoint_dir)):
        parser.error(
            "--resume and --checkpoint-dir point at different "
            f"directories ({args.resume} vs {args.checkpoint_dir}); "
            "--resume DIR already implies --checkpoint-dir DIR")
    if args.resume_ingest and not args.stream_dir:
        parser.error("--resume-ingest requires --stream-dir")

    from photon_tpu_torch.cli.common import cli_logging
    from photon_tpu_torch.resilience import faults

    with cli_logging(args.verbose, args.log_file):
        # PHOTON_TPU_FAULT_PLAN arms a seeded fault plan in this process
        # (nothing when unset): how tests inject a crash or a signal.
        faults.arm_from_env()
        return _run(args)


def _run(args) -> int:
    from photon_tpu_torch import device as device_mod
    from photon_tpu_torch.cli.config import TrainingConfig
    from photon_tpu_torch.data.dataset import DenseFeatures, SparseFeatures
    from photon_tpu_torch.data.pipeline import PIPELINE_STATS
    from photon_tpu_torch.data.validators import sanity_check_data
    from photon_tpu_torch.io.avro_data import (
        read_merged,
        read_training_examples,
    )
    from photon_tpu_torch.io.model_io import (
        load_game_model,
        save_checkpoint,
        save_game_model,
    )
    from photon_tpu_torch.ops.normalization import (
        NormalizationType,
        build_normalization_context,
    )
    from photon_tpu_torch.resilience import (
        TrainingCheckpointer,
        TrainingInterrupted,
        load_training_checkpoint,
        training_static_key,
    )
    from photon_tpu_torch.stat import FeatureDataStatistics

    log = logging.getLogger("photon.train")
    dev = device_mod.resolve(args.device)
    t_start = time.time()
    seconds: dict = {}
    t0 = time.perf_counter()

    def lap(stage: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        seconds[stage] = now - t0
        log.info("%s executed in %.3f s", stage, now - t0)
        t0 = now

    cfg = TrainingConfig.load(args.config)
    os.makedirs(cfg.output_dir, exist_ok=True)
    # This run's ingest stages, from its first read on.
    PIPELINE_STATS.reset()

    # ------------------------------------------------------------------
    # read the data (readTrainingData :537)
    # ------------------------------------------------------------------
    train_records = val_records = None
    if (cfg.date_range or cfg.days_range) and not args.stream_dir:
        train_records, val_records = _daily_records(cfg, log)

    prebuilt_maps = None
    if cfg.feature_index_dir:
        # A prebuilt vocabulary (cli.index): features absent from it are
        # dropped at ingest.
        from photon_tpu_torch.cli.index import load_index_maps

        prebuilt_maps = load_index_maps(cfg.feature_index_dir)
        log.info("loaded %d feature index map(s) from %s",
                 len(prebuilt_maps), cfg.feature_index_dir)
    prebuilt_features_map = None
    if prebuilt_maps is not None and not cfg.feature_shards:
        if "features" not in prebuilt_maps:
            raise ValueError(
                f"feature_index_dir {cfg.feature_index_dir!r} has no "
                f"'features' index (found: {sorted(prebuilt_maps)}); "
                "training ingest reads the 'features' bag")
        prebuilt_features_map = prebuilt_maps["features"]
    if cfg.input_format != "avro" and (cfg.feature_index_dir
                                       or cfg.feature_shards):
        raise ValueError(
            "feature_index_dir / feature_shards apply to avro input only; "
            "libsvm data is identity-indexed single-shard "
            "(IdentityIndexMapLoader semantics)")

    multi_shard_maps = None
    validation = None
    stream_stats = None
    stream_work_dir = None
    if args.stream_dir:
        # --------------------------------------------------------------
        # streaming ingest (data/stream.py)
        # --------------------------------------------------------------
        if cfg.input_format != "avro":
            raise ValueError(
                "--stream-dir streams Avro shards; set input.format to "
                "avro")
        if cfg.date_range or cfg.days_range:
            raise ValueError(
                "--stream-dir does not combine with date_range/"
                "days_range; point it at the day directory instead")
        from photon_tpu_torch.data.stream import (
            QuarantinePolicy,
            StreamingIngest,
        )

        # The ingest's work dir (manifest, vocabulary, spills, cursor)
        # sits with the training checkpoints when crash safety is on, so
        # one directory carries the whole recovery chain; else in the
        # output dir.
        stream_work_dir = os.path.join(
            args.checkpoint_dir or args.resume or cfg.output_dir,
            "ingest-work")
        shard_bags = cfg.shard_bags()
        ingest = StreamingIngest(
            args.stream_dir,
            work_dir=stream_work_dir,
            feature_shards=shard_bags,
            index_maps=prebuilt_maps,
            id_tag_names=cfg.id_tags,
            id_columns=cfg.id_columns,
            input_columns=cfg.input_columns,
            add_intercept=cfg.shard_intercepts() if shard_bags else True,
            window_shards=args.stream_window,
            quarantine=QuarantinePolicy(args.max_bad_shards,
                                        args.max_bad_fraction),
            resume=args.resume_ingest,
            device=dev,
        )
        train, stream_stats = ingest.run()
        log.info(
            "streamed %d row(s) from %d/%d shard(s) "
            "(ingested_fraction %.4f%s)", stream_stats["rows_ingested"],
            stream_stats["shards_ingested"], stream_stats["shards_total"],
            stream_stats["ingested_fraction"],
            f", resumed at shard {stream_stats['resumed_from_shard']}"
            if stream_stats["resumed_from_shard"] is not None else "")
        if stream_stats["quarantined_paths"]:
            log.warning(
                "streaming ingest quarantined %d shard(s): %s",
                stream_stats["shards_quarantined"],
                ", ".join(stream_stats["quarantined_paths"]))
        multi_shard_maps = ingest.resolved_maps
        index_map = next(iter(multi_shard_maps.values()))
        if cfg.validation_path:
            # The validation rows are read against the streamed maps.
            if shard_bags:
                validation, _ = read_merged(
                    cfg.validation_path, feature_shards=shard_bags,
                    index_maps=multi_shard_maps, id_columns=cfg.id_columns,
                    id_tag_names=list(ingest.id_tag_names),
                    input_columns=cfg.input_columns, device=dev)
            else:
                validation, _ = read_training_examples(
                    cfg.validation_path,
                    index_map=multi_shard_maps["features"],
                    id_tag_names=list(ingest.id_tag_names),
                    input_columns=cfg.input_columns, device=dev)
    elif cfg.input_format == "avro" and cfg.feature_shards:
        if prebuilt_maps is not None:
            missing = sorted(set(cfg.feature_shards) - set(prebuilt_maps))
            if missing:
                raise ValueError(
                    f"feature_index_dir {cfg.feature_index_dir!r} does not "
                    f"cover shard(s) {missing}; a partially prebuilt "
                    "vocabulary would silently train those shards on a "
                    "data-derived one")
        # Multi-bag layout (AvroDataReader.readMerged): one index map and
        # one ELL matrix per configured shard.
        train, multi_shard_maps = read_merged(
            cfg.train_path, feature_shards=cfg.shard_bags(),
            index_maps=prebuilt_maps, id_columns=cfg.id_columns,
            id_tag_names=cfg.id_tags, input_columns=cfg.input_columns,
            add_intercept=cfg.shard_intercepts(), records=train_records,
            device=dev)
        index_map = next(iter(multi_shard_maps.values()))
        if cfg.validation_path:
            validation, _ = read_merged(
                cfg.validation_path, feature_shards=cfg.shard_bags(),
                index_maps=multi_shard_maps, id_columns=cfg.id_columns,
                id_tag_names=cfg.id_tags, input_columns=cfg.input_columns,
                records=val_records, device=dev)
    elif cfg.input_format == "avro":
        train, index_map = read_training_examples(
            cfg.train_path, index_map=prebuilt_features_map,
            id_tag_names=cfg.id_tags, input_columns=cfg.input_columns,
            records=train_records, device=dev)
        if cfg.validation_path:
            validation, _ = read_training_examples(
                cfg.validation_path, index_map=index_map,
                id_tag_names=cfg.id_tags, input_columns=cfg.input_columns,
                records=val_records, device=dev)
    elif cfg.input_format == "libsvm":
        train, index_map = _libsvm_game(cfg.train_path, cfg.task, dev)
        if cfg.validation_path:
            validation, _ = _libsvm_game(cfg.validation_path, cfg.task, dev,
                                         index_map)
    else:
        raise ValueError(f"unknown input format {cfg.input_format!r}")
    log.info("read %d train rows (%d features)", train.num_samples,
             len(index_map))
    lap("read")

    # ------------------------------------------------------------------
    # data validation (DataValidators.sanityCheckDataFrameForTraining)
    # ------------------------------------------------------------------
    sanity_check_data(train, cfg.task, cfg.data_validation)
    if validation is not None:
        sanity_check_data(validation, cfg.task, cfg.data_validation)
    shards = sorted(train.feature_shards)
    if multi_shard_maps is not None:
        index_maps = dict(multi_shard_maps)
        intercept_indices = {s: m.intercept_index
                             for s, m in multi_shard_maps.items()
                             if m.intercept_index is not None}
    else:
        index_maps = {s: index_map for s in shards}
        intercept_indices = (
            {s: index_map.intercept_index for s in shards}
            if index_map.intercept_index is not None else {})
    lap("validate")

    # ------------------------------------------------------------------
    # warm start (loadGameModelFromHDFS :395-404)
    # ------------------------------------------------------------------
    initial_model = None
    init_model_digest = None
    if args.init_model:
        if cfg.warm_start_model_dir:
            raise ValueError(
                "--init-model and the config's warm_start_model_dir are "
                "both set; pass exactly one warm-start source")
        from photon_tpu_torch.io.model_io import load_initial_model

        initial_model, init_model_digest = load_initial_model(
            args.init_model, index_maps, device=dev)
        log.info("warm start from --init-model %s (digest %s...)",
                 args.init_model, init_model_digest[:12])
    elif cfg.warm_start_model_dir:
        initial_model, _ = load_game_model(cfg.warm_start_model_dir,
                                           index_maps, device=dev)
        log.info("warm start from %s", cfg.warm_start_model_dir)
    if cfg.incremental_training and initial_model is None:
        raise ValueError(
            "incremental_training is enabled but no warm_start_model_dir "
            "is configured (GameEstimator.scala:241-382)")
    lap("warm_start")

    # ------------------------------------------------------------------
    # feature stats + normalization (prepareNormalizationContexts :590)
    # ------------------------------------------------------------------
    norm_contexts = {}
    if cfg.normalization != NormalizationType.NONE or cfg.data_summary_dir:
        import torch

        for s in shards:
            idx, val, d = train.host_shard_coo(s)
            feats = (DenseFeatures(val)
                     if isinstance(train.feature_shards[s], DenseFeatures)
                     else SparseFeatures(idx, val, d))
            stats = FeatureDataStatistics.from_features(
                feats, train.host_column("weights"),
                intercept_index=intercept_indices.get(s))
            if cfg.data_summary_dir:
                # calculateAndSaveFeatureShardStats :616-627: one
                # FeatureSummarizationResultAvro dir per shard.
                from photon_tpu_torch.io.model_io import save_feature_stats

                save_feature_stats(os.path.join(cfg.data_summary_dir, s),
                                   stats, index_maps[s])
                log.info("feature stats for shard %r written to %s", s,
                         os.path.join(cfg.data_summary_dir, s))
            if cfg.normalization != NormalizationType.NONE:
                # In the training dtype, as the reference's contexts are
                # in its default (x64-off) configuration.
                def put(a):
                    return torch.as_tensor(a, dtype=train.dtype, device=dev)

                norm_contexts[s] = build_normalization_context(
                    cfg.normalization, mean=put(stats.mean),
                    variance=put(stats.variance), min_=put(stats.min),
                    max_=put(stats.max),
                    intercept_index=intercept_indices.get(s))
    lap("stats")

    # ------------------------------------------------------------------
    # the lambda grid's fit (GameEstimator.fit :397), crash-safe
    # ------------------------------------------------------------------
    estimator = cfg.build_estimator(norm_contexts, intercept_indices,
                                    device=dev)
    opt_seq = cfg.opt_config_sequence()
    log.info("training %d configuration(s)", len(opt_seq))
    checkpointer = None
    resume_state = None
    ckpt_dir = args.checkpoint_dir or args.resume
    if ckpt_dir:
        checkpointer = TrainingCheckpointer(
            ckpt_dir, training_static_key(estimator, opt_seq))
        # Run provenance rides every manifest commit: the streaming
        # ingest's cursor (work dir and the pinned shard-manifest hash)
        # and the init model's digest, so a crash at any point recovers
        # ingest, then descent, end to end.
        run_meta = {}
        if stream_stats is not None:
            run_meta["ingest_cursor"] = {
                "stream_dir": os.path.abspath(args.stream_dir),
                "work_dir": os.path.abspath(stream_work_dir),
                "manifest_sha256": stream_stats.get("manifest_sha256"),
                "rows_ingested": stream_stats.get("rows_ingested"),
                "ingested_fraction": stream_stats.get("ingested_fraction"),
                "quarantined_shards": stream_stats.get(
                    "shards_quarantined"),
            }
        if init_model_digest is not None:
            run_meta["init_model"] = {
                "path": os.path.abspath(args.init_model),
                "sha256": init_model_digest}
        if run_meta:
            checkpointer.set_run_meta(run_meta)
        if args.resume:
            resume_state = load_training_checkpoint(args.resume, dev)
            log.info(
                "resuming from %s: config %d, last completed CD "
                "iteration %d%s", args.resume, resume_state.config_index,
                resume_state.iteration,
                " (interrupted run)" if resume_state.interrupted else "")

    # SIGINT/SIGTERM unwind the fit, so an emergency checkpoint lands
    # before the exit with 128 + signum; the previous handlers come
    # back afterwards.
    def _interrupt(signum, frame):
        raise TrainingInterrupted(signum)

    prev_handlers = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            prev_handlers[sig] = signal.signal(sig, _interrupt)
        except ValueError:  # not the main thread
            pass
    lap("setup")
    try:
        estimator.prepare(train, validation, initial_model)
        lap("prepare")
        results = estimator.fit(train, validation, opt_seq,
                                initial_model=initial_model,
                                checkpointer=checkpointer,
                                resume=resume_state)
        lap("fit")
    except TrainingInterrupted as exc:
        log.error("training interrupted by signal %d", exc.signum)
        if checkpointer is not None:
            path = checkpointer.write_emergency()
            if path:
                log.error(
                    "emergency checkpoint committed to %s; resume with: "
                    "python -m photon_tpu_torch.cli.train --config %s "
                    "--resume %s", path, args.config, ckpt_dir)
            else:
                log.error("interrupted before any CD iteration completed; "
                          "no training state to checkpoint")
        return 128 + exc.signum
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)

    # ------------------------------------------------------------------
    # hyperparameter tuning (runHyperparameterTuning :677-719)
    # ------------------------------------------------------------------
    num_tuned = 0
    tuning = cfg.hyperparameter_tuning or {}
    tuning_mode = str(tuning.get("mode", "NONE")).upper()
    if tuning_mode != "NONE" and validation is None:
        log.warning(
            "hyperparameter tuning (%s) requested but no validation_path is "
            "configured; skipping", tuning_mode)
    elif tuning_mode != "NONE":
        from photon_tpu_torch import hyperparameter

        evaluation_function = hyperparameter.GameEstimatorEvaluationFunction(
            estimator, results[0].config, train, validation,
            is_opt_max=results[0].evaluation.primary_evaluator
            .bigger_is_better,
            initial_model=initial_model)
        if evaluation_function.num_params == 0:
            log.warning(
                "hyperparameter tuning requested but no coordinate has a "
                "tunable regularization; skipping")
        else:
            tuned = hyperparameter.search(
                int(tuning.get("iterations", 10)),
                evaluation_function.num_params, tuning_mode,
                evaluation_function,
                evaluation_function.convert_observations(results),
                seed=int(tuning.get("seed", 0)))
            num_tuned = len(tuned)
            log.info("hyperparameter tuning (%s) evaluated %d candidate(s)",
                     tuning_mode, num_tuned)
            results = results + tuned
    lap("tune")

    # ------------------------------------------------------------------
    # model selection + save (selectBestModel :753, saveModelToHDFS :804)
    # ------------------------------------------------------------------
    best = estimator.select_best(results)
    best_idx = next(i for i, r in enumerate(results) if r is best)
    lap("select")

    def config_json(r):
        return {cid: {
            "regularization": c.regularization.regularization_type.value,
            "lambda": c.regularization_weight,
            "optimizer": c.optimizer.optimizer_type.value,
        } for cid, c in r.config.items()}

    # Model output modes (io/ModelOutputMode.scala:47): NONE saves
    # nothing, BEST the selected model, EXPLICIT adds the lambda grid's,
    # TUNED the tuner's, ALL everything. The best model always lands in
    # "best/".
    num_grid = len(results) - num_tuned
    mode = cfg.model_output_mode
    if mode == "NONE":
        to_save = []
    elif mode == "BEST":
        to_save = [(best_idx, best)]
    elif mode == "EXPLICIT":
        to_save = [(best_idx, best)] + [
            (i, r) for i, r in enumerate(results[:num_grid])
            if i != best_idx]
    elif mode == "TUNED":
        to_save = [(best_idx, best)] + [
            (i, r) for i, r in enumerate(results)
            if i >= num_grid and i != best_idx]
    elif mode == "ALL":
        to_save = list(enumerate(results))
    else:
        raise ValueError(f"unknown model_output_mode {mode!r}")
    for i, r in to_save:
        out = os.path.join(cfg.output_dir, "models",
                           "best" if r is best else f"config_{i}")
        save_game_model(r.model, out, index_maps, task=cfg.task,
                        optimization_configurations=config_json(r))
        save_checkpoint(r.model, os.path.join(out, "checkpoint.npz"))
    log.info("saved %d model(s) to %s", len(to_save),
             os.path.join(cfg.output_dir, "models"))
    lap("save_models")

    # ------------------------------------------------------------------
    # per-group evaluation (savePerGroupEvaluationToHDFS :878-901)
    # ------------------------------------------------------------------
    grouped_specs = [e for e in cfg.evaluators if ":" in e]
    if mode != "NONE" and validation is not None and grouped_specs:
        _write_group_evaluations(cfg, validation, grouped_specs, to_save)
        log.info("wrote per-group evaluations for %d model(s)",
                 len(to_save))
    lap("group_evaluation")

    summary = {
        "task": cfg.task.value,
        "num_training_rows": train.num_samples,
        "num_configurations": len(results),
        "num_tuned_configurations": num_tuned,
        "best_configuration_index": best_idx,
        "configurations": [
            {"config": config_json(r),
             "evaluation": None if r.evaluation is None
             else r.evaluation.evaluations}
            for r in results
        ],
        "wall_clock_seconds": round(time.time() - t_start, 2),
        "device": str(dev),
        "seconds": dict(seconds, fit_per_configuration=[
            r.seconds for r in results]),
        # The ingest pipeline's stages (raw and plan transfers, planning)
        # and its packed transfers, of this run's prepare.
        "ingest_pipeline": dict(PIPELINE_STATS.report(),
                                packed_transfers=PIPELINE_STATS.transfers()),
    }
    if stream_stats is not None:
        # The streaming ingest's health: ingested_fraction and the
        # quarantined paths.
        summary["streaming_ingest"] = stream_stats
    with open(os.path.join(cfg.output_dir, "training-summary.json"),
              "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({
        "best_configuration": config_json(best),
        "evaluation": None if best.evaluation is None
        else best.evaluation.evaluations,
        "output_dir": cfg.output_dir,
        "wall_clock_seconds": summary["wall_clock_seconds"],
    }))
    return 0


def _libsvm_game(path, task, device, index_map=None):
    """A libsvm file as a one-shard GameDataset on ``device`` and its
    identity index map (IdentityIndexMapLoader semantics). The -1/+1 to
    0/1 label mapping applies to binary tasks only."""
    from photon_tpu_torch.data.game_data import make_game_dataset
    from photon_tpu_torch.data.index_map import IndexMap
    from photon_tpu_torch.data.libsvm import read_libsvm
    from photon_tpu_torch.types import TaskType

    binary = task in (TaskType.LOGISTIC_REGRESSION,
                      TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)
    if index_map is None:
        batch = read_libsvm(path, binary_labels_to01=binary, device="cpu")
        index_map = IndexMap.identity(batch.num_features - 1,
                                      add_intercept=True)
    else:
        batch = read_libsvm(path, num_features=len(index_map) - 1,
                            binary_labels_to01=binary, device="cpu")
    game = make_game_dataset(
        batch.labels.numpy(), {"features": batch.features},
        offsets=batch.offsets.numpy(), weights=batch.weights.numpy(),
        device=device)
    return game, index_map


def _daily_records(cfg, log):
    """The records of every daily directory (base/yyyy/MM/dd) in the
    config's date or days range, train and validation
    (IOUtils.getInputPathsWithinDateRange)."""
    from photon_tpu_torch.io import avro
    from photon_tpu_torch.io.paths import (
        DateRange,
        DaysRange,
        paths_for_date_range,
    )

    if cfg.input_format != "avro":
        raise ValueError("date_range/days_range apply to avro input only")
    if cfg.date_range and cfg.days_range:
        raise ValueError("set only one of date_range / days_range")
    rng = (DateRange.from_string(cfg.date_range) if cfg.date_range
           else DaysRange.from_string(cfg.days_range).to_date_range())

    def read_daily(base):
        day_paths = paths_for_date_range(base, rng)
        log.info("date range %s..%s under %s -> %d daily dir(s)",
                 rng.start, rng.end, base, len(day_paths))
        recs = []
        for p in day_paths:
            recs.extend(avro.read_container_dir(p))
        return recs

    return (read_daily(cfg.train_path),
            read_daily(cfg.validation_path) if cfg.validation_path
            else None)


def _write_group_evaluations(cfg, validation, grouped_specs, to_save):
    """One JSON per grouped evaluator and saved model under
    group-evaluation/<i>/: group key -> metric, groups where it is
    undefined left out. The suite runs in the labels' dtype."""
    import numpy as np

    from photon_tpu_torch.transformers import (
        GameTransformer,
        evaluation_suite,
    )

    suite = evaluation_suite(validation, grouped_specs)
    for i, r in to_save:
        per_group = suite.evaluate_per_group(
            GameTransformer(r.model).score(validation))
        out_dir = os.path.join(cfg.output_dir, "group-evaluation", str(i))
        os.makedirs(out_dir, exist_ok=True)
        for metric, values in per_group.items():
            keys = validation.id_tags[metric.split(":", 1)[1]].inverse
            payload = {str(k): float(v) for k, v in zip(keys, values)
                       if np.isfinite(v)}
            fname = metric.replace(":", "_") + ".json"
            with open(os.path.join(out_dir, fname), "w") as f:
                json.dump(payload, f, indent=2)


if __name__ == "__main__":
    sys.exit(main())
