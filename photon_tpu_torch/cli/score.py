"""Batch scoring: an Avro GAME model directory and Avro data in, scores
and evaluation out (port of ``photon_tpu/cli/score.py``).

Counterpart of GameScoringDriver (photon-client
cli/game/scoring/GameScoringDriver.scala:39, run :136-197): feature index
maps from the data, the TrainingExampleAvro rows, the model, then the
scores through the serving ladder (``ScorePrograms.score_dataset`` on
the rungs ``BATCH_RUNGS``; one serve-kernel launch per chunk on the
card), written as ScoringResultAvro ``part-00000.avro`` beside an
optional ``evaluation.json``. It runs on ``cuda`` unless ``--device cpu``
is given, and prints one JSON line with the seconds of every stage.

Under a launcher (``torchrun --nproc-per-node N``) ``--mesh auto`` (the
default) scores on every rank of the process group through
``GameTransformer``, as the reference does: each rank scores its share
of the rows, the shares are gathered, and rank 0 alone writes the
scores and the evaluation.

Usage:
    python -m photon_tpu_torch.cli.score --model-dir out/models/best \
        --input data.avro --output scores/ [--evaluators AUC RMSE AUC:userId] \
        [--feature-shards global=features user=userFeatures ...] \
        [--id-tags userId ...] [--mesh auto|off|N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

# Batch-mode score ladder: the large rung amortizes the launch over
# file-sized inputs; the small tail rung bounds padding waste. (The
# online default 1/8/64/512 ladder optimizes latency instead.)
BATCH_RUNGS = (1024, 8192)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="photon_tpu_torch.cli.score", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--model-dir", required=True,
                        help="GAME model directory (Avro layout)")
    parser.add_argument("--input", required=True,
                        help="TrainingExampleAvro data file/dir")
    parser.add_argument("--output", required=True,
                        help="output directory for scores")
    parser.add_argument("--model-id", default="")
    parser.add_argument("--evaluators", nargs="*", default=None,
                        help="optional metrics, e.g. AUC RMSE AUC:userId")
    parser.add_argument("--id-tags", nargs="*", default=None)
    parser.add_argument("--feature-shards", nargs="*", default=None,
                        help="shard=bag[,bag...] specs for multi-bag avro "
                             "layouts (must match the model's shards)")
    parser.add_argument("--id-columns", nargs="*", default=None,
                        help="top-level record fields to expose as id tags")
    parser.add_argument("--data-validation", default="DISABLED",
                        help="FULL | SAMPLE | DISABLED")
    parser.add_argument("--input-columns", nargs="*", default=None,
                        metavar="COL=FIELD",
                        help="remap reserved record fields "
                             "(uid/response/offset/weight/metadataMap), "
                             "e.g. weight=sampleWeight "
                             "(InputColumnsNames.scala:80-88)")
    parser.add_argument("--mesh", default="auto",
                        help="auto (every rank of a launcher's process "
                             "group), off, or the group's size")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--log-file", default=None,
                        help="also write logs to this file (PhotonLogger "
                             "equivalent, util/PhotonLogger.scala:34)")
    args = parser.parse_args(argv)

    from photon_tpu_torch.cli.common import (
        cli_logging,
        distributed_session,
    )

    with cli_logging(args.verbose, args.log_file):
        with distributed_session(args.device) as session:
            rc = _run(args)
            session["clean"] = rc == 0
        return rc


def _run(args) -> int:
    from photon_tpu_torch import device as device_mod
    from photon_tpu_torch.cli.common import fetch_global, is_coordinator
    from photon_tpu_torch.data.validators import sanity_check_data
    from photon_tpu_torch.io import avro
    from photon_tpu_torch.io.model_io import save_scores
    from photon_tpu_torch.parallel.mesh import resolve_mesh

    dev = device_mod.resolve(args.device)
    mesh = resolve_mesh(args.mesh, device=dev)
    seconds: dict[str, float] = {}
    t0 = time.perf_counter()

    def lap(stage: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        seconds[stage] = now - t0
        t0 = now

    input_columns = None
    if args.input_columns:
        bad = [kv for kv in args.input_columns if "=" not in kv]
        if bad:
            raise SystemExit(
                f"--input-columns operands must be COL=FIELD, got {bad}")
        input_columns = dict(kv.split("=", 1) for kv in args.input_columns)

    decoded_before = dict(avro.DECODED_BLOCKS)
    data, model, metadata, _ = read_data_and_model(
        args.model_dir, args.input, feature_shards=args.feature_shards,
        id_tags=args.id_tags, id_columns=args.id_columns,
        input_columns=input_columns, device=dev, lap=lap)

    # Scoring rows may carry dummy labels; validate everything else.
    sanity_check_data(data, model.task, args.data_validation,
                      check_labels=False)
    lap("validation")
    report: dict = {}
    scores, evaluation = score_game_dataset(
        model, data, mesh=mesh, evaluators=args.evaluators, report=report)
    seconds.update(report.pop("seconds"))
    t0 = time.perf_counter()

    scores = fetch_global(scores)
    if not is_coordinator():
        return 0
    os.makedirs(args.output, exist_ok=True)
    save_scores(
        os.path.join(args.output, "part-00000.avro"),
        scores,
        model_id=args.model_id or metadata.get("modelType", ""),
        uids=data.uids,
        labels=data.host_column("labels"),
        weights=data.host_column("weights"),
    )
    out = {"num_scored": int(scores.shape[0]), "output": args.output}
    if evaluation is not None:
        out["evaluation"] = evaluation.evaluations
        with open(os.path.join(args.output, "evaluation.json"), "w") as f:
            json.dump(evaluation.evaluations, f, indent=2)
    lap("write")
    out.update(
        device=str(dev),
        decoded_blocks={k: avro.DECODED_BLOCKS[k] - decoded_before[k]
                        for k in decoded_before},
        seconds=seconds,
        rows_per_second=float(scores.shape[0]) / max(
            sum(seconds.values()), 1e-12),
        **report,
    )
    print(json.dumps(out))
    return 0


def read_data_and_model(model_dir: str, input_path: str, *,
                        feature_shards=None, id_tags=None, id_columns=None,
                        input_columns=None, device=None, lap=None):
    """The scoring rows and the model, each feature shard keyed by the
    index map the data's own keys define: ``feature_shards`` (a list of
    ``shard=bag[,bag...]``) reads one map per shard from its bags;
    without it the single ``features`` bag serves every model shard,
    which a model of more than one shard refuses. ``lap(stage)``, when
    given, is called after the decode, index build, dataset build and
    model load. Returns (data, model, the model's metadata, the index
    map of each model shard)."""
    from photon_tpu_torch.io import avro
    from photon_tpu_torch.io.avro_data import (
        build_index_map_from_records,
        read_merged,
        read_training_examples,
    )
    from photon_tpu_torch.io.model_io import (
        load_game_model,
        model_feature_shard_ids,
    )

    lap = lap or (lambda stage: None)
    # Feature index maps come from the scoring data's keys. Model
    # features absent from the data are dropped at model load: a feature
    # no row carries adds no margin either way.
    records = avro.read_container_dir(input_path)
    needed_shards = model_feature_shard_ids(model_dir)
    lap("decode")

    if feature_shards:
        # Multi-bag layout: one feature table and one index map per shard.
        from photon_tpu_torch.cli.index import (
            build_shard_vocabularies,
            parse_shard_spec,
        )
        from photon_tpu_torch.data.index_map import IndexMap
        from photon_tpu_torch.types import make_feature_key

        shard_bags = parse_shard_spec(feature_shards)
        missing = sorted(needed_shards - set(shard_bags))
        if missing:
            raise ValueError(
                f"model needs feature shard(s) {missing} but "
                f"--feature-shards only defines {sorted(shard_bags)}")
        index_maps = {
            shard: IndexMap.from_feature_names(
                [make_feature_key(n, t) for n, t in pairs])
            for shard, pairs in build_shard_vocabularies(
                records, shard_bags).items()
        }
        lap("index_build")
        data, _ = read_merged(
            input_path,
            feature_shards=shard_bags,
            index_maps=index_maps,
            id_columns=id_columns,
            id_tag_names=id_tags,
            input_columns=input_columns,
            records=records,
            device=device,
        )
        del records
        lap("dataset_build")
        model, metadata = load_game_model(model_dir, index_maps,
                                          device=device)
        lap("model_load")
    else:
        if len(needed_shards) > 1:
            raise ValueError(
                f"model was trained on multiple feature shards "
                f"{sorted(needed_shards)}; pass --feature-shards so each "
                "resolves against its own bags (aliasing them all to the "
                "single 'features' table would silently zero the random "
                "effects)")
        index_map = build_index_map_from_records(records)
        lap("index_build")
        data, _ = read_training_examples(
            input_path, index_map=index_map, id_tag_names=id_tags,
            input_columns=input_columns, records=records, device=device,
        )
        del records
        lap("dataset_build")
        index_maps = {s: index_map for s in needed_shards} or {
            "features": index_map}
        model, metadata = load_game_model(model_dir, index_maps,
                                          device=device)
        data = _alias_shards(data, needed_shards)
        lap("model_load")
    return data, model, metadata, index_maps


def score_game_dataset(model, data, *, mesh=None, evaluators=None,
                       report: dict | None = None):
    """Batch scoring through the serving implementation: float32
    coefficient tables and the ``BATCH_RUNGS`` ladder's
    ``score_dataset`` (one serve-kernel launch per chunk on the card),
    so a score computed offline and one served online for the same row
    come from one scorer. A ``mesh`` (row-shared scores) and a dataset
    with a shard of no fixed row layout (a ``DualEllFeatures`` shard:
    ``specs_from_dataset`` raises ``TypeError``) score through
    ``GameTransformer`` instead, as the reference's do (``serve_kernel``
    is then ``"transformer"``).
    Returns ([n] numpy scores, the evaluation or None); ``report``, when
    given, receives the seconds of the table build, the scoring and the
    evaluation and the ladder's route and dispatch counts."""
    import numpy as np

    from photon_tpu_torch.serve.programs import (
        ScorePrograms,
        ShapeLadder,
        specs_from_dataset,
    )
    from photon_tpu_torch.serve.tables import CoefficientTables
    from photon_tpu_torch.transformers import evaluate_scores

    report = {} if report is None else report
    seconds = report.setdefault("seconds", {})
    t0 = time.perf_counter()
    specs = None
    if mesh is None:
        try:
            specs = specs_from_dataset(data)
        except TypeError:  # a DualEll shard: no fixed row layout
            pass
    if specs is None:
        from photon_tpu_torch.transformers import GameTransformer

        scores, evaluation = GameTransformer(model, mesh=mesh).transform(
            data, evaluators)
        seconds["score"] = time.perf_counter() - t0
        report["serve_kernel"] = "transformer"
        return scores.detach().cpu().numpy(), evaluation
    tables = CoefficientTables.from_game_model(model, "float32", data.device)
    # score_dataset runs its own chunk loop: no rung graph is captured.
    programs = ScorePrograms(tables, ladder=ShapeLadder(BATCH_RUNGS),
                             specs=specs, compile_now=False)
    seconds["tables"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = programs.score_dataset(data)
    seconds["score"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    evaluation = evaluate_scores(data, scores, evaluators)
    seconds["evaluation"] = time.perf_counter() - t0
    report["serve_kernel"] = programs.stats["serve_kernel"]
    report["dispatches"] = {
        str(r): c for r, c in programs.stats["dispatches"].items()}
    report["chunks"] = len(programs.ladder.chunk_plan(data.num_samples))
    return np.asarray(scores), evaluation


def _alias_shards(data, shard_names):
    """Expose the single ingest feature table (and its host mirror)
    under every model shard name."""
    missing = {s for s in shard_names if s not in data.feature_shards}
    if not missing:
        return data
    shards = dict(data.feature_shards)
    host = dict(data.host)
    for s in missing:
        shards[s] = data.feature_shards["features"]
        host[("shard", s)] = data.host[("shard", "features")]
        if ("tail", "features") in data.host:
            host[("tail", s)] = data.host[("tail", "features")]
    return dataclasses.replace(data, feature_shards=shards, host=host)


if __name__ == "__main__":
    sys.exit(main())
