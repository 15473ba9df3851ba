"""Online scoring on the GPU: load a model, serve synthetic traffic.

Loads a native ``.npz`` checkpoint, or an Avro GAME model directory
keyed by its own records' feature index maps, into device-resident
coefficient tables, builds the score ladder (loading the fused serve
kernel), starts the micro-batch queue, drives synthetic requests through
it and prints one JSON line: p50/p99 latency, QPS, batch fill,
cold-entity rate, dispatches per rung and the kernel launches the run
made.

Usage:
    python -m photon_tpu_torch.cli.serve (--checkpoint model.npz | \
        --model-dir out/models/best) --synthetic 20000 \
        [--batch-sizes 1,8,64,512] [--max-linger-ms 2] \
        [--precision float32|bfloat16] [--target-qps Q] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys


def build_server(checkpoint: str | None = None, *,
                 precision: str = "float32", rungs=(1, 8, 64, 512),
                 device=None, model_dir: str | None = None):
    """A checkpoint or an Avro model directory -> (tables, programs) on
    ``device`` (default cuda)."""
    from photon_tpu_torch.io.model_io import load_checkpoint, load_game_model
    from photon_tpu_torch.serve.programs import ScorePrograms, ShapeLadder
    from photon_tpu_torch.serve.tables import (
        CoefficientTables,
        build_index_maps_from_model,
    )

    if (checkpoint is None) == (model_dir is None):
        raise ValueError("give exactly one of a checkpoint and a model "
                         "directory")
    if checkpoint is not None:
        model = load_checkpoint(checkpoint, device)
    else:
        # Standalone serving: the model directory's own records define
        # the feature space.
        model, _ = load_game_model(
            model_dir, build_index_maps_from_model(model_dir), device=device)
    tables = CoefficientTables.from_game_model(model, precision, device)
    return tables, ScorePrograms(tables, ladder=ShapeLadder(rungs))


def run(args) -> dict:
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.serve.driver import drive, synthetic_requests
    from photon_tpu_torch.serve.queue import MicroBatchQueue

    rungs = tuple(int(r) for r in args.batch_sizes.split(",") if r.strip())
    tables, programs = build_server(
        args.checkpoint, precision=args.precision, rungs=rungs,
        device=args.device, model_dir=args.model_dir,
    )
    requests = synthetic_requests(
        tables, programs, args.synthetic,
        cold_fraction=args.cold_fraction, seed=args.seed,
    )
    launches_before = serve_kernel.launches
    with MicroBatchQueue(
        programs,
        max_batch=args.max_batch,
        max_linger_s=args.max_linger_ms / 1e3,
        max_queue=args.max_queue,
    ) as queue:
        summary = drive(queue, requests, rate=args.target_qps)
    out = {
        "metric": "serving",
        "model": args.checkpoint or args.model_dir,
        "device": str(programs.device),
        "precision": tables.precision,
        "rungs": list(programs.ladder.rungs),
        "max_batch": queue.max_batch,
        "max_linger_ms": args.max_linger_ms,
        "library_load_seconds": round(
            programs.stats["library_load_seconds"], 4),
        "dispatches": programs.stats["dispatches"],
        "serve_kernel": programs.stats["serve_kernel"],
        # Nothing is built after ScorePrograms.__init__ loaded the
        # kernel library, so the request loop builds nothing.
        "compile_events_during_serving": 0,
        "kernel_launches": serve_kernel.launches - launches_before,
        "tables": tables.coordinate_stats(),
    }
    out.update(summary)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="photon_tpu_torch.cli.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", help="native .npz checkpoint")
    src.add_argument("--model-dir",
                     help="GAME model directory (Avro layout)")
    parser.add_argument("--synthetic", type=int, default=1000, metavar="N",
                        help="number of synthetic requests to drive")
    parser.add_argument("--cold-fraction", type=float, default=0.05,
                        help="fraction of entity lookups drawn outside "
                             "the model vocabulary")
    parser.add_argument("--batch-sizes", default="1,8,64,512",
                        help="score-ladder rungs (comma-separated)")
    parser.add_argument("--max-batch", type=int, default=None,
                        help="queue flush size (default: top rung)")
    parser.add_argument("--max-linger-ms", type=float, default=2.0,
                        help="max time the oldest request waits for "
                             "batch-mates before a flush")
    parser.add_argument("--max-queue", type=int, default=4096,
                        help="queue bound; producers block beyond it")
    parser.add_argument("--precision", default="float32",
                        choices=("float32", "bfloat16"),
                        help="coefficient table storage")
    parser.add_argument("--target-qps", type=float, default=None,
                        help="pace submissions at this offered load "
                             "(default: flood)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write the summary JSON to PATH")
    args = parser.parse_args(argv)
    out = run(args)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    return 0 if out["errors"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
