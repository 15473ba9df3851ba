"""Online scoring on the GPU: load a model, serve requests (port of
``photon_tpu/cli/serve.py``).

Loads a native ``.npz`` checkpoint, or an Avro GAME model directory,
into device-resident coefficient tables, captures the score ladder (one
CUDA graph per rung, each running the fused serve kernel), starts the
micro-batch queue and drives requests through it: one per row of a
TrainingExampleAvro file (``--input``, scored against the data's own
index maps, so it needs ``--model-dir``), or synthetic ones. It prints
one JSON line: p50/p99 latency, QPS, batch fill, cold-entity rate,
dispatches per rung, the graphs captured and their capture seconds, the
kernel launches the run made, the queue's ``health()`` and, per
``--reload-model``, the reload's summary and the drive that follows it.
A reload is hot, on the live queue: a values-only refresh is copied
into the live tables, a structure change captures a new ladder off the
request path and swaps it in under the queue's ``quiesce``. The exit is
non-zero when any request of any drive failed.

``PHOTON_TPU_FAULT_PLAN`` arms a fault plan in the process (the
``serve.dispatch`` point fires inside the queue's retried dispatch).

Telemetry is on for every run, as in the JAX package: the summary
carries ``request_trace`` (outcome counts and mean segment times over
the request ring), ``--telemetry PATH`` writes the JSONL stream,
``--trace PATH`` the Chrome-trace timeline and ``--request-log PATH``
the per-request records the ring retained (its header counts the
events dropped). The crash flight recorder chains SIGINT and SIGTERM
and dumps ``flight-<pid>.json`` into ``--flight-dir`` (default ``.``)
when the process dies; ``--no-flight`` turns it off. All of it is
recorded on the host, after each fetch: the captured graphs are the
same with it on or off.

Live monitoring and health. ``--monitor-port PORT`` (0: ephemeral)
serves ``/metrics`` (Prometheus text: the registry, the queue's depth,
per-coordinate cold counters, latency window, hot entities and SLO
burn, plus the ledger's and health layer's families when armed),
``/healthz`` and ``/readyz`` for the whole run. The exporter comes up
before the model loads, so ``/healthz`` answers from the start;
``/readyz`` answers 503 until the tables are resident, every rung's
CUDA graph is captured, the queue (started after the last capture) is
up and the breaker is closed. The queue always
tracks the declared SLOs (``--slo-p99-ms``, ``--slo-error-rate``,
``--slo-cold-rate``, ``--slo-window-s``; the long window is 12 times
the short), reported under ``slo`` in the summary and ``health``.
``--health-sketch PATH`` arms the health layer's serve tap for the run
and writes the sampled request and score sketch to PATH at the end
(compare it with a training run's ``ingest-sketch.json`` through
``python -m photon_tpu_torch.cli.health``); the layer's armed state is
restored on exit.

Usage:
    python -m photon_tpu_torch.cli.serve (--checkpoint model.npz | \
        --model-dir out/models/best) \
        [--input data.avro [--feature-shards s=bag ...] [--id-tags t ...] \
         | --synthetic 20000] [--batch-sizes 1,8,64,512] \
        [--max-linger-ms 2] [--deadline-ms D] [--shed-watermark N] \
        [--breaker-threshold 8] [--reload-model PATH ...] \
        [--precision float32|bfloat16] [--target-qps Q] [--scores PATH] \
        [--telemetry PATH] [--trace PATH] [--request-log PATH] \
        [--flight-dir DIR | --no-flight] [--monitor-port PORT] \
        [--slo-p99-ms MS] [--slo-error-rate R] [--slo-cold-rate R] \
        [--slo-window-s S] [--health-sketch PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def build_server(checkpoint: str | None = None, *,
                 precision: str = "float32", rungs=(1, 8, 64, 512),
                 device=None, model_dir: str | None = None):
    """A checkpoint or an Avro model directory -> (tables, programs) on
    ``device`` (default cuda), the ladder's graphs captured; each step a
    logged telemetry span."""
    from photon_tpu_torch import obs
    from photon_tpu_torch.serve.programs import ScorePrograms, ShapeLadder
    from photon_tpu_torch.serve.tables import CoefficientTables

    if (checkpoint is None) == (model_dir is None):
        raise ValueError("give exactly one of a checkpoint and a model "
                         "directory")
    with obs.logged_span("serve: load model"):
        tables = CoefficientTables.from_game_model(
            load_model(checkpoint or model_dir, device), precision, device)
    with obs.logged_span("serve: AOT-compile score ladder"):
        programs = ScorePrograms(tables, ladder=ShapeLadder(rungs))
    return tables, programs


def load_model(path: str, device=None, index_maps=None):
    """A native checkpoint (a file), or an Avro model directory keyed by
    ``index_maps`` (default: its own records' index maps, the
    standalone-serving convention)."""
    from photon_tpu_torch.io.model_io import load_checkpoint, load_game_model
    from photon_tpu_torch.serve.tables import build_index_maps_from_model

    if os.path.isfile(path) or path.endswith(".npz"):
        return load_checkpoint(path, device)
    if index_maps is None:
        index_maps = build_index_maps_from_model(path)
    model, _ = load_game_model(path, index_maps, device=device)
    return model


def run(args) -> dict:
    """Serve per ``args``, with the monitor exporter (``--monitor-port``)
    up from before the model loads until the summary is built."""
    from photon_tpu_torch.obs import fleet, monitor

    rungs = tuple(int(r) for r in args.batch_sizes.split(",") if r.strip())
    # Read by /readyz on the exporter's threads; written here.
    ready = {"tables_loaded": False, "ladder_compiled": False,
             "graphs_captured": 0, "rungs": len(rungs)}
    queue_ref: list = []

    def readiness():
        breaker_open = bool(queue_ref
                            and queue_ref[0].health()["breaker_open"])
        ok = (ready["tables_loaded"] and ready["ladder_compiled"]
              and bool(queue_ref) and not breaker_open)
        return ok, {**ready, "queue_up": bool(queue_ref),
                    "breaker_open": breaker_open}

    mon = None
    if args.monitor_port is not None:
        # Offset by the process index, so processes sharing a host do
        # not collide on one --monitor-port value.
        mon = monitor.MonitorServer(
            fleet.resolve_monitor_port(args.monitor_port),
            readiness=readiness).start()
        logging.getLogger("photon.serve").info(
            "monitor endpoints on port %d (requested %d, rank %d)",
            mon.port, args.monitor_port,
            fleet.host_identity()["process_index"])
    try:
        return _serve(args, rungs, mon, ready, queue_ref)
    finally:
        if mon is not None:
            mon.stop()


def _serve(args, rungs, mon, ready, queue_ref) -> dict:
    from photon_tpu_torch import obs
    from photon_tpu_torch.obs import monitor
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.serve.driver import (
        dataset_requests,
        drive,
        synthetic_requests,
    )
    from photon_tpu_torch.serve.queue import MicroBatchQueue

    index_maps = None
    if args.input:
        from photon_tpu_torch.cli.score import read_data_and_model
        from photon_tpu_torch.serve.programs import (
            ScorePrograms,
            ShapeLadder,
            specs_from_dataset,
        )
        from photon_tpu_torch.serve.tables import CoefficientTables

        # Request features resolve against the data's index maps, so
        # the model loads against the same maps (as cli.score does).
        with obs.logged_span("serve: load model"):
            data, model, _, index_maps = read_data_and_model(
                args.model_dir, args.input,
                feature_shards=args.feature_shards, id_tags=args.id_tags,
                device=args.device)
            tables = CoefficientTables.from_game_model(
                model, args.precision, args.device)
        ready["tables_loaded"] = True
        with obs.logged_span("serve: AOT-compile score ladder"):
            programs = ScorePrograms(tables, ladder=ShapeLadder(rungs),
                                     specs=specs_from_dataset(data))
        requests = dataset_requests(data, programs)
        del data, model
    else:
        tables, programs = build_server(
            args.checkpoint, precision=args.precision, rungs=rungs,
            device=args.device, model_dir=args.model_dir,
        )
        ready["tables_loaded"] = True
        requests = synthetic_requests(
            tables, programs, args.synthetic,
            cold_fraction=args.cold_fraction, seed=args.seed,
        )
    # Every rung's graph is captured (none on the CPU, where dispatch
    # is eager).
    ready["graphs_captured"] = programs.stats["programs_compiled"]
    ready["ladder_compiled"] = True

    def launched() -> int:
        return serve_kernel.launches + serve_kernel.replay_launches

    launches_before = launched()
    scores: list | None = [] if args.scores else None
    with obs.logged_span("serve: drive requests"), MicroBatchQueue(
        programs,
        max_batch=args.max_batch,
        max_linger_s=args.max_linger_ms / 1e3,
        max_queue=args.max_queue,
        default_deadline_s=(None if args.deadline_ms is None
                            else args.deadline_ms / 1e3),
        shed_watermark=args.shed_watermark,
        breaker_threshold=args.breaker_threshold or None,
        slo=monitor.SloPolicy(
            p99_ms=args.slo_p99_ms,
            error_rate=args.slo_error_rate,
            cold_entity_rate=args.slo_cold_rate,
            short_window_s=args.slo_window_s,
            long_window_s=12 * args.slo_window_s,
        ),
    ) as queue:
        queue_ref.append(queue)
        if mon is not None:
            # From here /readyz can answer 200 and /metrics carries the
            # queue's families.
            mon.add_collector(queue.metrics_families)
        captured_before = programs.stats["programs_compiled"]
        summary = drive(queue, requests, rate=args.target_qps,
                        scores=scores)
        captured_during = (programs.stats["programs_compiled"]
                           - captured_before)
        reloads = []
        for path in args.reload_model:
            info = queue.reload_model(
                load_model(path, args.device, index_maps))
            info["model"] = path
            info["summary"] = drive(queue, requests, rate=args.target_qps)
            reloads.append(info)
        health = queue.health()
    if scores is not None:
        import numpy as np

        np.save(args.scores, np.asarray(scores, dtype=np.float32))
    out = {
        "metric": "serving",
        "model": args.checkpoint or args.model_dir,
        "input": args.input,
        "device": str(programs.device),
        "precision": tables.precision,
        "rungs": list(programs.ladder.rungs),
        "max_batch": queue.max_batch,
        "max_linger_ms": args.max_linger_ms,
        "library_load_seconds": round(
            programs.stats["library_load_seconds"], 4),
        "programs_compiled": programs.stats["programs_compiled"],
        "aot_compile_seconds": round(
            programs.stats["aot_compile_seconds"], 4),
        "graph_device_bytes": programs.stats["graph_device_bytes"],
        "graph_host_bytes": programs.stats["graph_host_bytes"],
        "dispatches": programs.stats["dispatches"],
        "serve_kernel": programs.stats["serve_kernel"],
        # Graphs captured while the main drive served: none, since
        # every rung was captured at start.
        "compile_events_during_serving": captured_during,
        "kernel_launches": launched() - launches_before,
        "health": health,
        "tables": tables.coordinate_stats(),
    }
    if mon is not None:
        out["monitor"] = {"port": mon.port, **mon.scrape_stats()}
    if reloads:
        out["reloads"] = reloads
    out.update(summary)
    if args.telemetry:
        obs.write_jsonl(args.telemetry)
    if args.trace:
        obs.write_chrome_trace(args.trace)
    if args.request_log:
        obs.trace.write_request_jsonl(args.request_log)
    if args.health_sketch:
        out["health_sketch"] = {
            "path": args.health_sketch,
            "requests_sampled": obs.health.save_serve_sketch(
                args.health_sketch),
        }
    return out


def run_instrumented(args) -> dict:
    """``run`` with telemetry on, as the JAX package serves: the
    caller's enabled flag restored afterwards, and the flight recorder
    (unless ``--no-flight``) chaining SIGINT and SIGTERM and dumping on
    an exception. Off the main thread signal handlers cannot be set:
    the recorder then installs without them. ``--health-sketch`` arms
    the health layer for the run; its armed state is restored after."""
    from photon_tpu_torch import obs
    from photon_tpu_torch.obs import flight

    was_enabled = obs.enabled()
    was_health = obs.health.enabled()
    obs.reset()
    obs.enable()
    if args.health_sketch:
        obs.health.enable()
    rec = None
    prior_rec = flight.installed()
    if not args.no_flight:
        rec = flight.install(args.flight_dir, signals=True)
    try:
        return run(args)
    except BaseException as exc:
        # An in-process caller catches up-stack, so the chained
        # excepthook never fires for it: dump at the unwind.
        if rec is not None and not isinstance(exc, SystemExit):
            flight.dump(f"exception:{type(exc).__name__}")
        raise
    finally:
        if rec is not None:
            flight.uninstall()
            if prior_rec is not None:
                flight.reinstall(prior_rec)
        obs.TRACER.enabled = was_enabled
        if not was_health:
            obs.health.disable()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="photon_tpu_torch.cli.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", help="native .npz checkpoint")
    src.add_argument("--model-dir",
                     help="GAME model directory (Avro layout)")
    parser.add_argument("--input", default=None,
                        help="TrainingExampleAvro file/dir to replay as "
                             "requests, one a row (needs --model-dir)")
    parser.add_argument("--feature-shards", nargs="*", default=None,
                        help="with --input: shard=bag[,bag...] specs for "
                             "multi-bag layouts (as cli.score takes them)")
    parser.add_argument("--id-tags", nargs="*", default=None,
                        help="with --input: id tags to read")
    parser.add_argument("--synthetic", type=int, default=1000, metavar="N",
                        help="without --input: the number of synthetic "
                             "requests to drive")
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
    parser.add_argument("--deadline-ms", type=float, default=None,
                        help="per-request deadline: a request still "
                             "queued past it fails fast with "
                             "DeadlineExceededError")
    parser.add_argument("--shed-watermark", type=int, default=None,
                        help="queue depth beyond which submits are "
                             "rejected (OverloadedError) instead of "
                             "blocking")
    parser.add_argument("--breaker-threshold", type=int, default=8,
                        help="consecutive dispatch failures that trip "
                             "the circuit breaker; 0 disables")
    parser.add_argument("--reload-model", action="append", default=[],
                        metavar="PATH",
                        help="after the main drive, hot-reload this model "
                             "(.npz checkpoint or Avro model directory) "
                             "into the live queue and drive the requests "
                             "again (repeatable)")
    parser.add_argument("--precision", default="float32",
                        choices=("float32", "bfloat16"),
                        help="coefficient table storage")
    parser.add_argument("--target-qps", type=float, default=None,
                        help="pace submissions at this offered load "
                             "(default: flood)")
    parser.add_argument("--scores", default=None, metavar="PATH",
                        help="write the main drive's per-request scores, "
                             "in request order, to PATH (.npy; NaN for a "
                             "failed request)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write the summary JSON to PATH")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--log-file", default=None)
    parser.add_argument("--telemetry", default=None, metavar="PATH",
                        help="write the telemetry JSONL stream (spans, "
                             "metrics, reports) to PATH")
    parser.add_argument("--trace", default=None, metavar="PATH",
                        help="write the Chrome-trace / Perfetto timeline "
                             "(spans, per-request slices, counters) to "
                             "PATH")
    parser.add_argument("--request-log", default=None, metavar="PATH",
                        help="write the per-request records the request "
                             "ring retained (one JSON line each, with "
                             "the count dropped in the header) to PATH")
    parser.add_argument("--flight-dir", default=".", metavar="DIR",
                        help="crash flight recorder destination: "
                             "flight-<pid>.json is dumped there on "
                             "SIGINT/SIGTERM or an unhandled exception")
    parser.add_argument("--no-flight", action="store_true",
                        help="turn the crash flight recorder off")
    parser.add_argument("--monitor-port", type=int, default=None,
                        metavar="PORT",
                        help="serve /metrics (Prometheus text), /healthz "
                             "and /readyz on this port for the whole run "
                             "(0: ephemeral; the bound port is in the "
                             "summary). /readyz answers 200 once the "
                             "tables are resident, every rung's graph is "
                             "captured, the queue is up and the breaker "
                             "is closed")
    parser.add_argument("--slo-p99-ms", type=float, default=250.0,
                        help="latency SLO: 99%% of served requests "
                             "finish under this many ms")
    parser.add_argument("--slo-error-rate", type=float, default=0.001,
                        help="error-rate SLO budget (the fraction of "
                             "requests allowed to fail)")
    parser.add_argument("--slo-cold-rate", type=float, default=0.2,
                        help="cold-entity SLO budget (the fraction of "
                             "lookups allowed out of vocabulary)")
    parser.add_argument("--slo-window-s", type=float, default=5.0,
                        help="short burn-rate window, seconds (the long "
                             "window is 12 times longer)")
    parser.add_argument("--health-sketch", default=None, metavar="PATH",
                        help="arm the health layer's serve tap and write "
                             "the sampled request and score sketch to "
                             "PATH at the end (compare it with "
                             "python -m photon_tpu_torch.cli.health)")
    args = parser.parse_args(argv)
    if args.checkpoint and args.input:
        # A native checkpoint keys its coefficients by dense index with
        # no (name, term), so nothing aligns it with a data file's maps.
        parser.error("--input requires --model-dir (the Avro layout's "
                     "name-keyed coefficients align with the data's index "
                     "maps; a .npz checkpoint cannot)")
    from photon_tpu_torch.cli.common import cli_logging
    from photon_tpu_torch.resilience import faults

    with cli_logging(args.verbose, args.log_file):
        faults.arm_from_env()
        out = run_instrumented(args)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    errors = out["errors"] + sum(r["summary"]["errors"]
                                 for r in out.get("reloads", ()))
    return 0 if errors == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
