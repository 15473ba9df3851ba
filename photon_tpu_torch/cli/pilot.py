"""The always-on train → validate → promote → rollback daemon (port of
``photon_tpu/cli/pilot.py``).

One process supervises the production loop (PILOT.md): watch a shard
directory, stream-ingest new data, retrain warm-started, gate the
promotion against the serving model, hot-reload the live scorer,
watch the post-promotion SLO burn, roll back from the bounded
generation ring, and commit every state-machine transition atomically
so a killed pilot resumes where it died (``--work-dir`` is all the
memory it needs). It runs on ``cuda`` unless ``--device cpu`` is
given: the fit launches the Newton and segment-sum kernels, the
validation's grouped AUC the segment-sum kernel, and every served
request replays the serve kernel's captured graph of its rung.

The exit JSON has the JAX package's keys. ``serving_reload_compile_events``
counts the CUDA graphs the promotions' reloads captured (the JAX package
counts XLA compile-cache events there; ``pilot/serving.py``). The
exit code is non-zero when the pilot is left in serve-only mode or any
traffic request errored. With the flight recorder on (the default), a
SIGTERM dumps ``flight-<pid>.json`` into ``--flight-dir`` and the
process dies as a SIGTERM death; refusals and rollbacks dump there too.

Usage:
    python -m photon_tpu_torch.cli.pilot --config pilot.yaml \
        [--poll-interval 5] [--max-cycles N] [--idle-timeout S] \
        [--traffic-qps R] [--monitor-port P] [--json PATH] \
        [--device cuda|cpu]

The config file carries the training surface (task, coordinates,
num_iterations, evaluators: the ``cli.train`` vocabulary) and the pilot
blocks::

    stream_dir: out/shards          # watched directory
    work_dir: out/pilot             # durable state + ring + cycles
    validation_dir: out/holdout     # held-out shards the gate scores
    keep_generations: 3             # rollback ring bound
    promotion: {min_delta: {AUC: -0.005}}
    observe: {window_s: 2.0, max_dispatch_errors: 0}
    serve: {rungs: [1, 8, 64], max_linger_ms: 2.0}
    ingest: {feature_shards: {...}, id_tag_names: [...], dtype: float32}
    health:                         # model/data health gates (PILOT.md)
      max_drift_psi: 0.25           # this cycle vs last promoted cycle
      max_skew_psi: 0.5             # training data vs sampled traffic
      max_ece: 0.1                  # candidate calibration (binary)
      max_coefficient_rel_l2: 5.0   # warm-start lurch ceiling
      forbid_nonfinite: true        # non-finite coefficients refuse
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="photon_tpu_torch.cli.pilot", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--config", required=True,
                        help="pilot configuration (YAML/JSON; see "
                             "PILOT.md)")
    parser.add_argument("--stream-dir", default=None,
                        help="override the config's stream_dir")
    parser.add_argument("--work-dir", default=None,
                        help="override the config's work_dir")
    parser.add_argument("--poll-interval", type=float, default=5.0,
                        metavar="S",
                        help="seconds between shard-directory polls")
    parser.add_argument("--max-cycles", type=int, default=None,
                        help="stop after N completed cycles "
                             "(promotions + refusals)")
    parser.add_argument("--idle-timeout", type=float, default=None,
                        metavar="S",
                        help="stop after S seconds with no new shards")
    parser.add_argument("--traffic-qps", type=float, default=None,
                        metavar="R",
                        help="drive R synthetic requests/s against the "
                             "live scorer for the whole run (served and "
                             "error counts in the exit JSON)")
    parser.add_argument("--monitor-port", type=int, default=None,
                        metavar="PORT",
                        help="serve /metrics, /healthz and /readyz "
                             "(the pilot_* gauges and the queue's "
                             "collector; 0: ephemeral)")
    parser.add_argument("--reset-serve-only", action="store_true",
                        help="re-arm a pilot that degraded to "
                             "serve-only mode, then continue")
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write the exit summary JSON to PATH")
    parser.add_argument("--flight-dir", default=".", metavar="DIR",
                        help="crash flight recorder destination "
                             "(refusals and rollbacks dump here too)")
    parser.add_argument("--no-flight", action="store_true",
                        help="turn the crash flight recorder off")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--log-file", default=None)
    args = parser.parse_args(argv)

    from photon_tpu_torch.cli.common import cli_logging

    with cli_logging(args.verbose, args.log_file):
        from photon_tpu_torch.resilience import faults

        # PHOTON_TPU_FAULT_PLAN arms a seeded fault plan (nothing when
        # unset): how tests and the smoke run inject faults.
        faults.arm_from_env()
        return _run(args)


def _load_config(args) -> dict:
    from photon_tpu_torch.cli.config import _read_config_file

    raw = _read_config_file(args.config)
    if args.stream_dir:
        raw["stream_dir"] = args.stream_dir
    if args.work_dir:
        raw["work_dir"] = args.work_dir
    for key in ("stream_dir", "work_dir", "task", "coordinates"):
        if not raw.get(key):
            raise SystemExit(
                f"pilot config {args.config}: missing {key!r}")
    return raw


def _build_pilot_config(raw: dict, device: str = "cuda"):
    import torch

    from photon_tpu_torch.cli.config import parse_coordinate
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.pilot import ObservePolicy, PilotConfig, PromotionGate
    from photon_tpu_torch.types import TaskType

    mesh = raw.get("mesh", "off")
    task = TaskType(raw["task"].upper())
    coords = {
        cid: parse_coordinate(cid, c)
        for cid, c in raw["coordinates"].items()
    }
    update_sequence = list(raw.get("update_sequence", list(coords)))
    num_iterations = int(raw.get("num_iterations", 1))
    evaluators = list(raw.get("evaluators", []))

    def estimator_factory():
        return GameEstimator(
            task,
            {cid: spec.config for cid, spec in coords.items()},
            update_sequence=update_sequence,
            num_iterations=num_iterations,
            evaluators=evaluators or None,
            device=device,
            mesh=mesh,
        )

    promo = raw.get("promotion", {})
    observe = raw.get("observe", {})
    health_cfg = raw.get("health")
    health_gate = None
    if health_cfg is not None:
        import dataclasses as _dc

        from photon_tpu_torch.obs.health import HealthGatePolicy

        _defaults = {
            f.name: f.default for f in _dc.fields(HealthGatePolicy)
        }

        def _opt(key):
            # An absent key keeps the policy's documented default
            # (max_drift_psi=0.25); only an explicit null disables the
            # gate.
            if key not in health_cfg:
                return _defaults[key]
            v = health_cfg[key]
            return None if v is None else float(v)

        health_gate = HealthGatePolicy(
            max_drift_psi=_opt("max_drift_psi"),
            max_skew_psi=_opt("max_skew_psi"),
            max_ece=_opt("max_ece"),
            max_coefficient_rel_l2=_opt("max_coefficient_rel_l2"),
            forbid_nonfinite=bool(
                health_cfg.get("forbid_nonfinite", True)),
            min_skew_requests=int(
                health_cfg.get("min_skew_requests", 64)),
        )
    ingest = dict(raw.get("ingest", {}))
    if "feature_shards" in ingest:
        ingest["feature_shards"] = {
            s: list(b) for s, b in ingest["feature_shards"].items()
        }
    if isinstance(ingest.get("dtype"), str):
        # The JAX package's spelling: a dtype name.
        ingest["dtype"] = getattr(torch, ingest["dtype"])
    return PilotConfig(
        stream_dir=raw["stream_dir"],
        work_dir=raw["work_dir"],
        estimator_factory=estimator_factory,
        validation_dir=raw.get("validation_dir"),
        window_shards=int(raw.get("window_shards", 1)),
        keep_generations=int(raw.get("keep_generations", 3)),
        keep_cycle_dirs=int(raw.get("keep_cycle_dirs", 2)),
        gate=PromotionGate(
            min_delta={
                k: float(v)
                for k, v in (promo.get("min_delta") or {}).items()
            },
            require_primary=bool(promo.get("require_primary", True)),
        ),
        observe=ObservePolicy(
            window_s=float(observe.get("window_s", 2.0)),
            poll_s=float(observe.get("poll_s", 0.25)),
            max_dispatch_errors=int(
                observe.get("max_dispatch_errors", 0)),
            max_error_burn=float(observe.get("max_error_burn", 0.0)),
            rollback_on_breaker=bool(
                observe.get("rollback_on_breaker", True)),
        ),
        stage_deadline_s={
            str(k).lower(): float(v)
            for k, v in (raw.get("stage_deadline_s") or {}).items()
        },
        max_consecutive_failures=int(
            raw.get("max_consecutive_failures", 3)),
        pin_vocabulary=bool(raw.get("pin_vocabulary", True)),
        ingest_kwargs=ingest,
        health=health_gate,
        device=device,
    )


def _make_server_factory(raw: dict, device: str = "cuda"):
    from photon_tpu_torch.obs.monitor import SloPolicy
    from photon_tpu_torch.pilot import PilotServer

    serve = raw.get("serve", {})
    slo_cfg = serve.get("slo", {})

    def make_server(model):
        return PilotServer(
            model,
            rungs=tuple(serve.get("rungs", (1, 8, 64))),
            max_linger_s=float(serve.get("max_linger_ms", 2.0)) / 1e3,
            breaker_threshold=serve.get("breaker_threshold", 8) or None,
            slo=SloPolicy(
                p99_ms=float(slo_cfg.get("p99_ms", 250.0)),
                error_rate=float(slo_cfg.get("error_rate", 0.001)),
                cold_entity_rate=float(
                    slo_cfg.get("cold_entity_rate", 0.2)),
                short_window_s=float(slo_cfg.get("window_s", 5.0)),
                long_window_s=12 * float(slo_cfg.get("window_s", 5.0)),
            ),
            device=device,
        )

    return make_server


def _traffic_loop(pilot, rate: float, stop, counts: dict) -> None:
    """Synthetic load against whatever generation is live, on its own
    thread for the daemon's whole life, so every promotion happens
    under traffic (``serve.driver.traffic_loop``); the counters are
    this thread's, read after the join."""
    from photon_tpu_torch.serve.driver import traffic_loop

    traffic_loop(
        lambda: pilot.server, rate, stop, counts,
        batch=max(int(rate / 4), 8),
    )


def _run(args) -> int:
    from photon_tpu_torch import obs
    from photon_tpu_torch.obs import fleet, flight, monitor
    from photon_tpu_torch.pilot import MODE_SERVE_ONLY, Pilot

    raw = _load_config(args)
    cfg = _build_pilot_config(raw, args.device)
    make_server = _make_server_factory(raw, args.device)

    was_enabled = obs.enabled()
    obs.reset()
    obs.enable()
    rec = None
    prior_rec = flight.installed()
    if not args.no_flight:
        rec = flight.install(args.flight_dir, signals=True)

    pilot = Pilot(cfg, server_factory=make_server)
    if args.reset_serve_only:
        pilot.reset_serve_only()
    # A restarted pilot serves the ring's LIVE generation from the first
    # second; a staged candidate stays unserved until PROMOTE resumes
    # and commits it.
    if pilot.server is None and pilot.ring.live is not None:
        pilot.server = make_server(
            pilot.ring.load(pilot.ring.live, pilot.device))

    mon = None
    if args.monitor_port is not None:
        def _readiness():
            server_up = pilot.server is not None
            breaker = bool(
                server_up and pilot.server.health()["breaker_open"]
            )
            return (server_up and not breaker), {
                "server_up": server_up,
                "breaker_open": breaker,
                "mode": pilot.state.mode,
                "stage": pilot.state.stage,
            }

        # Offset by the process index, so processes sharing a host do
        # not collide on one --monitor-port value.
        mon = monitor.MonitorServer(
            fleet.resolve_monitor_port(args.monitor_port),
            readiness=_readiness,
        ).start()
        logging.getLogger("photon.pilot").info(
            "monitor endpoints on port %d (/metrics /healthz /readyz)",
            mon.port)
        mon.add_collector(pilot.metrics_families)
        mon.add_collector(
            lambda: pilot.server.queue.metrics_families()
            if pilot.server is not None else []
        )

    stop = threading.Event()
    counts = {
        "served": 0, "errors": 0, "submit_errors": 0, "stranded": 0,
        "last_error": None,
    }
    traffic = None
    if args.traffic_qps:
        traffic = threading.Thread(
            target=_traffic_loop,
            args=(pilot, args.traffic_qps, stop, counts),
            name="pilot-traffic", daemon=True,
        )
        traffic.start()

    monitor_out = None
    try:
        summary = pilot.run_forever(
            poll_interval_s=args.poll_interval,
            max_cycles=args.max_cycles,
            idle_timeout_s=args.idle_timeout,
        )
    finally:
        stop.set()
        if traffic is not None:
            traffic.join(timeout=60.0)
        server_health = (
            pilot.server.health() if pilot.server is not None else None
        )
        if pilot.server is not None:
            pilot.server.close(timeout=30.0)
        if mon is not None:
            monitor_out = {"port": mon.port, **mon.scrape_stats()}
            mon.stop()
        if rec is not None:
            flight.uninstall()
            if prior_rec is not None:
                flight.reinstall(prior_rec)
        obs.TRACER.enabled = was_enabled

    state = pilot.state
    out = {
        "metric": "pilot",
        "stopped": summary.get("stopped"),
        "cycles": summary.get("cycles"),
        "mode": state.mode,
        "stage": state.stage,
        "promotions": state.promotions,
        "rollbacks": state.rollbacks,
        "refusals": state.refusals,
        "failures": state.failures,
        "deadline_overruns": state.deadline_overruns,
        "staleness_seconds": state.staleness_seconds,
        "last_promotion": state.last_promotion,
        "last_refusal": state.last_refusal,
        "last_rollback": state.last_rollback,
        "last_health": state.last_health,
        "generation_live": pilot.ring.live,
        "generations": [
            {k: e[k] for k in ("gen", "cycle", "created_at")}
            | {"rolled_back": bool(e.get("rolled_back"))}
            for e in pilot.ring.entries()
        ],
        "serving_reload_compile_events": (
            pilot.server.reload_compile_events
            if pilot.server is not None else None
        ),
        "health": server_health,
    }
    if args.traffic_qps:
        out["traffic"] = {"offered_qps": args.traffic_qps, **counts}
    if monitor_out is not None:
        out["monitor"] = monitor_out
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    # Exit-code contract for supervisors: serve-only degradation or
    # errored traffic must be visible to exit-code-only consumers.
    degraded = state.mode == MODE_SERVE_ONLY
    traffic_bad = counts["errors"] or counts["submit_errors"] \
        or counts["stranded"]
    return 1 if (degraded or traffic_bad) else 0


if __name__ == "__main__":
    sys.exit(main())
