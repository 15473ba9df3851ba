"""``python -m photon_tpu_torch.cli.benchtrend``: gate a bench
history, not just static floors (port of
``photon_tpu/cli/benchtrend.py``).

It reads a series of ``BENCH_r*.json`` rounds, prints a per-metric
trend table, and exits nonzero when the LATEST round regresses beyond a
declared tolerance against the TRAILING BEST (the best value any prior
round achieved).

Rules:

- A tracked metric absent from every round is skipped.
- No prior round carrying the metric means nothing to gate (a newly
  added metric starts its history).
- A metric present in the PREVIOUS round but missing from the latest is
  a regression in itself (a dead gauge).
- Otherwise: ``higher``-is-better metrics regress when
  ``latest < best_prior / tolerance``; ``lower``-is-better when
  ``latest > best_prior * tolerance``.
- The latest round's own embedded ``regressions`` list (floor
  violations the bench measured in-run) GATES too, unless each entry is
  waived with a written reason (``WAIVED_REGRESSIONS`` / ``--waive
  PATTERN=REASON``).

The ``MULTICHIP_r*.json`` series (the fleet straggler rows
``obs.fleet.multichip_row`` writes) gates as a second trend table over
``MULTICHIP_TRACKED``; rounds that carry no tracked key contribute
nothing to it.

The tracked names and tolerances are the JAX package's, kept as they
are so one history reads the same under both; the port has no bench of
its own yet (ROADMAP). A host file tool: it imports no torch.

Usage:
    python -m photon_tpu_torch.cli.benchtrend [--dir .] [--json PATH]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

# metric -> (direction, tolerance, fallback keys tried in order after
# the primary). Directions: "higher" / "lower" is better.
TRACKED: dict[str, tuple[str, float, tuple[str, ...]]] = {
    "logistic_rows_per_sec": ("higher", 1.5, ()),
    "linear_rows_per_sec": ("higher", 1.5, ()),
    "logistic_ingest_rows_per_sec_best": (
        "higher", 1.5, ("logistic_ingest_rows_per_sec",)
    ),
    "logistic_compile_seconds": ("lower", 1.5, ()),
    "logistic_e2e_seconds": ("lower", 1.5, ()),
    "logistic_warm_cache_e2e_seconds": ("lower", 1.5, ()),
    # The roofline-push ratchet (ROADMAP item 2, round 15+): the ratio
    # is measured fit wall over the static roofline bound — LOWER is
    # closer to the chip's best case, and the trailing-best gate locks
    # each round's win in (the FLOORS ceiling only caps the absolute
    # worst case; this line is what makes an improvement permanent).
    "logistic_measured_vs_roofline": ("lower", 1.5, ()),
    # Achieved HBM throughput of the standalone segment-reduce kernel
    # dispatch (bench run_kernel_micro; absent on backends the kernel
    # does not serve — an absent-from-all-history metric is skipped,
    # but once a TPU round reports it, a silent die fails the trend).
    "segment_reduce_bytes_per_sec": ("higher", 1.5, ()),
    "serving_p99_ms": ("lower", 1.5, ()),
    "serving_qps": ("higher", 1.5, ()),
    # Serve-latency roofline push (round 18+): the host-gap share of
    # the serve dispatch rows' accounted wall — what the double-
    # buffered staging pipeline exists to shrink. Bounded by 1.0, so
    # the 1.5x band is a real ratchet once the fraction lands; the
    # serial baseline (`serving_dispatch_gap_fraction_serial`) rides
    # the JSON untracked for the side-by-side.
    "serving_dispatch_gap_fraction": ("lower", 1.5, ()),
    # Achieved HBM throughput of the fused serve-score kernel at the
    # top rung (bench run_serve_kernel_micro; absent off-TPU — same
    # skip-until-first-report policy as segment_reduce_bytes_per_sec).
    "serve_kernel_bytes_per_sec": ("higher", 1.5, ()),
    # Streaming scenario (round 10+, photon_tpu.data.stream): the
    # day-over-day warm-start retrain throughput and the out-of-core
    # ingest rate — a streaming-throughput regression fails the trend
    # gate the round it happens, same policy as the serving block.
    "streaming_incremental_rows_per_sec": ("higher", 1.5, ()),
    "streaming_ingest_rows_per_sec": ("higher", 1.5, ()),
    # Pilot control loop (round 11+, photon_tpu.pilot): staleness is
    # shard-landed -> model-serving seconds for the multi-day replay,
    # and the promotion count is the "did the loop keep promoting"
    # dead-man switch — a pilot that silently stops promoting, or whose
    # data-to-serving latency regresses >1.5x, fails the trend gate the
    # round it happens.
    "pilot_staleness_seconds": ("lower", 1.5, ()),
    "pilot_promotions": ("higher", 1.5, ()),
    # Cost-ledger attribution (round 12+, photon_tpu.obs.ledger): the
    # fraction of the measured steady-state fit wall attributed to
    # named (coordinate, phase, program) rows. Tracked HERE and only
    # here (tools/bench_trend.py was deleted for exactly this reason):
    # a ledger that silently starts naming less of the wall regresses
    # the round it happens. Tight tolerance — the fraction is bounded
    # by 1.0, so a 1.5x ratchet could never fire.
    "logistic_attributed_fraction": ("higher", 1.1, ()),
    "linear_attributed_fraction": ("higher", 1.1, ()),
    # HBM admission join (round 16+, photon_tpu.analysis.memory): the
    # MEASURED resident watermarks the ledger booked for the fused fit's
    # slab set and the serving tables — the tier-4 oracle predicts both
    # statically and bench gates the predicted/measured ratio in-run;
    # tracking the measured bytes here makes residency growth itself
    # (a model that quietly starts needing more HBM at the same
    # workload) fail the trend gate the round it happens.
    "fused_fit_peak_hbm_bytes": ("lower", 1.5, ()),
    "serving_peak_hbm_bytes": ("lower", 1.5, ()),
    # Mixed-precision parity (round 17+, tier-5 numerics): the measured
    # max relative coefficient error of the bf16 fused fit vs the f32
    # reference, per GLM family (bench run_parity). The fixed per-family
    # tolerances live in tests/test_precision.py and PERFORMANCE.md —
    # this line gates the TREND underneath them, so a parity gap that
    # quietly widens (new cast, changed solver routing) fails the round
    # it moves, long before it reaches the fixed ceiling. Lower is
    # better; 1.5x matches the tier-5 NUMERICS_AUDIT budget band.
    "parity_gap_linear": ("lower", 1.5, ()),
    "parity_gap_logistic": ("lower", 1.5, ()),
    "parity_gap_poisson": ("lower", 1.5, ()),
    "parity_gap_smoothed_hinge": ("lower", 1.5, ()),
}

# The MULTICHIP_r*.json series (round 19+, photon_tpu.obs.fleet): the
# multiprocess dryrun's straggler report, gated as its own trend table.
# Rounds r01-r05 predate the fleet layer and carry only rc/tail capture
# blobs — no tracked key appears in them, so the series starts the
# round the gauges first land (the absent-from-all-history skip and the
# new-metric rule both tolerate the old schema by construction; the
# dead-gauge rule arms only once a round has reported). Both gauges are
# bounded small numbers, so the tolerances are absolute-ish bands, not
# throughput ratios: skew is seconds of max-min attributed dispatch
# wall across ranks, fraction is the share of the fleet's rank-seconds
# spent waiting at the barrier.
MULTICHIP_TRACKED: dict[str, tuple[str, float, tuple[str, ...]]] = {
    "multichip_straggler_skew_seconds": (
        "lower", 3.0, ("straggler_skew_seconds",)
    ),
    "multichip_collective_fraction": (
        "lower", 3.0, ("collective_fraction",)
    ),
    # Round 20+: the dryrun's merged wall clock (fallback reaches into
    # the nested report for rows written before the flat gauge landed —
    # fallback keys may be dotted paths), the hosts-reporting count, and
    # the static collective count the tier-6 census attached
    # (fleet.crosscheck_collective_census). Hosts-reporting gates at
    # 1.0x: ANY drop from the trailing best means a rank stopped
    # shipping bundles — the fleet-side signature of the deadlock the
    # --spmd collective-order rule proves against statically (CI pins
    # the dryrun at 2 processes; an intentional fleet resize is a
    # rebaseline, not noise). Collective count gates one-sided on
    # growth: a new collective in the dryrun program is a new fleet
    # barrier and should arrive with a contract change, not silently.
    "multichip_wall_seconds": (
        "lower", 3.0, ("report.wall_seconds",)
    ),
    "multichip_hosts_reporting": (
        "higher", 1.0, ("bundles",)
    ),
    "multichip_collective_count": (
        "lower", 1.0, ("report.collective_census.count",)
    ),
}

# Waivers for BENCH-REPORTED regressions (the `regressions` list a
# bench run embeds in its own output line). A populated list in the
# LATEST round fails the trend gate — BENCH_r05 carried
# `ingest_rows_per_sec 510028 < 1000000` yet the run exited 0 and the
# entry sat unread for two rounds, which is exactly the
# advisory-not-gating rot this tool exists to kill. Waivers are
# SUBSTRING patterns with a REQUIRED written reason (the same
# reasoned-suppression convention every analysis tier uses); matched
# entries render as `waived:` rows instead of failing. `--waive
# PATTERN=reason` adds run-local ones.
WAIVED_REGRESSIONS: dict[str, str] = {
    "ingest_rows_per_sec 510028 < 1000000": (
        "re-baselined in round 13: the 1.0e6 floor was calibrated on "
        "the round-3 container; rounds 4-5 measured 400-510k on the "
        "CI-class 2-core box, so bench FLOORS now ratchets ~1.5x off "
        "the round-5 best (3.4e5) — justification in CHANGES.md"
    ),
}


def load_round(path: str) -> dict | None:
    """One round's bench line. Round-capture files wrap the line under
    ``parsed`` (next to cmd/rc/tail); a raw bench output line is taken
    as-is. Unparseable files are reported as None, never a crash — a
    corrupt capture must not take the trend gate down with it."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if isinstance(doc, dict) and isinstance(doc.get("parsed"), dict):
        return doc["parsed"]
    return doc if isinstance(doc, dict) else None


def load_series(
    dirpath: str, pattern: str, strip_prefix: str
) -> tuple[list[tuple[str, dict]], list[str]]:
    """Ordered (label, parsed) rounds for one history glob, plus the
    labels of files that would not parse (reported, never fatal)."""
    rounds: list[tuple[str, dict]] = []
    skipped: list[str] = []
    for p in sorted(glob.glob(os.path.join(dirpath, pattern))):
        parsed = load_round(p)
        label = os.path.splitext(os.path.basename(p))[0].replace(
            strip_prefix, ""
        )
        if parsed is None:
            skipped.append(label)
            continue
        rounds.append((label, parsed))
    return rounds, skipped


def metric_value(
    parsed: dict,
    name: str,
    tracked: dict[str, tuple[str, float, tuple[str, ...]]] | None = None,
) -> float | None:
    _, _, fallbacks = (tracked or TRACKED)[name]
    for key in (name, *fallbacks):
        # Fallback keys may be dotted paths ("report.wall_seconds") that
        # walk nested dicts — multichip rows carry the merged fleet
        # report inline, and its gauges predate the flat top-level ones.
        v: object = parsed
        for part in key.split("."):
            v = v.get(part) if isinstance(v, dict) else None
            if v is None:
                break
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    return None


def analyze(
    rounds: list[tuple[str, dict]],
    waivers: dict[str, str] | None = None,
    tracked: dict[str, tuple[str, float, tuple[str, ...]]] | None = None,
) -> dict:
    """Trend rows + regressions for an ordered (label, parsed) series.

    ``waivers`` (pattern -> reason) extends ``WAIVED_REGRESSIONS`` for
    the bench-reported gate below. ``tracked`` selects the gauge table
    (default the bench ``TRACKED`` set; the multichip pass hands in
    ``MULTICHIP_TRACKED``)."""
    tracked = TRACKED if tracked is None else tracked
    out: dict = {"rounds": [label for label, _ in rounds], "metrics": {},
                 "regressions": [], "waived": []}
    if not rounds:
        out["regressions"].append("no bench history found")
        return out
    latest_label = rounds[-1][0]
    # Bench-reported regressions GATE: the latest round's own
    # `regressions` list (floor violations the bench measured in-run)
    # fails the trend check unless each entry carries a reasoned
    # waiver — an exit-0 bench with a populated list is no longer
    # advisory.
    all_waivers = dict(WAIVED_REGRESSIONS)
    all_waivers.update(waivers or {})
    embedded = rounds[-1][1].get("regressions")
    if isinstance(embedded, list):
        for entry in embedded:
            entry = str(entry)
            reason = next(
                (r for pat, r in all_waivers.items() if pat in entry),
                None,
            )
            if reason is not None:
                out["waived"].append({"entry": entry, "reason": reason})
            else:
                out["regressions"].append(
                    f"{latest_label} bench-reported: {entry}"
                )
    for name, (direction, tol, _) in tracked.items():
        series = [
            metric_value(parsed, name, tracked) for _, parsed in rounds
        ]
        if all(v is None for v in series):
            continue
        prior = [v for v in series[:-1] if v is not None]
        latest = series[-1]
        best_prior = (
            None if not prior
            else (max(prior) if direction == "higher" else min(prior))
        )
        status = "ok"
        if latest is None:
            if series[:-1] and series[-2] is not None:
                status = "missing"
                out["regressions"].append(
                    f"{name}: tracked metric present in the previous "
                    f"round but missing from {latest_label} (dead gauge)"
                )
            else:
                status = "n/a"
        elif best_prior is None:
            status = "new"
        elif direction == "higher" and latest < best_prior / tol:
            status = "REGRESSED"
            out["regressions"].append(
                f"{name}: {latest:g} < trailing best {best_prior:g} "
                f"/ {tol:g} (higher is better)"
            )
        elif direction == "lower" and latest > best_prior * tol:
            status = "REGRESSED"
            out["regressions"].append(
                f"{name}: {latest:g} > trailing best {best_prior:g} "
                f"x {tol:g} (lower is better)"
            )
        out["metrics"][name] = {
            "direction": direction,
            "tolerance": tol,
            "series": series,
            "trailing_best": best_prior,
            "latest": latest,
            "status": status,
        }
    return out


def render_table(report: dict) -> str:
    labels = report["rounds"]
    head = ["metric", "dir", *labels, "best<", "status"]
    rows = [head]
    for name, m in report["metrics"].items():
        rows.append([
            name,
            m["direction"][0] + "^" if m["direction"] == "higher"
            else m["direction"][0] + "v",
            *[
                "-" if v is None else f"{v:g}" for v in m["series"]
            ],
            "-" if m["trailing_best"] is None
            else f"{m['trailing_best']:g}",
            m["status"],
        ])
    widths = [max(len(r[i]) for r in rows) for i in range(len(head))]
    return "\n".join(
        "  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
        for row in rows
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m photon_tpu_torch.cli.benchtrend", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--dir", default=".",
                        help="directory holding the BENCH_r*.json series")
    parser.add_argument("--pattern", default="BENCH_r*.json",
                        help="history glob (lexicographic order = "
                             "round order)")
    parser.add_argument("--multichip-pattern",
                        default="MULTICHIP_r*.json",
                        help="multichip straggler history glob (same "
                             "--dir; rounds r01-r05 predate the fleet "
                             "gauges and are tolerated as empty)")
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write the machine-readable trend "
                             "report to PATH")
    parser.add_argument("--waive", action="append", default=[],
                        metavar="PATTERN=REASON",
                        help="waive a bench-reported regression whose "
                             "text contains PATTERN (a reason is "
                             "REQUIRED — same convention as analysis-"
                             "tier suppressions); repeatable")
    args = parser.parse_args(argv)

    waivers: dict[str, str] = {}
    for spec in args.waive:
        pattern, sep, reason = spec.partition("=")
        if not sep or not pattern or not reason.strip():
            parser.error(
                f"--waive {spec!r}: use PATTERN=REASON (the reason is "
                "required)")
        waivers[pattern] = reason.strip()

    rounds, skipped = load_series(args.dir, args.pattern, "BENCH_")

    report = analyze(rounds, waivers=waivers)
    if skipped:
        report["skipped_unparseable"] = skipped
    print(render_table(report))
    for w in report.get("waived", ()):
        print(f"waived: {w['entry']} ({w['reason']})")

    # Second pass: the multichip straggler series. Absent history is
    # fine (single-host checkouts carry no MULTICHIP_r*.json) — the
    # gate only arms once the fleet dryrun has committed a row.
    mc_rounds, mc_skipped = load_series(
        args.dir, args.multichip_pattern, "MULTICHIP_"
    )
    mc_report: dict | None = None
    if mc_rounds:
        mc_report = analyze(
            mc_rounds, waivers=waivers, tracked=MULTICHIP_TRACKED
        )
        if mc_skipped:
            mc_report["skipped_unparseable"] = mc_skipped
        report["multichip"] = mc_report
        if mc_report["metrics"]:
            print("-- multichip (MULTICHIP_r*.json) --")
            print(render_table(mc_report))
        report["regressions"].extend(
            f"multichip: {reg}" for reg in mc_report["regressions"]
        )

    for reg in report["regressions"]:
        print(f"REGRESSION: {reg}")
    if not report["regressions"]:
        print(
            f"trend OK across {len(rounds)} bench + "
            f"{len(mc_rounds)} multichip round(s)"
        )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return 1 if report["regressions"] else 0


if __name__ == "__main__":
    sys.exit(main())
