"""``python -m photon_tpu_torch.cli.fleetview`` — merge per-rank obs
bundles (port of ``photon_tpu/cli/fleetview.py``).

The read side of the fleet layer (``obs/fleet.py``): point it at the
shared run directory the ranks shipped their ``obs-host-<k>/`` bundles
into and it produces

- ONE Perfetto-loadable timeline (``--trace``; pid per rank, every
  host's events shifted onto the shared epoch clock through its own
  clock-alignment handshake, ``validate_chrome_trace``-clean),
- the fleet ledger rollup + straggler report (printed; ``--json`` writes
  the full report): per-rank attributed dispatch seconds, per-program
  max−min window skew, the slowest rank, the collective-vs-compute
  split of barrier wait, and the clock skew bound the cross-host
  ordering is trusted to.

It reads the JAX package's bundles as well as the port's (one schema;
the host block names ``jax_version`` or ``torch_version``), and runs on
the host only. Degradation is visible, never fatal: a crashed rank's torn spans.jsonl,
an uncommitted bundle, or a missing rank land in the report's ``gaps``
and the merge proceeds over what exists. Exit codes: 0 merged clean,
1 merged with gaps or a ``--expect-ranks`` mismatch, 2 nothing to merge.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from photon_tpu_torch.cli.common import cli_logging

logger = logging.getLogger("photon.cli.fleetview")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m photon_tpu_torch.cli.fleetview",
        description=(
            "Merge per-rank obs bundles (obs-host-<k>/) into one "
            "Perfetto timeline + a fleet straggler report."
        ),
    )
    p.add_argument(
        "--run-dir", required=True,
        help="shared run directory the ranks shipped bundles into",
    )
    p.add_argument(
        "--trace", default=None, metavar="PATH",
        help="write the merged chrome-trace timeline here "
        "(default: <run-dir>/fleet-trace.json)",
    )
    p.add_argument(
        "--json", default=None, metavar="PATH",
        help="write the full straggler report as JSON",
    )
    p.add_argument(
        "--expect-ranks", type=int, default=None, metavar="N",
        help="fail (exit 1) unless exactly N rank bundles merged",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def render_report(report: dict) -> str:
    """The human view of a straggler report."""
    rows = [
        "== fleet straggler report ==",
        f"bundles {report['bundles']}/{report['process_count']} "
        f"rank(s) {report['ranks']}"
        + (
            f"  MISSING {report['missing_ranks']}"
            if report["missing_ranks"] else ""
        ),
        f"wall {report['wall_seconds']:.4f}s  "
        f"straggler skew {report['straggler_skew_seconds']:.4f}s  "
        f"collective fraction {report['collective_fraction']:.4f}  "
        f"clock bound {report['clock_skew_bound_seconds']:.2e}s",
    ]
    if report.get("straggler"):
        s = report["straggler"]
        rows.append(
            f"slowest rank: {s['process_index']} "
            f"({s['attributed_seconds']:.4f}s attributed)"
        )
    rows.append(
        "-- per rank (attributed s / collective wait s / dispatches) --"
    )
    for r in report["per_rank"]:
        rows.append(
            f"  rank {r['process_index']:<3} {r['hostname'] or '?':<20} "
            f"{r['attributed_seconds']:>10.4f} "
            f"{r['collective_wait_seconds']:>10.4f} "
            f"{r['dispatches']:>6}"
        )
    progs = report.get("programs") or {}
    shared = {
        name: e for name, e in progs.items() if e.get("on_all_ranks")
    }
    if shared:
        rows.append("-- programs on all ranks (window skew s) --")
        for name, e in sorted(shared.items()):
            skew = e.get("window_skew_seconds", e.get("seconds_skew"))
            rows.append(
                f"  {name:<28} "
                f"{'-' if skew is None else f'{skew:.4f}':>10}"
                + (
                    f"  slowest rank {e['slowest_rank']}"
                    if "slowest_rank" in e else ""
                )
            )
    for gap in report.get("gaps", ()):
        rows.append(f"GAP: {gap}")
    return "\n".join(rows)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from photon_tpu_torch.obs import fleet

    with cli_logging(args.verbose, None):
        trace_path = args.trace or os.path.join(
            args.run_dir, "fleet-trace.json"
        )
        report, _trace_doc = fleet.merge_run(
            args.run_dir, trace_path=trace_path
        )
        if not report["bundles"]:
            print(render_report(report))
            print(f"fleetview: no bundles under {args.run_dir}")
            return 2
        if args.json:
            with open(args.json, "w") as f:
                json.dump(report, f, indent=1)
        print(render_report(report))
        print(f"merged timeline: {trace_path}")
        if (
            args.expect_ranks is not None
            and report["bundles"] != args.expect_ranks
        ):
            print(
                f"fleetview: expected {args.expect_ranks} rank "
                f"bundle(s), merged {report['bundles']}"
            )
            return 1
        return 1 if report["gaps"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
