"""CLI: ``python -m photon_tpu_torch.analysis`` (port of
``photon_tpu/analysis/__main__.py``).

- ``--spmd``: the SPMD tier (analysis/spmd.py): the host-divergence lint
  over the port's package, then each ``SPMD_AUDIT`` contract's builder
  in ``--hosts N`` gloo ranks on the CPU (default: the contract's
  count), their censuses of collectives compared, and partition-rule
  coverage. ``--json`` prints the findings and the report as JSON.
- ``--semantic``: the program tier (analysis/program.py): every
  declared ``PROGRAM_AUDIT`` contract built on ``--device`` (default
  the card when there is one, which audits its real captures and
  kernels; ``cpu`` asks for the plain versions) and checked.
  ``--cost-out PATH`` writes its report (each program's signature, op
  count, syncs and launches) as JSON.
- ``--list-rules``: the tier's rules (with ``--spmd`` or
  ``--semantic``) or the tier-1 rules.

The reference's other tiers (the tier-1 lint over paths,
``--concurrency``, ``--memory``, ``--numerics``) are not ported (ROADMAP
Queue A item 13): their flags exit 2 naming it.

Exit codes: 0 clean (or only suppressed findings), 1 unsuppressed
findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys

from photon_tpu_torch.analysis.report import render_rule_list, render_text

UNPORTED_TIERS = ("concurrency", "memory", "numerics")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m photon_tpu_torch.analysis",
        description="static analysis of photon_tpu_torch")
    parser.add_argument("paths", nargs="*",
                        help="files or directories (the tier-1 lint, not "
                        "ported)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text", help="report format")
    parser.add_argument("--json", action="store_true",
                        help="same as --format json")
    parser.add_argument("--select", metavar="RULES",
                        help="comma-separated rule ids (tier 1)")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="include suppressed findings in text output")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rules and exit")
    for tier in UNPORTED_TIERS:
        parser.add_argument(f"--{tier}", action="store_true",
                            help="not ported (ROADMAP Queue A item 13)")
    parser.add_argument("--semantic", action="store_true",
                        help="run the program tier (PROGRAM_AUDIT "
                        "contracts: census, recompile keys, host "
                        "boundary, float64)")
    parser.add_argument("--device", choices=("cpu", "cuda"),
                        help="with --semantic: where the contracts' "
                        "programs are built (default cuda when a card is "
                        "present, else cpu)")
    parser.add_argument("--cost-out", metavar="PATH",
                        help="with --semantic: write the report as JSON")
    parser.add_argument("--spmd", action="store_true",
                        help="run the SPMD tier (rank censuses, "
                        "host-divergence lint, partition-rule coverage, "
                        "SPMD_AUDIT contracts)")
    parser.add_argument("--hosts", type=int, metavar="N",
                        help="with --spmd: run N gloo ranks (default: each "
                        "contract's declared count)")
    args = parser.parse_args(argv)
    if args.json:
        args.format = "json"

    if args.list_rules:
        if args.spmd:
            from photon_tpu_torch.analysis import spmd

            print(spmd.render_rule_list())
        elif args.semantic:
            from photon_tpu_torch.analysis import program

            print(program.render_rule_list())
        else:
            print(render_rule_list())
        return 0
    tiers = [t for t in UNPORTED_TIERS if getattr(args, t)]
    if len(tiers) + args.spmd + args.semantic > 1:
        print("--semantic, --concurrency, --memory, --numerics, and "
              "--spmd are separate tiers; run them as separate "
              "invocations", file=sys.stderr)
        return 2
    if args.hosts is not None and not args.spmd:
        print("--hosts requires --spmd", file=sys.stderr)
        return 2
    if (args.cost_out or args.device) and not args.semantic:
        print("--cost-out and --device require --semantic", file=sys.stderr)
        return 2
    if args.semantic:
        if args.paths or args.select:
            print("--semantic audits the package's declared program "
                  "contracts; paths/--select do not apply", file=sys.stderr)
            return 2
        return _run_semantic(args)
    if args.spmd:
        if args.paths or args.select:
            print("--spmd audits the package's declared SPMD contracts "
                  "(the lint half always covers the whole package); "
                  "paths/--select do not apply", file=sys.stderr)
            return 2
        if args.hosts is not None and args.hosts < 2:
            print("--hosts must be >= 2 (the cross-rank proof needs a "
                  "group)", file=sys.stderr)
            return 2
        return _run_spmd(args)
    from photon_tpu_torch import optim

    what = (f"the --{tiers[0]} tier" if tiers
            else "the tier-1 lint over paths")
    print(str(optim.not_ported(what, 13)), file=sys.stderr)
    return 2


def _run_semantic(args) -> int:
    from photon_tpu_torch.analysis import program

    findings, report = program.audit(device=args.device)
    if args.cost_out:
        with open(args.cost_out, "w") as f:
            json.dump(report, f, indent=2)
    if args.format == "json":
        print(json.dumps({"findings": [f.to_json() for f in findings],
                          "report": report}, indent=2))
    else:
        out = render_text(findings, show_suppressed=args.show_suppressed)
        if out:
            print(out)
        for cname, entry in report["contracts"].items():
            progs = ", ".join(
                f"{n}@{p['signature']}[{p['ops']} ops"
                + (f", {p['syncs']} syncs" if p["syncs"] else "") + "]"
                for n, p in entry["programs"].items())
            caps = (f"; {entry['captures']} CUDA graphs"
                    if "captures" in entry else "")
            print(f"contract {cname}: {progs or 'no programs'}{caps}")
            for note in entry["notes"]:
                print(f"  note: {note}")
        for cname, why in report["covered_elsewhere"].items():
            print(f"contract {cname}: {why}")
        deferred = ", ".join(c for cs in report["deferred"].values()
                             for c in cs)
        print(f"not yet ported (ROADMAP Queue A item "
              f"{program.DEFERRED_ITEM}): {deferred}")
    return 1 if any(not f.suppressed for f in findings) else 0


def _run_spmd(args) -> int:
    from photon_tpu_torch.analysis import spmd

    findings, report = spmd.audit(hosts=args.hosts)
    if args.format == "json":
        print(json.dumps({"findings": [f.to_json() for f in findings],
                          "report": report}, indent=2))
    else:
        out = render_text(findings, show_suppressed=args.show_suppressed)
        if out:
            print(out)
        for cname, entry in report["contracts"].items():
            fits = ", ".join(
                f"{n}@{'ok' if p['identical'] else 'DIVERGENT'}"
                f"[{p['collectives']} collectives: "
                + ", ".join(f"{s} {k}" for s, k in p["sites"].items())
                + "]" for n, p in entry["fits"].items())
            print(f"contract {cname} ({entry['hosts']} hosts): "
                  f"{fits or 'no fits ran'}")
            cov = entry.get("coverage")
            if cov:
                print(f"  coverage: {cov['leaves']} leaves / "
                      f"{cov['rules']} rules"
                      + (f"; UNCOVERED: {', '.join(cov['uncovered'])}"
                         if cov["uncovered"] else ""))
            for note in entry["notes"]:
                print(f"  note: {note}")
    return 1 if any(not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
