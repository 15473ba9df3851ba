"""Compare two model/data-health sketches and render their drift (port
of ``photon_tpu/cli/health.py``).

The offline half of ``photon_tpu_torch.obs.health``: take two persisted
:class:`DataSketch` files — a streaming-ingest run's
``ingest-sketch.json`` (written beside the cursor when the health layer
is armed), a pilot work dir's ``pilot-health-sketch.json`` (either
package's pilot writes one; the sketch bytes are the same in both
packages), or a serve run's ``--health-sketch`` file (the sampled
traffic) — and render the PSI/KS/mean-shift comparison per column, per
feature shard and per top-moved feature. With ``--max-psi`` the
comparison gates: exit 1 when any compared distribution's PSI crosses
the ceiling.

Usage:
    python -m photon_tpu_torch.cli.health --a DAY1_WORK_DIR --b DAY2_WORK_DIR
    python -m photon_tpu_torch.cli.health --a ingest-sketch.json \
        --b serve-sketch.json --max-psi 0.25 [--json PATH]
    python -m photon_tpu_torch.cli.health --url http://127.0.0.1:9100

``--a``/``--b`` take a sketch file or a directory (a streaming ingest's
work dir: ``ingest-sketch.json`` is resolved inside, falling back to
``pilot-health-sketch.json``). ``--url`` scrapes a live monitor's
``/metrics`` and prints the ``health_*`` families.

Host JSON and numpy only: this never touches the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_SKETCH_BASENAMES = ("ingest-sketch.json", "pilot-health-sketch.json")


def resolve_sketch_path(path: str) -> str:
    """A sketch file, or a directory holding one of the well-known
    sketch files (a streaming ingest's work dir, a pilot work dir)."""
    if os.path.isdir(path):
        for base in _SKETCH_BASENAMES:
            cand = os.path.join(path, base)
            if os.path.exists(cand):
                return cand
        raise SystemExit(
            f"photon health: no sketch artifact under {path} "
            f"(looked for {', '.join(_SKETCH_BASENAMES)}); was the "
            "ingest run health-armed (obs.health.enable)?")
    if not os.path.exists(path):
        raise SystemExit(f"photon health: no such sketch {path}")
    return path


def scrape_health_families(url: str, timeout_s: float = 5.0) -> list[str]:
    """The ``health_*`` exposition lines of a live monitor."""
    from urllib.request import urlopen

    target = url.rstrip("/") + "/metrics"
    with urlopen(target, timeout=timeout_s) as resp:
        text = resp.read().decode("utf-8")
    return [
        line for line in text.splitlines()
        if "health_" in line.split(" ")[0].lstrip("#")
        or (line.startswith("# ") and " health_" in line)
    ]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="photon_tpu_torch.cli.health", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--a", dest="a", default=None, metavar="PATH",
                        help="baseline sketch (file or work dir)")
    parser.add_argument("--b", dest="b", default=None, metavar="PATH",
                        help="comparison sketch (file or work dir)")
    parser.add_argument("--max-psi", type=float, default=None,
                        help="gate: exit 1 when the comparison's max "
                             "PSI exceeds this ceiling")
    parser.add_argument("--top-k", type=int, default=10,
                        help="top moved features per shard (default 10)")
    parser.add_argument("--url", default=None, metavar="URL",
                        help="also scrape a live monitor and print its "
                             "health_* metric families")
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write the machine-readable report")
    args = parser.parse_args(argv)

    if args.a is None and args.b is None and args.url is None:
        parser.error("nothing to do: pass --a/--b and/or --url")
    if (args.a is None) != (args.b is None):
        parser.error("--a and --b come together (two sketches compare)")

    from photon_tpu_torch.obs import health

    out: dict = {"metric": "health"}
    rc = 0
    if args.a is not None:
        path_a = resolve_sketch_path(args.a)
        path_b = resolve_sketch_path(args.b)
        sketch_a = health.DataSketch.load(path_a)
        sketch_b = health.DataSketch.load(path_b)
        report = health.compare(sketch_a, sketch_b, top_k=args.top_k)
        out["a"] = path_a
        out["b"] = path_b
        out["comparison"] = report
        print(health.render_comparison(report))
        if args.max_psi is not None:
            out["max_psi_ceiling"] = args.max_psi
            out["gate_fired"] = report["max_psi"] > args.max_psi
            if out["gate_fired"]:
                print(
                    f"GATE: max PSI {report['max_psi']} > ceiling "
                    f"{args.max_psi:g} ({report['max_psi_surface']})")
                rc = 1
            else:
                print(
                    f"gate OK: max PSI {report['max_psi']} <= "
                    f"{args.max_psi:g}")
    if args.url is not None:
        lines = scrape_health_families(args.url)
        out["url"] = args.url
        out["live_families"] = lines
        print(f"== live health families ({args.url}) ==")
        if lines:
            print("\n".join(lines))
        else:
            print("(no health_* families — the layer is disarmed on "
                  "that server)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return rc


if __name__ == "__main__":
    sys.exit(main())
