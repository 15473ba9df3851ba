"""``python -m photon_tpu_torch.cli.profile``: the cost ledger's top-k
report, who burns the time (port of ``photon_tpu/cli/profile.py``).

Drives a tiny-but-real workload (a GLMix fit, whose random effect
launches the Newton kernel, plus a serve-ladder scoring pass, which
launches the serve kernel) under the cost ledger
(``photon_tpu_torch.obs.ledger``) and prints the top-k ``(coordinate,
phase, program)`` rows ranked by wasted-seconds-vs-roofline, each with
its blocking reason (dispatch gap, bandwidth, compute or
measured-only), plus the attribution fraction of the measured fit
wall. The fit is the fused fit (one CUDA-graph replay a fit on the
card, captured by the first, ledger-off fit), so its rows are
``fused_fit`` rows, split over the coordinates by
``FusedFit._attribute_seconds``, beside ``materialize``, the
``unattributed`` residual and the census rows of the Newton bucket
shapes the graph launches.

Three gates ride along:

- **off-census**: the same fit runs FIRST with the ledger disabled and
  the census must stay EMPTY: a disabled ledger adds zero programs (the
  warm-up also makes the overhead A/B honest);
- **engagement**: the top-k table must be non-empty and the fit wall
  must attribute to named rows (exit 1 otherwise: a dead instrument
  must not report "clean"); each kernel probe that ran must have its
  priced census row;
- **overhead** (``--overhead-check``): warm per-fit wall, ledger off vs
  on, an in-process A/B of N samples (each at least
  ``AB_SAMPLE_SECONDS`` of fits an arm, the arms alternating fit by
  fit); the median of the samples' on/off ratios must stay within 1 +
  ``--overhead-budget`` (default 5%).

Two probes launch one kernel each under the armed ledger and price it
by ``analysis/costmodel.py``: ``segment_sum.cu`` (8,192 values) and
``serve_score.cu`` (one 64-row rung of a small model). Each returns
None where its kernel does not run: on the CPU, or with its
``PHOTON_*_KERNEL`` switch off. On the card a probe whose kernel fails
to build or launch fails the run.

It runs on ``cuda`` unless ``--device cpu`` is given.

Usage:
    python -m photon_tpu_torch.cli.profile [--top N] [--json PATH]
        [--rows N] [--entities N] [--iterations N] [--fits N]
        [--overhead-check] [--overhead-samples N] [--overhead-budget F]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

import numpy as np
import torch


def _tiny_workload(rows: int, entities: int, iterations: int, *,
                   device="cuda"):
    """A miniature GLMix estimator and dataset (one dense fixed effect,
    one random effect, logistic task): the JAX package's
    ``cli.profile._tiny_workload``, the same data from the same seed.
    Its fit takes the fused path (no validation, listener or guard)."""
    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm.problems import (
        GLMOptimizationConfiguration,
    )
    from photon_tpu_torch.data.dataset import DenseFeatures
    from photon_tpu_torch.data.game_data import make_game_dataset
    from photon_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
    )
    from photon_tpu_torch.estimators.game_estimator import (
        FixedEffectCoordinateConfiguration,
        GameEstimator,
        RandomEffectCoordinateConfiguration,
    )
    from photon_tpu_torch.types import TaskType

    def l2(w):
        return GLMOptimizationConfiguration(
            regularization=optim.RegularizationContext(
                optim.RegularizationType.L2),
            regularization_weight=w,
        )

    d, du = 6, 4
    rng = np.random.default_rng(20260804)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    x[:, -1] = 1.0
    xu = rng.normal(size=(rows, du)).astype(np.float32)
    xu[:, -1] = 1.0
    users = rng.integers(0, entities, size=rows)
    y = (rng.uniform(size=rows) < 0.5).astype(np.float32)
    data = make_game_dataset(
        y,
        {"global": DenseFeatures(x), "userShard": DenseFeatures(xu)},
        id_tags={"userId": users},
        device=device,
    )
    est = GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {
            "global": FixedEffectCoordinateConfiguration(
                "global", l2(0.01)),
            "per-user": RandomEffectCoordinateConfiguration(
                RandomEffectDataConfiguration("userId", "userShard"),
                l2(0.5)),
        },
        intercept_indices={"global": d - 1, "userShard": du - 1},
        num_iterations=iterations,
        device=device,
    )
    return est, data


def _fit_once(est, data):
    """One blocking fit (a checksum of the coefficients copied to the
    host forces completion: enqueue times are not measurements)."""
    r = est.fit(data)[0]
    total = 0.0
    for _, m in r.model.items():
        glm = getattr(m, "model", None)
        c = glm.coefficients.means if glm is not None else m.coefficients
        total += float(c.sum())
    return r


def _serve_pass(result, data):
    """Score the training rows through the serve ladder: the tables,
    the ladder's rungs (each captured as a CUDA graph on the card: the
    rungs join the ledger's census and their captures its compile
    account) and ``score_dataset`` (one serve-kernel launch a chunk on
    the card)."""
    from photon_tpu_torch.serve.programs import (
        ScorePrograms,
        specs_from_dataset,
    )
    from photon_tpu_torch.serve.tables import CoefficientTables

    tables = CoefficientTables.from_game_model(result.model,
                                               device=data.device)
    programs = ScorePrograms(tables, specs=specs_from_dataset(data))
    return programs.score_dataset(data)


# The least time each arm of one A/B sample spans (at least 3 fits).
AB_SAMPLE_SECONDS = 1.0


def _overhead_ab(
    est, data, samples: int, fits_per_sample: int | None = None
) -> dict:
    """Warm fit wall, ledger off vs on: ``samples`` samples, each of
    ``fits_per_sample`` fits an arm with the arms alternating fit by
    fit (off, on, on, off, ...). By default a sample's arm holds as many
    fits as ``AB_SAMPLE_SECONDS`` does (from one warm fit timed first
    with the ledger off; at least 3).

    The overhead is the median of the samples' ratios (on over off)
    minus 1. On a shared host a fit's wall scatters by more than the
    ledger costs, and the scatter holds for some fits, so the best of
    each arm's series of batches (the JAX package's estimator) says
    which arm drew the quietest moment; fits of the two arms side by
    side share it, and a sample's ratio divides it out. Each arm's
    best sample is reported too."""
    from photon_tpu_torch.obs import ledger

    if fits_per_sample is None:
        ledger.disable()
        t0 = time.perf_counter()
        _fit_once(est, data)
        one = time.perf_counter() - t0
        fits_per_sample = max(3, math.ceil(AB_SAMPLE_SECONDS / one))
    k = max(fits_per_sample, 1)
    off: list[float] = []
    on: list[float] = []
    for _ in range(max(samples, 1)):
        arm = {False: 0.0, True: 0.0}
        for j in range(k):
            for armed in ((False, True) if j % 2 == 0 else (True, False)):
                (ledger.enable if armed else ledger.disable)()
                t0 = time.perf_counter()
                _fit_once(est, data)
                arm[armed] += time.perf_counter() - t0
        off.append(arm[False])
        on.append(arm[True])
    best_off, best_on = min(off), min(on)
    return {
        "samples": len(off),
        "fits_per_sample": k,
        "off_best_seconds": round(best_off, 6),
        "on_best_seconds": round(best_on, 6),
        "overhead_fraction": (
            round(statistics.median(b / a for a, b in zip(off, on))
                  - 1.0, 4) if best_off > 0 else None
        ),
    }


def _kernel_probe(device="cuda") -> dict | None:
    """One launch of the segment-sum kernel (``ops/segment_reduce``)
    under the armed ledger: registers its census row with
    ``costmodel.segment_sum_cost`` and records the measured window
    (launch to the result copied to the host), so the priced report
    carries the kernel's own roofline row. None where the kernel does
    not run (the CPU, or ``PHOTON_SEGMENT_KERNEL=off``)."""
    from photon_tpu_torch.obs import ledger
    from photon_tpu_torch.ops import segment_reduce as sr

    m = n = 8_192
    if (torch.device(device).type != "cuda"
            or not sr.kernel_supported(m, n, torch.float32)):
        return None
    ids = torch.arange(m, dtype=torch.int32, device=device)
    vals = torch.from_numpy(
        np.random.default_rng(0).normal(size=m).astype(np.float32)
    ).to(device)
    site = "segment_reduce/probe"
    sr.load()  # the build, outside the measured window
    torch.cuda.synchronize(device)
    before = sr.launches
    t0 = time.perf_counter()
    out = sr.sorted_segment_sum(vals, ids, n, multiplicity=1,
                                site=site).cpu().numpy()
    t1 = time.perf_counter()
    ledger.register_program(site, phase="score", cost=sr.site_cost(site))
    ledger.record_dispatch(
        site, t1 - t0, phase="score", start=t0, end=t1)
    return {
        "program": site,
        "elements": m,
        "segments": n,
        "launches": sr.launches - before,
        "seconds": round(t1 - t0, 6),
        "checksum": float(out.sum()),
    }


def _serve_kernel_probe(device="cuda") -> dict | None:
    """One launch of the serve kernel (``ops/serve_kernel``) under the
    armed ledger: a small model's tables, one 64-row rung scored
    through a one-rung ``ScorePrograms`` (an eager dispatch: no graph is
    captured), its census row priced by the rung's count
    (``ScorePrograms.rung_cost``). None where the kernel does not run
    (the CPU, or ``PHOTON_SERVE_KERNEL=off``)."""
    if torch.device(device).type != "cuda":
        return None
    from photon_tpu_torch.models.game import (
        FixedEffectModel,
        GameModel,
        RandomEffectModel,
    )
    from photon_tpu_torch.models.glm import (
        Coefficients,
        GeneralizedLinearModel,
    )
    from photon_tpu_torch.obs import ledger
    from photon_tpu_torch.ops import serve_kernel as sk
    from photon_tpu_torch.serve.programs import ScorePrograms, ShapeLadder
    from photon_tpu_torch.serve.tables import CoefficientTables
    from photon_tpu_torch.types import TaskType

    d, e, s, du, rung = 6, 16, 3, 4, 64
    rng = np.random.default_rng(20260806)
    proj = np.stack([
        np.sort(rng.choice(du, size=s, replace=False))
        for _ in range(e)
    ]).astype(np.int64)
    model = GameModel({
        "global": FixedEffectModel(
            GeneralizedLinearModel(
                Coefficients(means=torch.from_numpy(
                    rng.normal(size=d).astype(np.float32))),
                TaskType.LOGISTIC_REGRESSION,
            ),
            "features",
        ),
        "per-user": RandomEffectModel(
            coefficients=torch.from_numpy(
                rng.normal(size=(e, s)).astype(np.float32)),
            random_effect_type="userId",
            feature_shard_id="userShard",
            task=TaskType.LOGISTIC_REGRESSION,
            proj_all=proj,
            entity_keys=tuple(str(i) for i in range(e)),
        ),
    })
    tables = CoefficientTables.from_game_model(model, device=device)
    programs = ScorePrograms(tables, ladder=ShapeLadder((rung,)),
                             compile_now=False)
    if not programs.use_kernel:
        return None
    reqs = [
        (
            {
                "features": rng.normal(size=d).astype(np.float32),
                "userShard": rng.normal(size=du).astype(np.float32),
            },
            {"userId": str(i % e)},
        )
        for i in range(rung)
    ]
    feats, codes, _ = programs.pack_requests(reqs)
    torch.cuda.synchronize(device)
    before = sk.launches
    t0 = time.perf_counter()
    out = programs.dispatch_eager(feats, codes, rung).out.cpu().numpy()
    t1 = time.perf_counter()
    probe_site = "serve_kernel/probe"
    ledger.register_program(probe_site, phase="serve",
                            cost=programs.rung_cost(rung))
    ledger.record_dispatch(
        probe_site, t1 - t0, phase="serve", start=t0, end=t1)
    return {
        "program": probe_site,
        "rung": rung,
        "launches": sk.launches - before,
        "seconds": round(t1 - t0, 6),
        "checksum": float(out.sum()),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m photon_tpu_torch.cli.profile", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--top", type=int, default=5,
                        help="rows in the top-k table")
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write the full priced report to PATH")
    parser.add_argument("--rows", type=int, default=512,
                        help="workload rows")
    parser.add_argument("--entities", type=int, default=16,
                        help="random-effect entities")
    parser.add_argument("--iterations", type=int, default=2,
                        help="coordinate-descent iterations")
    parser.add_argument("--fits", type=int, default=3,
                        help="warm fits inside the measured window")
    parser.add_argument("--overhead-check", action="store_true",
                        help="A/B the warm fit ledger-off vs ledger-on "
                        "and gate the overhead fraction")
    parser.add_argument("--overhead-samples", type=int, default=25,
                        help="samples in the A/B")
    parser.add_argument("--overhead-budget", type=float, default=0.05,
                        help="max tolerated on/off overhead fraction")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from photon_tpu_torch import device as device_mod
    from photon_tpu_torch import obs
    from photon_tpu_torch.obs import ledger

    dev = device_mod.resolve(args.device)
    failures: list[str] = []
    obs.enable()
    ledger.disable()
    ledger.reset()

    est, data = _tiny_workload(args.rows, args.entities, args.iterations,
                               device=dev)
    # Gate 1 — off-census: the ledger-disabled run must register NOTHING.
    # Doubles as warm-up (the slabs are gathered, the fit's graph
    # captured), so the A/B and the attribution window below measure
    # warm fits.
    result = _fit_once(est, data)
    _serve_pass(result, data)
    off_snap = ledger.snapshot()
    if off_snap["programs"] or off_snap["rows"] or off_snap["compiles"]:
        failures.append(
            "ledger-disabled run polluted the census: "
            f"{len(off_snap['programs'])} program(s), "
            f"{len(off_snap['rows'])} row(s), "
            f"{len(off_snap['compiles'])} compile key(s)"
        )

    overhead = None
    if args.overhead_check:
        overhead = _overhead_ab(est, data, args.overhead_samples)
        ledger.reset()  # the A/B's on-arm rows are not the profile
        if (
            overhead["overhead_fraction"] is not None
            and overhead["overhead_fraction"] > args.overhead_budget
        ):
            failures.append(
                f"ledger-on overhead {overhead['overhead_fraction']:.2%}"
                f" > budget {args.overhead_budget:.2%} "
                f"(median on/off ratio of {overhead['samples']} samples)"
            )

    # The profiled window: warm fits + a serve pass, ledger armed.
    ledger.enable()
    mark = ledger.mark()
    t0 = time.perf_counter()
    for _ in range(max(args.fits, 1)):
        result = _fit_once(est, data)
    fit_wall = time.perf_counter() - t0
    # The fit-window attribution closes BEFORE the serve pass: serve
    # rows must not count as attributed fit seconds.
    fit_attr = ledger.attribution_since(mark, wall_seconds=fit_wall)
    _serve_pass(result, data)
    kernel_probe = _kernel_probe(dev)
    serve_kernel_probe = _serve_kernel_probe(dev)
    attribution = ledger.attribution_since(mark, wall_seconds=None)

    table = ledger.render_top_k(args.top)
    rows = ledger.top_k(args.top)
    print(table)
    if rows:
        worst = rows[0]
        print(
            f"worst program: {worst['program']} "
            f"(coordinate={worst['coordinate']}, phase={worst['phase']}) "
            f"— wasted {worst['wasted_seconds']:.4f}s vs its roofline, "
            f"blocking: {worst['blocking']}"
        )
    print(
        "fit-window attribution: "
        f"{fit_attr['attributed_fraction']} of {fit_wall:.4f}s named "
        f"({fit_attr['unattributed_seconds']:.4f}s unattributed)"
    )
    if overhead is not None:
        print(
            f"ledger overhead: {overhead['overhead_fraction']} "
            f"(median on/off ratio of {overhead['samples']} samples "
            f"of {overhead['fits_per_sample']} fits an arm; best off "
            f"{overhead['off_best_seconds']:.4f}s / on "
            f"{overhead['on_best_seconds']:.4f}s)"
        )

    # Gate 2 — engagement.
    if not rows:
        failures.append("top-k table is empty (no dispatches recorded)")
    if not fit_attr["attributed_fraction"]:
        failures.append("fit wall attributed nothing (ledger feed dead)")
    priced = ledger.report()["rows"]
    for probe, what in ((kernel_probe, "segment-sum"),
                        (serve_kernel_probe, "serve")):
        if probe is None:
            continue
        probe_rows = [r for r in priced
                      if r.get("program") == probe["program"]]
        if not probe_rows:
            failures.append(
                f"{what} kernel launched but its census row is missing "
                "from the priced report")
        elif probe_rows[0].get("vs_roofline") is None:
            failures.append(
                f"{what} kernel's census row carries no priced roofline "
                "(vs_roofline is None: analytic cost missing)")

    if args.json:
        doc = {
            "report": ledger.report(),
            "attribution": attribution,
            "fit_window": {
                "wall_seconds": round(fit_wall, 6),
                "fits": max(args.fits, 1),
                **fit_attr,
            },
            "overhead": overhead,
            "kernel_probe": kernel_probe,
            "serve_kernel_probe": serve_kernel_probe,
            "failures": failures,
        }
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2)
    for msg in failures:
        print(f"FAIL: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
