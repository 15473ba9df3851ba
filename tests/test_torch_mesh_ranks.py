"""The port's mesh on real ranks: spawned gloo processes on the CPU.

Each test starts its ranks as subprocesses (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR=127.0.0.1`` and a free ``MASTER_PORT``, as ``torchrun``
exports them), waits for them at most ``SPAWN_LIMIT`` seconds, and kills
them and fails past it, so a hang never holds the test run. The ranks
run this file as a script (``rank_main``): it imports the port only.

Tolerances:
- mesh fits (float64) against the JAX package's ``GameEstimator(mesh=
  "auto")`` on the conftest's 8-device CPU mesh and against the port's
  single-process fit: rtol 1e-7, atol 1e-9 on coefficients, the
  reference's own mesh tolerance (``tests/test_estimator_mesh.py``);
  the primary evaluation within rtol 1e-7. The sums cross the ranks in
  another order, nothing else differs;
- two mesh fits, and every rank's model against rank 0's: bit for bit;
- ``cli.train`` (float32) against the reference's ``mesh: auto`` run:
  rtol 1e-4, atol 2e-5, the reference's f32 CLI tolerance;
- ``cli.score --mesh auto`` against a single process's scores: 1e-6.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Seconds a spawned test waits for all of its ranks.
SPAWN_LIMIT = 150
RTOL, ATOL = 1e-7, 1e-9


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv, world: int, cwd, *, rank_env=None, limit=SPAWN_LIMIT):
    """Run ``argv(rank)`` in ``world`` processes of one gloo group;
    returns ``[(returncode, stdout, stderr)]`` in rank order. Past
    ``limit`` seconds every rank is killed and the test fails."""
    port = _free_port()
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ)
        env.update(
            RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
            LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(port), OMP_NUM_THREADS="1",
            PHOTON_DIST_TIMEOUT_SECONDS="60",
            PYTHONPATH=os.pathsep.join(
                [REPO] + [p for p in [env.get("PYTHONPATH")] if p]))
        env.update((rank_env or {}).get(r, {}))
        out = open(os.path.join(cwd, f"rank{r}.out"), "w+")
        err = open(os.path.join(cwd, f"rank{r}.err"), "w+")
        logs.append((out, err))
        procs.append(subprocess.Popen(argv(r), env=env, cwd=cwd,
                                      stdout=out, stderr=err))
    deadline = time.monotonic() + limit
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{world} ranks did not end within {limit} s")
    results = []
    for p, (out, err) in zip(procs, logs):
        out.seek(0)
        err.seek(0)
        results.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return results


def _assert_ok(results):
    for r, (rc, _, err) in enumerate(results):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"


# ---------------------------------------------------------------------------
# the fit cases: numpy data and coordinates both packages build
# ---------------------------------------------------------------------------


def linear_arrays(rng, n=237, d=6, num_entities=11):
    """``tests/test_estimator_mesh.py``'s ``_glmix_game`` as arrays."""
    x = rng.normal(size=(n, d))
    x[:, -1] = 1.0
    entities = rng.integers(0, num_entities, size=n)
    w_fixed = rng.normal(size=d)
    w_re = 0.5 * rng.normal(size=(num_entities, d))
    z = x @ w_fixed + np.einsum("nd,nd->n", x, w_re[entities])
    y = z + 0.1 * rng.normal(size=n)
    return {"y": y, "x": x,
            "userId": np.asarray([f"u{e}" for e in entities])}


def linear_case(tmp_path):
    rng = np.random.default_rng(20260729)  # the conftest's rng seed
    train, val = linear_arrays(rng), linear_arrays(rng, n=101)
    np.savez(tmp_path / "linear.npz", **train)
    np.savez(tmp_path / "linear_val.npz", **val)
    return {
        "name": "linear", "task": "LINEAR_REGRESSION",
        "data": str(tmp_path / "linear.npz"),
        "validation": str(tmp_path / "linear_val.npz"),
        "shards": {"features": ["dense", "x"]}, "tags": ["userId"],
        "coords": [["global", "fixed", "features", 0.5],
                   ["per-user", "re", {"random_effect_type": "userId",
                                       "feature_shard_id": "features"},
                    0.5]],
        "intercepts": {"features": 5}, "iterations": 2,
    }


def synth_case(tmp_path, task, *, sparse_fe=False, n=800):
    """``test_torch_train.synth`` data: a logistic or Poisson GLMix on
    the lazy layout (Newton buckets, their plain route in float64), or
    with ``sparse_fe`` an ELL fixed effect beside a per-movie effect."""
    from test_torch_train import DU, MOVIE, USER, synth

    a = synth(seed=21, task=task, n=n)
    arrays = {"y": a["y"], "x": a["x"], "xu": a["xu"], "xm": a["xm"],
              "userId": a["users"], "movieId": a["movies"]}
    shards = {"global": ["dense", "x"], "movieShard": ["dense", "xm"]}
    if sparse_fe:
        idx = np.tile(np.arange(DU, dtype=np.int32), (n, 1))
        idx[:, 0] = np.where(a["users"] % 2 == 0, 0, DU + 1)
        arrays["xu_idx"] = idx
        shards["userShard"] = ["sparse", "xu_idx", "xu", DU + 2]
        coords = [["global", "fixed", "userShard", 1e-3],
                  ["per-movie", "re", MOVIE, 0.5]]
    else:
        shards["userShard"] = ["dense", "xu"]
        coords = [["global", "fixed", "global", 1e-3],
                  ["per-user", "re", USER, 1.0]]
    name = f"{task}{'_sparse' if sparse_fe else ''}"
    np.savez(tmp_path / f"{name}.npz", **arrays)
    return {
        "name": name,
        "task": ("LOGISTIC_REGRESSION" if task == "logistic"
                 else "POISSON_REGRESSION"),
        "data": str(tmp_path / f"{name}.npz"), "validation": None,
        "shards": shards, "tags": ["userId", "movieId"], "coords": coords,
        "intercepts": {"global": 5, "userShard": DU - 1, "movieShard": 2},
        "iterations": 2,
    }


def build_dataset(pkg: str, path: str, shards: dict, tags: list):
    """The case's GameDataset in the port (``pt``, float64 on the CPU)
    or the JAX package (``jax``, float64)."""
    arrays = np.load(path)
    if pkg == "pt":
        import torch

        from photon_tpu_torch.data import dataset as ds_mod
        from photon_tpu_torch.data.game_data import make_game_dataset

        kw = {"dtype": torch.float64, "device": "cpu"}
    else:
        import jax.numpy as jnp

        from photon_tpu.data import dataset as ds_mod
        from photon_tpu.data.game_data import make_game_dataset

        kw = {"dtype": jnp.float64}
    feats = {}
    for name, spec in shards.items():
        if spec[0] == "dense":
            feats[name] = ds_mod.DenseFeatures(arrays[spec[1]])
        else:
            feats[name] = ds_mod.SparseFeatures(arrays[spec[1]],
                                                arrays[spec[2]], spec[3])
    return make_game_dataset(arrays["y"], feats,
                             id_tags={t: arrays[t] for t in tags}, **kw)


def build_estimator(pkg: str, case: dict, mesh):
    """The case's GameEstimator in either package, on ``mesh``."""
    if pkg == "pt":
        from photon_tpu_torch import optim
        from photon_tpu_torch.algorithm.problems import (
            GLMOptimizationConfiguration,
        )
        from photon_tpu_torch.data.random_effect import (
            RandomEffectDataConfiguration,
        )
        from photon_tpu_torch.estimators import game_estimator as est
        from photon_tpu_torch.types import TaskType

        extra = {"device": "cpu"}
    else:
        from photon_tpu import optim
        from photon_tpu.algorithm.problems import (
            GLMOptimizationConfiguration,
        )
        from photon_tpu.data.random_effect import (
            RandomEffectDataConfiguration,
        )
        from photon_tpu.estimators import game_estimator as est
        from photon_tpu.types import TaskType

        extra = {}
    cfgs = {}
    for cid, kind, spec, weight in case["coords"]:
        opt = GLMOptimizationConfiguration(
            regularization=optim.RegularizationContext(
                optim.RegularizationType.L2),
            regularization_weight=weight)
        if kind == "fixed":
            cfgs[cid] = est.FixedEffectCoordinateConfiguration(spec, opt)
        else:
            cfgs[cid] = est.RandomEffectCoordinateConfiguration(
                RandomEffectDataConfiguration(**spec), opt)
    # The non-finite guard keeps a single-process fit on the unfused
    # loop, which a mesh fit takes too; it changes no finite result.
    return est.GameEstimator(
        TaskType(case["task"]), cfgs, num_iterations=case["iterations"],
        intercept_indices=case["intercepts"], mesh=mesh,
        non_finite_guard=True, **extra)


def fit_case(pkg: str, case: dict, mesh):
    """``(coefficient arrays by coordinate, primary evaluation or None,
    the estimator, its datasets)`` of one fit."""
    data = build_dataset(pkg, case["data"], case["shards"], case["tags"])
    val = (None if case["validation"] is None else build_dataset(
        pkg, case["validation"], case["shards"], case["tags"]))
    est = build_estimator(pkg, case, mesh)
    res = est.fit(data, val)[0]
    arrays = {}
    for cid, m in res.model.items():
        arrays[cid] = np.asarray(
            m.model.coefficients.means if hasattr(m, "model")
            else m.coefficients)
    ev = None if res.evaluation is None else float(
        res.evaluation.primary_evaluation)
    return arrays, ev, est, est.prepare(data, val)[0]


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------


def rank_fit(spec_path: str) -> None:
    """Every case of the spec fitted twice on the mesh, each rank's
    results in ``<out>/<case>.rank<k>.npz``."""
    import torch

    from photon_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    mesh = mesh_mod.init_from_env("cpu")
    try:
        checks = {}
        for setting in spec.get("refused_settings", ()):
            try:
                mesh_mod.resolve_mesh(setting, device="cpu")
                checks[str(setting)] = "no error"
            except ValueError as exc:
                checks[str(setting)] = str(exc)
        for case in spec["cases"]:
            runs = [fit_case("pt", case, "auto") for _ in range(2)]
            (a0, ev0, est, datasets), (a1, ev1, _, _) = runs
            em = est.resolve_mesh()
            fe = next(b for b in datasets.values()
                      if hasattr(b, "logical_rows"))
            re_ds = [d for d in datasets.values()
                     if hasattr(d, "block_codes_np")]
            out = {f"fit0/{k}": v for k, v in a0.items()}
            out.update({f"fit1/{k}": v for k, v in a1.items()})
            out["ev"] = np.asarray(
                [np.nan if ev0 is None else ev0,
                 np.nan if ev1 is None else ev1])
            out["fe_rows"] = np.asarray(
                [fe.num_samples, fe.logical_rows])
            out["re_local"] = np.asarray(
                [b.num_entities for d in re_ds for b in d.blocks])
            out["re_padded"] = np.asarray(
                [len(c) for d in re_ds for c in d.block_codes_np])
            out["mesh"] = np.asarray([em.rank, em.size, em.stats.count])
            out["unfused"] = np.asarray([est._fused_cache is None])
            np.savez(os.path.join(spec["out"],
                                  f"{case['name']}.rank{mesh.rank}.npz"),
                     **out)
        with open(os.path.join(spec["out"], f"checks.rank{mesh.rank}.json"),
                  "w") as f:
            json.dump(checks, f)
    finally:
        mesh_mod.shutdown()


def rank_main(argv) -> int:
    if argv[0] == "fit":
        rank_fit(argv[1])
        return 0
    raise SystemExit(f"unknown rank command {argv[0]!r}")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _run_fits(tmp_path, world, cases, refused=()):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"out": str(tmp_path), "cases": cases,
                                "refused_settings": list(refused)}))
    results = spawn(
        lambda r: [sys.executable, os.path.abspath(__file__), "fit",
                   str(spec)], world, tmp_path)
    _assert_ok(results)
    return {c["name"]: [dict(np.load(tmp_path / f"{c['name']}.rank{r}.npz"))
                        for r in range(world)] for c in cases}


@pytest.fixture(scope="module")
def linear_reference(tmp_path_factory):
    """The linear case and its reference and single-process fits, made
    once for the module's tests."""
    case = linear_case(tmp_path_factory.mktemp("linear"))
    return case, fit_case("jax", case, "auto"), fit_case("pt", case, "off")


def _assert_mesh_fit(case, ranks, world, fits=None):
    """Every rank's fits against the reference's 8-device mesh fit and
    the port's single-process fit (``fits``, else made here), bit for
    bit across fits and ranks, and the shares each rank held."""
    ref, single = fits or (fit_case("jax", case, "auto"),
                           fit_case("pt", case, "off"))
    (ref, ref_ev, _, _), (single, single_ev, _, _) = ref, single
    first = ranks[0]
    for r, got in enumerate(ranks):
        assert list(got["mesh"][:2]) == [r, world]
        assert got["mesh"][2] > 0, "no collective ran"
        assert bool(got["unfused"][0])
        n = int(got["fe_rows"][1])
        assert int(got["fe_rows"][0]) == -(-n // world)
        np.testing.assert_array_equal(
            got["re_local"] * world, got["re_padded"])
        for cid in ref:
            np.testing.assert_array_equal(got[f"fit0/{cid}"],
                                          got[f"fit1/{cid}"], err_msg=cid)
            np.testing.assert_array_equal(got[f"fit0/{cid}"],
                                          first[f"fit0/{cid}"], err_msg=cid)
            np.testing.assert_allclose(got[f"fit0/{cid}"], ref[cid],
                                       rtol=RTOL, atol=ATOL, err_msg=cid)
            np.testing.assert_allclose(got[f"fit0/{cid}"], single[cid],
                                       rtol=RTOL, atol=ATOL, err_msg=cid)
        if ref_ev is not None:
            assert got["ev"][0] == got["ev"][1] == first["ev"][0]
            np.testing.assert_allclose(got["ev"][0], ref_ev, rtol=RTOL)
            np.testing.assert_allclose(got["ev"][0], single_ev, rtol=RTOL)


def test_two_rank_fits_match_reference_mesh_and_single_process(
        tmp_path, linear_reference):
    """2 gloo ranks: the reference's linear case (n = 237, 11 users,
    validation), a logistic and a Poisson GLMix on the lazy layout
    (Newton buckets), and an ELL fixed effect beside a per-movie
    effect, all float64."""
    linear, *fits = linear_reference
    cases = [linear, synth_case(tmp_path, "logistic"),
             synth_case(tmp_path, "poisson"),
             synth_case(tmp_path, "logistic", sparse_fe=True)]
    got = _run_fits(tmp_path, 2, cases)
    _assert_mesh_fit(linear, got["linear"], 2, fits)
    for case in cases[1:]:
        _assert_mesh_fit(case, got[case["name"]], 2)


def test_three_rank_fit_and_refused_mesh_settings(tmp_path,
                                                  linear_reference):
    """3 gloo ranks on the reference's linear case; a sub-mesh (2 of 3
    ranks) and a mesh larger than the group raise, each with its own
    message."""
    case, *fits = linear_reference
    got = _run_fits(tmp_path, 3, [case], refused=(2, "4"))
    _assert_mesh_fit(case, got["linear"], 3, fits)
    for r in range(3):
        checks = json.loads((tmp_path / f"checks.rank{r}.json").read_text())
        assert "a sub-mesh is not supported" in checks["2"]
        assert checks["4"] == ("mesh setting requests 4 devices but only "
                               "3 are visible")


# ---------------------------------------------------------------------------
# the CLIs under a launcher
# ---------------------------------------------------------------------------


def _cli_files(tmp_path):
    """``tests/test_estimator_mesh.py``'s ``TestCLIMesh`` data (n = 203,
    d = 5, 7 users) as TrainingExampleAvro, and its config with ``mesh:
    auto`` for each package's output directory."""
    from photon_tpu_torch.io.avro_data import write_training_examples

    rng = np.random.default_rng(20260729)
    n, d = 203, 5
    x = rng.normal(size=(n, d))
    entities = rng.integers(0, 7, size=n)
    w = rng.normal(size=d)
    w_re = 0.5 * rng.normal(size=(7, d))
    y = x @ w + np.einsum("nd,nd->n", x, w_re[entities])
    y = y + 0.1 * rng.normal(size=n)
    rows = [[(f"f{j}", float(x[i, j])) for j in range(d)] for i in range(n)]
    path = tmp_path / "train.avro"
    write_training_examples(
        str(path), y, rows, metadata=[{"userId": f"u{e}"} for e in entities],
        uids=[str(i) for i in range(n)])
    cfgs = {}
    for side in ("jax", "pt"):
        cfg = {
            "task": "LINEAR_REGRESSION",
            "input": {"format": "avro", "train_path": str(path),
                      "id_tags": ["userId"]},
            "coordinates": {
                "global": {"type": "fixed", "regularization": {
                    "type": "L2", "weights": [0.1]}},
                "per-user": {"type": "random", "random_effect_type":
                             "userId", "regularization": {
                                 "type": "L2", "weights": [1.0]}},
            },
            "num_iterations": 2, "mesh": "auto",
            "output_dir": str(tmp_path / f"out_{side}"),
        }
        cfgs[side] = tmp_path / f"cfg_{side}.json"
        cfgs[side].write_text(json.dumps(cfg))
    return path, cfgs


def _module(name, *args):
    return lambda r: [sys.executable, "-m", name, *args]


def _scores(out_dir):
    from photon_tpu_torch.io import avro

    recs = avro.read_container_dir(str(out_dir / "part-00000.avro"))
    return np.array([r["predictionScore"] for r in recs])


def test_cli_train_and_score_on_two_ranks(tmp_path):
    """``cli.train`` under 2 ranks with ``--distributed``: rank 0 alone
    writes, one model, within the reference's f32 CLI tolerance of its
    ``mesh: auto`` run on 8 devices, and ``cli.fleetview`` merges both
    bundles. ``cli.score --mesh auto`` under 2 ranks with that model:
    one scores file, the single process's scores and evaluation."""
    import contextlib
    import io

    from photon_tpu.cli.train import main as jax_train
    from photon_tpu.io.model_io import load_checkpoint
    from photon_tpu_torch.cli.score import main as pt_score

    data, cfgs = _cli_files(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_train(["--config", str(cfgs["jax"])]) == 0
    fleet = tmp_path / "fleet"
    _assert_ok(spawn(_module(
        "photon_tpu_torch.cli.train", "--config", str(cfgs["pt"]),
        "--device", "cpu", "--verbose", "--distributed", "--fleet-dir",
        str(fleet)), 2, tmp_path))
    logs = [(tmp_path / f"rank{r}.err").read_text() for r in range(2)]
    assert "saved 1 model(s)" in logs[0]
    assert "saved" not in logs[1]
    assert "backend gloo (CPU ranks)" in logs[1]
    models = sorted(p.relative_to(tmp_path / "out_pt").as_posix()
                    for p in (tmp_path / "out_pt").rglob("checkpoint.npz"))
    assert models == ["models/best/checkpoint.npz"]
    got = load_checkpoint(str(tmp_path / "out_pt" / "models" / "best" /
                              "checkpoint.npz"))
    want = load_checkpoint(str(tmp_path / "out_jax" / "models" / "best" /
                               "checkpoint.npz"))
    for cid in ("global", "per-user"):
        a, b = got[cid], want[cid]
        np.testing.assert_allclose(
            np.asarray(a.model.coefficients.means if cid == "global"
                       else a.coefficients),
            np.asarray(b.model.coefficients.means if cid == "global"
                       else b.coefficients),
            rtol=1e-4, atol=2e-5, err_msg=cid)
    view = subprocess.run(
        [sys.executable, "-m", "photon_tpu_torch.cli.fleetview",
         "--run-dir", str(fleet), "--json", str(tmp_path / "fleet.json"),
         "--expect-ranks", "2"], cwd=REPO, capture_output=True, text=True,
        timeout=SPAWN_LIMIT)
    assert view.returncode == 0, view.stderr[-2000:]
    report = json.loads((tmp_path / "fleet.json").read_text())
    assert report["bundles"] == 2 and report["missing_ranks"] == []

    model_dir = tmp_path / "out_pt" / "models" / "best"
    args = ["--model-dir", str(model_dir), "--input", str(data),
            "--evaluators", "RMSE", "--id-tags", "userId", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert pt_score([*args, "--output", str(tmp_path / "single")]) == 0
    _assert_ok(spawn(_module(
        "photon_tpu_torch.cli.score", *args, "--output",
        str(tmp_path / "mesh"), "--mesh", "auto"), 2, tmp_path))
    assert sorted(p.name for p in (tmp_path / "mesh").iterdir()) == [
        "evaluation.json", "part-00000.avro"]
    np.testing.assert_allclose(_scores(tmp_path / "mesh"),
                               _scores(tmp_path / "single"), rtol=0,
                               atol=1e-6)
    ev = {s: json.loads((tmp_path / s / "evaluation.json").read_text())
          for s in ("mesh", "single")}
    assert ev["mesh"]["RMSE"] == pytest.approx(ev["single"]["RMSE"],
                                               rel=1e-6)


def test_failing_rank_ends_every_rank(tmp_path):
    """A rank that raises mid-fit (an injected crash at the end of its
    first CD iteration) tears the group down: the other rank's next
    collective fails, and every process exits non-zero well inside the
    test's limit."""
    _, cfgs = _cli_files(tmp_path)
    plan = json.dumps({"seed": 0, "faults": [
        {"point": "cd.iteration", "error": "crash", "nth": 1}]})
    t0 = time.monotonic()
    results = spawn(_module(
        "photon_tpu_torch.cli.train", "--config", str(cfgs["pt"]),
        "--device", "cpu", "--no-flight"), 2, tmp_path,
        rank_env={1: {"PHOTON_TPU_FAULT_PLAN": plan}})
    assert time.monotonic() - t0 < 60
    assert [rc != 0 for rc, _, _ in results] == [True, True], results
    assert "InjectedCrash" in results[1][2]


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]))
