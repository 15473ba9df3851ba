"""The port's legacy single-GLM driver against the JAX package's, on the
CPU.

``tests/test_glm_cli.py`` case for case: each case writes its files
with numpy from a seed and runs ``photon_tpu.cli.glm.main`` and
``photon_tpu_torch.cli.glm.main --device cpu`` on them, twice each: as
the CLIs read (float32 data, a float32 solve) and with both packages'
readers switched to float64. Then:

- every run selects the same lambda, and reports the same lambdas,
  stages and metric names;
- in float64 the two packages' models agree within 1e-9 (the same
  L-BFGS iterations; the reductions in another order) and their
  metrics within 1e-9 relative;
- in float32 each package's model lies within 5e-4 of its own float64
  model: the fixed-effect bound that ``tests/test_torch_wide.py``'s
  module docstring derives for an f32 solve against float64.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json

import numpy as np
import pytest
import torch

from photon_tpu_torch.cli import glm as pt_glm
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.io.avro_data import (
    read_training_examples,
    write_training_examples,
)
from photon_tpu_torch.io.model_io import load_game_model
from photon_tpu_torch.types import DELIMITER

F32_ATOL = 5e-4
F64_TOL = 1e-9


@pytest.fixture
def binary_avro(tmp_path, rng):
    n, d = 1200, 6
    keys = [f"f{i}{DELIMITER}t" for i in range(d)]
    w = rng.normal(size=d)

    def write(path, n_rows, seed):
        r = np.random.default_rng(seed)
        x = r.normal(size=(n_rows, d))
        z = x @ w
        y = (r.uniform(size=n_rows) < 1 / (1 + np.exp(-z))).astype(float)
        rows = [[(keys[j], float(x[i, j])) for j in range(d)]
                for i in range(n_rows)]
        write_training_examples(str(path), y, rows, uids=np.arange(n_rows))

    train, val = tmp_path / "train.avro", tmp_path / "val.avro"
    write(train, n, 1)
    write(val, 400, 2)
    return train, val


@contextlib.contextmanager
def float64_readers(monkeypatch):
    """Both packages' Avro and libsvm readers make float64 data inside
    the block (their CLIs read float32)."""
    import jax.numpy as jnp

    from photon_tpu.data import libsvm as jax_libsvm
    from photon_tpu.io import avro_data as jax_avro

    from photon_tpu_torch.data import libsvm as pt_libsvm
    from photon_tpu_torch.io import avro_data as pt_avro

    with monkeypatch.context() as m:
        for mod, name, dtype in (
                (jax_avro, "read_training_examples", jnp.float64),
                (jax_libsvm, "read_libsvm", np.float64),
                (pt_avro, "read_training_examples", torch.float64),
                (pt_libsvm, "read_libsvm", torch.float64)):
            m.setattr(mod, name, functools.partial(getattr(mod, name),
                                                   dtype=dtype))
        yield


def run_glm(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def run_four(tmp_path, monkeypatch, argv, maps):
    """Both CLIs in float32 and in float64 (``<side>-<dtype>/out``): the
    summaries and the best models' means as float64 numpy."""
    from photon_tpu.cli.glm import main as jax_main

    out = {}
    for dtype in ("f32", "f64"):
        ctx = (float64_readers(monkeypatch) if dtype == "f64"
               else contextlib.nullcontext())
        with ctx:
            for side, main, extra in (("jax", jax_main, ()),
                                      ("pt", pt_glm.main,
                                       ("--device", "cpu"))):
                d = tmp_path / f"{side}-{dtype}" / "out"
                summary = run_glm(main, [*argv, "--output-dir", str(d),
                                         *extra])
                means = None
                if (d / "best-model").is_dir():
                    model, _ = load_game_model(str(d / "best-model"), maps,
                                               device="cpu",
                                               dtype=torch.float64)
                    means = model["global"].model.coefficients.means.numpy()
                out[side, dtype] = (d, summary, means)
    return out


def assert_runs_agree(runs):
    summaries = {k: v[1] for k, v in runs.items()}
    first = summaries["jax", "f32"]
    for k, s in summaries.items():
        assert s["best_lambda"] == first["best_lambda"], k
        assert s["lambdas"] == first["lambdas"], k
        assert s["stages"] == first["stages"], k
        assert s["metrics"].keys() == first["metrics"].keys(), k
        for lam in first["metrics"]:
            assert s["metrics"][lam].keys() == first["metrics"][lam].keys()
    for lam, jm in summaries["jax", "f64"]["metrics"].items():
        pm = summaries["pt", "f64"]["metrics"][lam]
        for key, v in jm.items():
            assert pm[key] == pytest.approx(v, rel=F64_TOL, abs=F64_TOL), (
                lam, key)
    np.testing.assert_allclose(runs["pt", "f64"][2], runs["jax", "f64"][2],
                               rtol=F64_TOL, atol=F64_TOL)
    for side in ("jax", "pt"):
        np.testing.assert_allclose(runs[side, "f32"][2],
                                   runs[side, "f64"][2], rtol=0,
                                   atol=F32_ATOL, err_msg=side)


def test_logistic_sweep_selects_by_auc(tmp_path, binary_avro, monkeypatch):
    train, val = binary_avro
    _, imap = read_training_examples(str(train), device="cpu")
    runs = run_four(tmp_path, monkeypatch, [
        "--train", str(train), "--validate", str(val),
        "--task", "LOGISTIC_REGRESSION", "--lambdas", "100,1,0.01"],
        {"features": imap})
    assert_runs_agree(runs)
    out, summary, _ = runs["pt", "f32"]
    assert summary["stages"] == ["PREPROCESSED", "TRAINED", "VALIDATED"]
    assert summary["lambdas"] == [100.0, 1.0, 0.01]  # descending sweep
    metrics = summary["metrics"]
    assert set(metrics) == {"100.0", "1.0", "0.01"}
    # Legacy binary metric family present.
    assert {"AUC", "AUPR", "PEAK_F1", "F1=0.5"} <= set(metrics["1.0"])
    # Selection = argmax AUC (ModelSelection.selectBestLinearClassifier).
    best = max(metrics, key=lambda k: metrics[k]["AUC"])
    assert summary["best_lambda"] == float(best)
    # Per-lambda models + the selected one on disk, loadable.
    assert (out / "models" / "lambda=100" / "model-metadata.json").is_file()
    model, _ = load_game_model(str(out / "best-model"), {"features": imap},
                               device="cpu")
    assert "global" in model
    assert set(summary["seconds"]) == {"preprocess", "train lambda sweep",
                                       "validate", "save models"}


def test_linear_sweep_selects_by_rmse_and_warm_start(tmp_path, rng,
                                                     monkeypatch):
    n, d = 800, 5
    keys = [f"f{i}{DELIMITER}t" for i in range(d)]
    w = rng.normal(size=d)
    x = rng.normal(size=(n, d))
    y = x @ w + 0.05 * rng.normal(size=n)
    rows = [[(keys[j], float(x[i, j])) for j in range(d)] for i in range(n)]
    train = tmp_path / "t.avro"
    write_training_examples(str(train), y, rows, uids=np.arange(n))
    _, imap = read_training_examples(str(train), device="cpu")
    runs = run_four(tmp_path, monkeypatch, [
        "--train", str(train), "--validate", str(train),
        "--task", "LINEAR_REGRESSION", "--lambdas", "1000,0.001",
        "--model-output-mode", "BEST"], {"features": imap})
    assert_runs_agree(runs)
    out, summary, _ = runs["pt", "f32"]
    metrics = summary["metrics"]
    best = min(metrics, key=lambda k: metrics[k]["RMSE"])
    assert summary["best_lambda"] == float(best) == 0.001
    assert {"MAE", "MSE", "RMSE"} <= set(metrics["0.001"])
    # BEST mode writes only the selected model.
    assert (out / "best-model" / "model-metadata.json").is_file()
    assert not (out / "models").exists()


def test_libsvm_with_bounds_and_summarization(tmp_path, rng, monkeypatch):
    """libsvm input + coefficient bounds (the legacy constraintMap path,
    solved by the bound-constrained L-BFGS) + summarization stage."""
    n, d = 400, 4
    x = rng.normal(size=(n, d))
    w = np.array([2.0, -2.0, 0.5, 0.1])
    y = x @ w + 0.05 * rng.normal(size=n)
    libsvm = tmp_path / "train.txt"
    with open(libsvm, "w") as f:
        for i in range(n):
            feats = " ".join(f"{j+1}:{x[i, j]:.6f}" for j in range(d))
            f.write(f"{y[i]:.6f} {feats}\n")
    imap = IndexMap.identity(d, add_intercept=True)
    runs = run_four(tmp_path, monkeypatch, [
        "--train", str(libsvm), "--validate", str(libsvm),
        "--format", "libsvm", "--task", "LINEAR_REGRESSION",
        "--lambdas", "0.01", "--coefficient-bounds=-1,1",
        "--summarization-output-dir", str(tmp_path / "stats")],
        {"features": imap})
    assert_runs_agree(runs)
    # Bounds clamp the +-2 generating weights to the box.
    means = runs["pt", "f32"][2]
    assert means.max() <= 1.0 + 1e-6 and means.min() >= -1.0 - 1e-6
    assert np.abs(means).max() > 0.9  # actually pushed to the bound
