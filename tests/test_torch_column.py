"""The column-sharded fixed effect (``parallel/mesh.py``
``FeatureShardedSparse``) on real ranks: spawned gloo processes on the
CPU, held against the JAX package's column route on the conftest's 8
virtual devices.

The ranks run this file as a script (``rank_main``), importing the port
only; each writes its results to an ``.npz`` that the test process
compares with the reference's. Cases are ``tests/test_estimator_mesh.py::
TestColumnFeatureSharding``'s and ``tests/test_sparse_scale.py::
TestFeatureAxisSharding``'s, float64:

- matvec / rmatvec / rmatvec_sq against the plain ELL matrix, rtol 1e-10,
  the padded range receiving nothing;
- column fits (SIMPLE variances, a random effect, warm starts across
  configurations, incremental training, TRON) against the reference's
  column fits: rtol 1e-7 / atol 1e-9, the reference's own tolerance;
- the 1,048,576-feature L-BFGS fit against the replicated fit, rtol
  1e-5 / atol 1e-7 (reference ``test_million_feature_fit_over_mesh``);
- ``cli.train`` with ``feature_sharding: column`` (float32) against the
  reference's run: rtol 1e-4 / atol 2e-5, the reference's f32 CLI
  tolerance;
- two fits, and every rank against rank 0: bit for bit; every rank's
  census of collectives equal to rank 0's, each site declared.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_mesh_ranks import _assert_ok, spawn  # noqa: E402

RTOL, ATOL = 1e-7, 1e-9
N_WIDE, D_WIDE, K_WIDE, E_WIDE = 203, 77, 4, 9
D_MILLION = 1_048_576


# ---------------------------------------------------------------------------
# numpy inputs both packages build from
# ---------------------------------------------------------------------------


def wide_arrays(rng, n=N_WIDE, d=D_WIDE, k=K_WIDE, num_entities=E_WIDE):
    """``TestColumnFeatureSharding._wide_game`` as arrays."""
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float64)
    w = rng.normal(size=d)
    entities = rng.integers(0, num_entities, size=n)
    z = (val * w[idx]).sum(axis=1)
    y = z + 0.1 * rng.normal(size=n)
    return {"idx": idx, "val": val, "y": y,
            "userId": np.asarray([f"u{e}" for e in entities])}


def ell_arrays(rng, n, d, k_max):
    """``test_sparse_scale._random_ell``: distinct ids a row."""
    idx = np.zeros((n, k_max), np.int32)
    val = np.zeros((n, k_max), np.float64)
    for i in range(n):
        k = rng.integers(1, k_max + 1)
        idx[i, :k] = rng.choice(d, size=k, replace=False)
        val[i, :k] = rng.normal(size=k)
    return idx, val


def million_arrays(rng):
    n, d, k = 2048, D_MILLION, 8
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k))
    w_true = np.zeros(d)
    hot = rng.choice(d, size=200, replace=False)
    w_true[hot] = rng.normal(size=200)
    y = (val * w_true[idx]).sum(axis=1) + 0.01 * rng.normal(size=n)
    return {"idx": idx, "val": val, "y": y}


def make_inputs(root):
    rng = np.random.default_rng(20260729)
    np.savez(os.path.join(root, "wide.npz"), **wide_arrays(rng))
    np.savez(os.path.join(root, "wide_val.npz"), **wide_arrays(rng, n=101))
    idx, val = ell_arrays(rng, 64, 97, 6)
    np.savez(os.path.join(root, "ell.npz"), idx=idx, val=val,
             w=rng.normal(size=104), g=rng.normal(size=64))
    np.savez(os.path.join(root, "million.npz"), **million_arrays(rng))


def game(pkg, path, *, dual_cap=None):
    a = np.load(path)
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
    if dual_cap is None:
        feats = ds_mod.SparseFeatures(a["idx"], a["val"], D_WIDE)
    else:
        dkw = {"device": "cpu", "dtype": kw["dtype"]} if pkg == "pt" else {
            "dtype": np.float64}
        feats = ds_mod.ell_to_dual_ell(a["idx"], a["val"], D_WIDE,
                                       width_cap=dual_cap, **dkw)
    return make_game_dataset(a["y"], {"wide": feats},
                             id_tags={"userId": a["userId"]}, **kw)


def estimator(pkg, mesh, sharding, *, with_re=False, variance="NONE",
              optimizer="LBFGS", weight=0.5, reg="L2", **extra):
    """``TestColumnFeatureSharding._estimator`` in either package."""
    if pkg == "pt":
        from photon_tpu_torch import optim
        from photon_tpu_torch.algorithm.problems import (
            GLMOptimizationConfiguration,
            VarianceComputationType,
        )
        from photon_tpu_torch.data.random_effect import (
            RandomEffectDataConfiguration,
        )
        from photon_tpu_torch.estimators import game_estimator as est
        from photon_tpu_torch.types import TaskType

        extra = dict(extra, device="cpu")
    else:
        from photon_tpu import optim
        from photon_tpu.algorithm.problems import (
            GLMOptimizationConfiguration,
            VarianceComputationType,
        )
        from photon_tpu.data.random_effect import (
            RandomEffectDataConfiguration,
        )
        from photon_tpu.estimators import game_estimator as est
        from photon_tpu.types import TaskType
    opt = (optim.OptimizerConfig.tron() if optimizer == "TRON"
           else optim.OptimizerConfig())
    l2 = GLMOptimizationConfiguration(
        optimizer=opt,
        regularization=optim.RegularizationContext(
            optim.RegularizationType(reg)),
        regularization_weight=weight,
        variance_computation=VarianceComputationType(variance))
    coords = {"global": est.FixedEffectCoordinateConfiguration(
        "wide", l2, feature_sharding=sharding)}
    if with_re:
        coords["per-user"] = est.RandomEffectCoordinateConfiguration(
            RandomEffectDataConfiguration("userId", "wide"), l2)
    return est.GameEstimator(TaskType.LINEAR_REGRESSION, coords,
                             num_iterations=2 if with_re else 1, mesh=mesh,
                             **extra)


def fe_arrays(res):
    c = res.model["global"].model.coefficients
    out = {"means": np.asarray(c.means)}
    if c.variances is not None:
        out["variances"] = np.asarray(c.variances)
    if "per-user" in res.model:
        out["per-user"] = np.asarray(res.model["per-user"].coefficients)
    if res.evaluation is not None:
        out["ev"] = np.asarray(float(res.evaluation.primary_evaluation))
    return out


def fit_cases(pkg, root, mesh, sharding):
    """Every estimator case's arrays, keyed ``<case>/<field>``."""
    data = game(pkg, os.path.join(root, "wide.npz"))
    val = game(pkg, os.path.join(root, "wide_val.npz"))
    out = {}

    def put(case, arrays):
        out.update({f"{case}/{k}": v for k, v in arrays.items()})

    put("parity", fe_arrays(estimator(pkg, mesh, sharding,
                                      variance="SIMPLE").fit(data, val)[0]))
    put("with_re", fe_arrays(estimator(pkg, mesh, sharding,
                                       with_re=True).fit(data)[0]))
    est = estimator(pkg, mesh, sharding)
    base = est.coordinate_configs["global"].optimization
    results = est.fit(data, opt_config_sequence=[
        {"global": base.with_regularization_weight(w)} for w in (10.0, 0.5)])
    put("warm0", fe_arrays(results[0]))
    put("warm1", fe_arrays(results[1]))
    prior = estimator(pkg, mesh, sharding, variance="SIMPLE").fit(
        data)[0].model
    inc = estimator(pkg, mesh, sharding, variance="SIMPLE", weight=0.1)
    inc.incremental_training = True
    put("incremental", fe_arrays(inc.fit(data, initial_model=prior)[0]))
    put("tron", fe_arrays(estimator(pkg, mesh, sharding, variance="SIMPLE",
                                    optimizer="TRON").fit(data, val)[0]))
    return out


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------


def rank_features(root, mesh) -> dict:
    """matvec / rmatvec / rmatvec_sq of this rank's column shard of the
    64 x 97 ELL slab, the slices gathered whole."""
    import torch

    from photon_tpu_torch.parallel.mesh import shard_features_by_column

    a = np.load(os.path.join(root, "ell.npz"))
    fs = shard_features_by_column(a["idx"], a["val"], 97, mesh,
                                  dtype=torch.float64, device="cpu")
    w = torch.from_numpy(a["w"][:fs.d].copy())
    w[97:] = 0.0
    g = torch.from_numpy(a["g"])
    mv_whole = fs.matvec(w)
    mv_local = fs.matvec(fs.local_slice(w))
    mv_trim = fs.matvec(w[:97])
    rv, rq = fs.gather(fs.rmatvec(g), fs.rmatvec_sq(g))
    return {"feat/matvec": mv_whole.numpy(),
            "feat/matvec_local": mv_local.numpy(),
            "feat/matvec_trim": mv_trim.numpy(),
            "feat/rmatvec": rv.numpy(), "feat/rmatvec_sq": rq.numpy(),
            "feat/shape": np.asarray([fs.d, fs.logical_d, fs.d_local, fs.lo,
                                      fs.local_indices.shape[1]])}


def rank_million(root, mesh) -> dict:
    """The 1,048,576-feature L-BFGS fit on this rank's column shard and
    replicated (reference ``test_million_feature_fit_over_mesh``)."""
    import torch

    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm.problems import (
        GLMOptimizationConfiguration,
        GLMOptimizationProblem,
    )
    from photon_tpu_torch.data.dataset import GLMBatch, SparseFeatures
    from photon_tpu_torch.parallel.mesh import shard_features_by_column
    from photon_tpu_torch.types import TaskType

    a = np.load(os.path.join(root, "million.npz"))
    n = a["y"].shape[0]
    cfg = GLMOptimizationConfiguration(
        optimizer=optim.OptimizerConfig.lbfgs(max_iterations=30),
        regularization=optim.RegularizationContext(
            optim.RegularizationType.L2),
        regularization_weight=1e-2)
    prob = GLMOptimizationProblem(TaskType.LINEAR_REGRESSION, cfg)
    y = torch.from_numpy(a["y"])

    def fit(feats):
        batch = GLMBatch(feats, y, torch.zeros(n, dtype=torch.float64),
                         torch.ones(n, dtype=torch.float64))
        return prob.run(batch).model.coefficients.means.numpy()

    sharded = shard_features_by_column(a["idx"], a["val"], D_MILLION, mesh,
                                       dtype=torch.float64, device="cpu")
    plain = SparseFeatures(torch.from_numpy(a["idx"]),
                           torch.from_numpy(a["val"]), D_MILLION)
    return {"million/sharded": fit(sharded), "million/plain": fit(plain)}


def rank_blockers(root) -> dict:
    """``auto`` above a lowered threshold goes column, and stays
    replicated (``column`` raises) under normalization or a DualEll
    tail."""
    import torch

    from photon_tpu_torch.estimators import game_estimator as est_mod
    from photon_tpu_torch.ops.normalization import NormalizationContext
    from photon_tpu_torch.parallel.mesh import FeatureShardedSparse

    data = game("pt", os.path.join(root, "wide.npz"))
    dual = game("pt", os.path.join(root, "wide.npz"), dual_cap=2)
    norm = {"wide": NormalizationContext(
        factors=torch.full((D_WIDE,), 2.0, dtype=torch.float64))}
    out = {}

    def kind(est, d):
        feats = est.prepare(d)[0]["global"].features
        return np.asarray(isinstance(feats, FeatureShardedSparse))

    out["auto/below"] = kind(estimator("pt", "auto", "auto"), data)
    saved = est_mod.AUTO_COLUMN_SHARDING_THRESHOLD
    est_mod.AUTO_COLUMN_SHARDING_THRESHOLD = 50
    try:
        out["auto/above"] = kind(estimator("pt", "auto", "auto"), data)
        out["auto/normalized"] = kind(
            estimator("pt", "auto", "auto", normalization=norm), data)
        out["auto/dual"] = kind(estimator("pt", "auto", "auto"), dual)
    finally:
        est_mod.AUTO_COLUMN_SHARDING_THRESHOLD = saved
    msgs = []
    for est, d in ((estimator("pt", "auto", "column", normalization=norm),
                    data), (estimator("pt", "auto", "column"), dual)):
        try:
            est.prepare(d)
            msgs.append("no error")
        except ValueError as exc:
            msgs.append(str(exc))
    try:
        estimator("pt", "auto", "column", reg="L1").fit(data)
        msgs.append("no error")
    except NotImplementedError as exc:
        msgs.append(str(exc))
    out["blocker_messages"] = np.asarray(msgs)
    return out


def rank_cases(spec_path: str) -> None:
    import torch

    from photon_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    root = spec["root"]
    mesh = mesh_mod.init_from_env("cpu")
    try:
        out = {}
        out.update(rank_features(root, mesh))
        first = fit_cases("pt", root, "auto", "column")
        out.update(first)
        if spec.get("full"):
            again = fit_cases("pt", root, "auto", "column")
            out["repeat_equal"] = np.asarray(all(
                np.array_equal(first[k], again[k]) for k in first))
            out.update(rank_million(root, mesh))
            out.update(rank_blockers(root))
            single = fit_cases("pt", root, "off", "replicated")
            out.update({f"single/{k}": v for k, v in single.items()})
        census = [[c["op"], c["site"], c["dtype"], c["shape"]]
                  for c in mesh.stats.census]
        out["census"] = np.asarray(json.dumps(census))
        np.savez(os.path.join(root, f"rank{mesh.rank}.npz"), **out)
    finally:
        mesh_mod.shutdown()


def rank_main(argv) -> int:
    if argv[0] == "cases":
        rank_cases(argv[1])
        return 0
    raise SystemExit(f"unknown rank command {argv[0]!r}")


# ---------------------------------------------------------------------------
# the test process's side
# ---------------------------------------------------------------------------


def _run(root, world, full):
    spec = os.path.join(root, "spec.json")
    with open(spec, "w") as f:
        json.dump({"root": str(root), "full": full}, f)
    _assert_ok(spawn(lambda r: [sys.executable, os.path.abspath(__file__),
                                "cases", spec], world, root))
    return [dict(np.load(os.path.join(root, f"rank{r}.npz")))
            for r in range(world)]


@pytest.fixture(scope="module")
def column_runs(tmp_path_factory):
    """The inputs, the reference's column fits on 8 devices, and the
    ranks' results: 2 ranks with every case, 3 ranks (77 features do
    not divide) with the fits."""
    root = tmp_path_factory.mktemp("column")
    make_inputs(str(root))
    ref = fit_cases("jax", str(root), "auto", "column")
    two = _run(root / "", 2, True)
    three_root = root / "three"
    three_root.mkdir()
    for name in ("wide.npz", "wide_val.npz", "ell.npz", "million.npz"):
        os.link(root / name, three_root / name)
    three = _run(three_root, 3, False)
    return {"root": root, "ref": ref, 2: two, 3: three}


FIT_CASES = ("parity", "with_re", "warm0", "warm1", "incremental", "tron")


@pytest.mark.parametrize("world", [2, 3])
def test_column_shard_matvecs_match_plain_ell(column_runs, world):
    import torch

    from photon_tpu_torch.data.dataset import SparseFeatures

    a = np.load(column_runs["root"] / "ell.npz")
    plain = SparseFeatures(torch.from_numpy(a["idx"]),
                           torch.from_numpy(a["val"]), 97)
    w = torch.from_numpy(a["w"][:97].copy())
    g = torch.from_numpy(a["g"])
    for r, got in enumerate(column_runs[world]):
        d, logical, d_local, lo, k_loc = got["feat/shape"]
        assert d % world == 0 and d >= 97 and logical == 97
        assert d_local == d // world and lo == r * d_local
        assert 1 <= k_loc <= 6
        for key in ("feat/matvec", "feat/matvec_local", "feat/matvec_trim"):
            np.testing.assert_allclose(got[key], plain.matvec(w).numpy(),
                                       rtol=1e-10, err_msg=key)
        np.testing.assert_allclose(got["feat/rmatvec"][:97],
                                   plain.rmatvec(g).numpy(), rtol=1e-10)
        np.testing.assert_allclose(got["feat/rmatvec_sq"][:97],
                                   plain.rmatvec_sq(g).numpy(), rtol=1e-10)
        # The padded feature range receives nothing.
        assert np.all(got["feat/rmatvec"][97:] == 0.0)
        assert np.all(got["feat/rmatvec_sq"][97:] == 0.0)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", FIT_CASES)
def test_column_fit_matches_reference_column_fit(column_runs, world, case):
    """Means, SIMPLE variances, the random effect and the evaluation of
    each column fit against the reference's column fit on 8 devices;
    every rank's model equal to rank 0's bit for bit."""
    ref = {k.split("/", 1)[1]: v for k, v in column_runs["ref"].items()
           if k.startswith(case + "/")}
    ranks = column_runs[world]
    for r, got in enumerate(ranks):
        for field, want in ref.items():
            key = f"{case}/{field}"
            assert got[key].shape == want.shape, key
            np.testing.assert_allclose(got[key], want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {key}")
            np.testing.assert_array_equal(got[key], ranks[0][key])


@pytest.mark.parametrize("case", ["parity", "with_re", "incremental"])
def test_column_fit_matches_single_process(column_runs, case):
    ranks = column_runs[2]
    for key in ranks[0]:
        if key.startswith(case + "/"):
            np.testing.assert_allclose(ranks[0][key],
                                       ranks[0][f"single/{key}"],
                                       rtol=RTOL, atol=ATOL, err_msg=key)


def test_two_column_fits_are_bit_identical(column_runs):
    for got in column_runs[2]:
        assert bool(got["repeat_equal"])


def test_million_feature_fit_matches_replicated(column_runs):
    for got in column_runs[2]:
        w = got["million/sharded"]
        assert w.shape == (D_MILLION,)
        np.testing.assert_allclose(w, got["million/plain"], rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_array_equal(column_runs[2][0]["million/sharded"],
                                  column_runs[2][1]["million/sharded"])


def test_auto_threshold_and_blockers(column_runs):
    for got in column_runs[2]:
        assert not bool(got["auto/below"])
        assert bool(got["auto/above"])
        assert not bool(got["auto/normalized"])
        assert not bool(got["auto/dual"])
        norm, dual, l1 = got["blocker_messages"]
        assert "feature normalization is active" in norm
        assert "DualEll overflow tail present" in dual
        assert "OWL-QN" in l1 and "item 14" in l1


@pytest.mark.parametrize("world", [2, 3])
def test_every_rank_issues_rank0s_census(column_runs, world):
    from photon_tpu_torch.parallel.mesh import SPMD_AUDIT

    censuses = [json.loads(str(got["census"])) for got in column_runs[world]]
    assert censuses[0], "no collective ran"
    for c in censuses[1:]:
        assert c == censuses[0]
    sites = {c[1] for c in censuses[0]}
    assert sites <= set(SPMD_AUDIT["ordered_collectives"])
    assert {"column.margins", "column.inner_products",
            "column.coefficient_gather"} <= sites


def test_cli_config_key():
    from photon_tpu_torch.cli.config import parse_coordinate

    spec = parse_coordinate("global", {"type": "fixed", "feature_shard":
                                       "wide", "feature_sharding": "column"})
    assert spec.config.feature_sharding == "column"
    with pytest.raises(ValueError, match="feature_sharding"):
        parse_coordinate("global", {"type": "fixed",
                                    "feature_sharding": "rows"})


def test_cli_train_column_on_two_ranks(tmp_path):
    """``cli.train`` with ``feature_sharding: column`` in 2 ranks
    against the reference's ``mesh: auto`` column run on 8 devices."""
    import contextlib
    import io

    from photon_tpu.cli.train import main as jax_train
    from photon_tpu.io.model_io import load_checkpoint
    from test_torch_mesh_ranks import _cli_files, _module

    _, cfgs = _cli_files(tmp_path)
    for side, path in cfgs.items():
        cfg = json.loads(path.read_text())
        cfg["coordinates"]["global"]["feature_sharding"] = "column"
        path.write_text(json.dumps(cfg))
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_train(["--config", str(cfgs["jax"])]) == 0
    _assert_ok(spawn(_module(
        "photon_tpu_torch.cli.train", "--config", str(cfgs["pt"]),
        "--device", "cpu", "--no-flight"), 2, tmp_path))
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


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]))
