"""The port's fused whole fit against the JAX package's.

The same numpy data, made from a seed, goes through both packages'
``make_game_dataset`` in float64; the JAX side runs its fused fit (one XLA
program a fit) on the CPU, the port runs ``FusedFit`` eagerly on the
CPU (on the card the same function is one CUDA-graph replay; the
``cuda`` cases at the end need the card).

Held, for each of the reference's ``tests/test_fused_fit.py`` cases:

- coefficients within rtol 1e-8 / atol 1e-10 of the reference's fused
  fit (the reference's own fused/unfused bound);
- per-entity iterations and reasons, and the fixed effect's iterations
  and reason, equal exactly;
- the [T, C, 5] convergence block within rtol 1e-8 / atol 1e-12;
- the port's fused fit against its own unfused loop within the same
  bound as the reference holds its two;
- ``fuse_ineligibility_reasons`` equal string for string.

With two random-effect coordinates the reference's fused fit departs
from its own unfused loop on the second one (ROADMAP Queue C), so the
two-coordinate case holds the port's fused fit against the reference's
unfused loop instead.

Then the telemetry, health and fault cases of the reference's
``tests/test_obs.py`` (:295-412) and ``tests/test_health.py`` (:437), the
``fit.dispatch`` fault point, and ``utils.device_loop`` eagerly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu import obs as jax_obs
from photon_tpu import optim as jax_optim
from photon_tpu.algorithm import fused_fit as jax_ff
from photon_tpu.algorithm import random_effect as jax_re_alg
from photon_tpu.algorithm.problems import (
    GLMOptimizationConfiguration as JaxGLMConfig,
)
from photon_tpu.data import dataset as jax_dataset
from photon_tpu.data import game_data as jax_game_data
from photon_tpu.data import random_effect as jax_re
from photon_tpu.estimators import game_estimator as jax_est
from photon_tpu.events import EventEmitter as JaxEmitter
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch import obs
from photon_tpu_torch import optim
from photon_tpu_torch.algorithm import fused_fit as pt_ff
from photon_tpu_torch.algorithm import random_effect as pt_re_alg
from photon_tpu_torch.algorithm.problems import GLMOptimizationConfiguration
from photon_tpu_torch.data import dataset as pt_dataset
from photon_tpu_torch.data import game_data as pt_game_data
from photon_tpu_torch.data import random_effect as pt_re
from photon_tpu_torch.estimators import game_estimator as pt_est
from photon_tpu_torch.obs import health
from photon_tpu_torch.optim import batched
from photon_tpu_torch.resilience import faults, retry
from photon_tpu_torch.resilience.errors import PoisonError
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import device_loop
from test_torch_fused_fit_cuda import reg_pt, tiny_glmix

RTOL, ATOL = 1e-8, 1e-10
CONV_RTOL, CONV_ATOL = 1e-8, 1e-12
TASKS = {"linear": (TaskType.LINEAR_REGRESSION, JaxTask.LINEAR_REGRESSION),
         "logistic": (TaskType.LOGISTIC_REGRESSION,
                      JaxTask.LOGISTIC_REGRESSION),
         "poisson": (TaskType.POISSON_REGRESSION,
                     JaxTask.POISSON_REGRESSION)}


def game_arrays(seed, task="linear", n=600, d=6, du=4, e=15, dm=0, m=0):
    """The reference's ``_game`` data as numpy (plus a movie shard when
    ``m`` is set)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[:, -1] = 1.0
    xu = rng.normal(size=(n, du))
    xu[:, -1] = 1.0
    users = rng.integers(0, e, size=n)
    w = rng.normal(size=d) * 0.5
    wu = rng.normal(size=(e, du)) * 0.4
    z = x @ w + np.einsum("nd,nd->n", xu, wu[users])
    out = dict(x=x, xu=xu, users=users)
    if m:
        xm = rng.normal(size=(n, dm))
        xm[:, -1] = 1.0
        movies = rng.integers(0, m, size=n)
        z = z + np.einsum("nd,nd->n", xm, rng.normal(size=(m, dm))[movies]
                          * 0.3)
        out.update(xm=xm, movies=movies)
    if task == "logistic":
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    elif task == "poisson":
        y = rng.poisson(np.exp(np.clip(0.3 * z, None, 3.0))).astype(
            np.float64)
    else:
        y = z + 0.1 * rng.normal(size=n)
    out["y"] = y
    return out


def both_datasets(a):
    def shards(mod):
        out = {"global": mod.DenseFeatures(a["x"]),
               "userShard": mod.DenseFeatures(a["xu"])}
        if "xm" in a:
            out["movieShard"] = mod.DenseFeatures(a["xm"])
        return out

    tags = {"userId": a["users"]}
    if "movies" in a:
        tags["movieId"] = a["movies"]
    jdata = jax_game_data.make_game_dataset(
        a["y"], shards(jax_dataset), id_tags=tags, dtype=jnp.float64)
    pdata = pt_game_data.make_game_dataset(
        a["y"], shards(pt_dataset), id_tags=tags, dtype=torch.float64,
        device="cpu")
    return jdata, pdata


def reg(weight, kind="L2"):
    return dict(
        jax=JaxGLMConfig(
            regularization=jax_optim.RegularizationContext(
                getattr(jax_optim.RegularizationType, kind)),
            regularization_weight=weight),
        pt=GLMOptimizationConfiguration(
            regularization=optim.RegularizationContext(
                getattr(optim.RegularizationType, kind)),
            regularization_weight=weight))


def user_cfg(side, **kw):
    mod = jax_re if side == "jax" else pt_re
    return mod.RandomEffectDataConfiguration("userId", "userShard", **kw)


def both_estimators(task="linear", *, num_iterations=3, fe=0.01, re=0.5,
                    user_kw=None, movie=False, fe_cfg=None, locked=None,
                    unfused=False):
    """A JAX and a port GameEstimator of the reference's ``_estimator``
    (mesh off on the JAX side); ``unfused`` attaches a no-op listener to
    each, which keeps both on their unfused loops."""
    pt_task, jax_task = TASKS[task]
    out = {}
    for side, mod, t in (("jax", jax_est, jax_task), ("pt", pt_est, pt_task)):
        fcfg = fe_cfg[side] if fe_cfg else reg(fe)[side]
        cfgs = {
            "global": mod.FixedEffectCoordinateConfiguration("global", fcfg),
            "per-user": mod.RandomEffectCoordinateConfiguration(
                user_cfg(side, **(user_kw or {})), reg(re)[side]),
        }
        icpt = {"global": 5, "userShard": 3}
        if movie:
            rmod = jax_re if side == "jax" else pt_re
            cfgs["per-movie"] = mod.RandomEffectCoordinateConfiguration(
                rmod.RandomEffectDataConfiguration("movieId", "movieShard"),
                reg(0.3)[side])
            icpt["movieShard"] = 2
        kw = dict(intercept_indices=icpt, num_iterations=num_iterations,
                  locked_coordinates=locked)
        if side == "jax":
            est = mod.GameEstimator(t, cfgs, mesh=None, **kw)
            if unfused:
                est.emitter = JaxEmitter([lambda e: None])
        else:
            est = mod.GameEstimator(
                t, cfgs, device="cpu",
                listeners=[lambda e: None] if unfused else None, **kw)
        out[side] = est
    return out["jax"], out["pt"]


def coef_maps(model):
    out = {}
    for cid, m in model.items():
        c = (m.coefficients if hasattr(m, "coefficients")
             else m.model.coefficients.means)
        out[cid] = np.asarray(c)
    return out


def assert_close(pmodel, jmodel, rtol=RTOL, atol=ATOL):
    p, j = coef_maps(pmodel), coef_maps(jmodel)
    assert p.keys() == j.keys()
    for cid in p:
        np.testing.assert_allclose(p[cid], j[cid], rtol=rtol, atol=atol,
                                   err_msg=cid)


def re_stats(diag):
    """(reasons, iterations) of either package's random-effect stats."""
    return diag._materialize()


def assert_diagnostics_equal(pres, jres):
    for ph, jh in zip(pres.descent.history, jres.descent.history,
                      strict=True):
        assert (ph.iteration, ph.coordinate_id) == (jh.iteration,
                                                    jh.coordinate_id)
        if isinstance(jh.diagnostics, jax_re_alg.RandomEffectTrainingStats):
            pr, pi = re_stats(ph.diagnostics)
            jr, ji = re_stats(jh.diagnostics)
            np.testing.assert_array_equal(pr, np.asarray(jr))
            np.testing.assert_array_equal(pi, np.asarray(ji))
        else:
            assert int(ph.diagnostics.iterations) == int(
                jh.diagnostics.iterations)
            assert int(ph.diagnostics.convergence_reason) == int(
                jh.diagnostics.convergence_reason)


@pytest.fixture
def traced():
    """Telemetry on in both packages, so each fused fit parks its
    convergence block."""
    jax_obs.reset()
    obs.reset()
    jax_obs.enable()
    obs.enable()
    yield
    jax_obs.disable()
    obs.disable()
    jax_obs.reset()
    obs.reset()


def last_conv(mod):
    t = mod.convergence._traces[-1]
    arr = t["np"] if t.get("np") is not None else t["array"]
    if hasattr(arr, "detach"):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def fit_both(jest, pest, jdata, pdata, **kw):
    jkw = {k: v["jax"] if isinstance(v, dict) and "jax" in v else v
           for k, v in kw.items()}
    pkw = {k: v["pt"] if isinstance(v, dict) and "pt" in v else v
           for k, v in kw.items()}
    return jest.fit(jdata, **jkw), pest.fit(pdata, **pkw)


@pytest.mark.parametrize("task", ["linear", "logistic", "poisson"])
class TestFusedUnfusedParity:
    def test_models_match(self, task, traced):
        jdata, pdata = both_datasets(game_arrays(1, task))
        jest, pest = both_estimators(task)
        jres, pres = fit_both(jest, pest, jdata, pdata)
        assert pest._fused_cache is not None, "fused path did not run"
        assert jest._fused_cache is not None
        assert_close(pres[0].model, jres[0].model)
        assert_diagnostics_equal(pres[0], jres[0])
        np.testing.assert_allclose(last_conv(obs), last_conv(jax_obs),
                                   rtol=CONV_RTOL, atol=CONV_ATOL)
        _, unf = both_estimators(task, unfused=True)
        ures = unf.fit(pdata)
        assert unf._fused_cache is None
        assert_close(pres[0].model, ures[0].model)

    def test_history_diagnostics_match_shape(self, task):
        jdata, pdata = both_datasets(game_arrays(2, task))
        jest, pest = both_estimators(task)
        jres, pres = fit_both(jest, pest, jdata, pdata)
        hist = pres[0].descent.history
        assert len(hist) == 6
        for rec in hist:
            if rec.coordinate_id == "per-user":
                assert isinstance(rec.diagnostics,
                                  pt_re_alg.RandomEffectTrainingStats)
                assert rec.diagnostics.num_entities > 0
            else:
                assert rec.diagnostics.iterations >= 1
        assert_diagnostics_equal(pres[0], jres[0])


class TestFusedWarmStartAndGrid:
    def test_config_sequence_reuses_program_and_matches_unfused(self,
                                                                traced):
        jdata, pdata = both_datasets(game_arrays(3))
        seq = [{"global": reg(0.1), "per-user": reg(1.0)},
               {"global": reg(0.01), "per-user": reg(0.2)}]
        jseq = [{k: v["jax"] for k, v in c.items()} for c in seq]
        pseq = [{k: v["pt"] for k, v in c.items()} for c in seq]
        jest, pest = both_estimators()
        jres = jest.fit(jdata, opt_config_sequence=jseq)
        pres = pest.fit(pdata, opt_config_sequence=pseq)
        assert len(pest._fused_cache) == 1
        for p, j in zip(pres, jres, strict=True):
            assert_close(p.model, j.model)
            assert_diagnostics_equal(p, j)
        _, unf = both_estimators(unfused=True)
        for p, u in zip(pres, unf.fit(pdata, opt_config_sequence=pseq)):
            assert_close(p.model, u.model)

    def test_warm_start_initial_model(self):
        jdata, pdata = both_datasets(game_arrays(4))
        jest, pest = both_estimators()
        jfirst, pfirst = fit_both(jest, pest, jdata, pdata)
        jwarm = jest.fit(jdata, initial_model=jfirst[0].model)
        pwarm = pest.fit(pdata, initial_model=pfirst[0].model)
        assert_close(pwarm[0].model, jwarm[0].model)
        assert_diagnostics_equal(pwarm[0], jwarm[0])
        f, w = coef_maps(pfirst[0].model), coef_maps(pwarm[0].model)
        for cid in f:
            np.testing.assert_allclose(f[cid], w[cid], rtol=5e-2,
                                       atol=1e-3, err_msg=cid)


class TestFusedPassiveRows:
    def test_capped_reservoir_matches_unfused(self):
        jdata, pdata = both_datasets(game_arrays(5, n=900, e=12))
        kw = dict(num_iterations=2, user_kw={"active_data_upper_bound": 20})
        jest, pest = both_estimators(**kw)
        jres, pres = fit_both(jest, pest, jdata, pdata)
        assert pest._fused_cache is not None
        ds = pest._fit_cache[1][0]["per-user"]
        _, passive = ds.covered_row_partition()
        assert passive.size > 0, "cap must create passive rows"
        assert_close(pres[0].model, jres[0].model)
        assert_diagnostics_equal(pres[0], jres[0])
        _, unf = both_estimators(unfused=True, **kw)
        assert_close(pres[0].model, unf.fit(pdata)[0].model)


class TestFusedLockedCoordinates:
    def test_partial_retrain_matches_unfused(self):
        jdata, pdata = both_datasets(game_arrays(6))
        jbase_est, pbase_est = both_estimators()
        jbase, pbase = fit_both(jbase_est, pbase_est, jdata, pdata)
        jest, pest = both_estimators(locked={"global"})
        jres = jest.fit(jdata, initial_model=jbase[0].model)
        pres = pest.fit(pdata, initial_model=pbase[0].model)
        assert pest._fused_cache is not None
        assert_close(pres[0].model, jres[0].model)
        assert_diagnostics_equal(pres[0], jres[0])
        _, unf = both_estimators(locked={"global"}, unfused=True)
        ures = unf.fit(pdata, initial_model=pbase[0].model)
        assert_close(pres[0].model, ures[0].model)
        np.testing.assert_array_equal(
            coef_maps(pres[0].model)["global"],
            np.asarray(pbase[0].model["global"].model.coefficients.means))


class TestFusedFallbacks:
    def test_mesh_estimator_stays_unfused(self):
        """The mesh reason is the reference's word for word, and a mesh
        keeps a fit unfused (a real one in tests/test_torch_mesh.py)."""
        jdata, pdata = both_datasets(game_arrays(7))
        jest, pest = both_estimators()
        jdatasets, _ = jest.prepare(jdata)
        pdatasets, _ = pest.prepare(pdata)
        jc = jest._build_coordinates(jdatasets, {}, {})
        pc = pest._build_coordinates(pdatasets, {}, {})
        marker = object()
        assert (pt_ff.fuse_ineligibility_reasons(pc, mesh=marker)
                == jax_ff.fuse_ineligibility_reasons(jc, mesh=marker))
        assert pt_ff.fuse_ineligibility_reasons(pc, mesh=marker)

    def test_downsampling_stays_unfused(self):
        jdata, pdata = both_datasets(game_arrays(8, "logistic"))
        cfg = {k: dataclasses.replace(v, down_sampling_rate=0.5)
               for k, v in reg(0.01).items()}
        jest, pest = both_estimators("logistic", num_iterations=2,
                                     fe_cfg=cfg)
        r = pest.fit(pdata)[0]
        assert pest._fused_cache is None
        assert r.model is not None
        jdatasets, _ = jest.prepare(jdata)
        pdatasets, _ = pest.prepare(pdata)
        jr = jax_ff.fuse_ineligibility_reasons(
            jest._build_coordinates(jdatasets, {}, {}))
        pr = pt_ff.fuse_ineligibility_reasons(
            pest._build_coordinates(pdatasets, {}, {}))
        assert pr == jr and len(pr) == 1

    def test_validation_stays_unfused(self):
        _, pdata = both_datasets(game_arrays(9))
        _, pest = both_estimators()
        pest.evaluators = ["RMSE"]
        r = pest.fit(pdata, validation=pdata)[0]
        assert pest._fused_cache is None
        assert r.evaluation is not None

    def test_fuse_eligible_rejects_materialized_dataset(self):
        jdata, pdata = both_datasets(game_arrays(10))
        jds = jax_re.build_random_effect_dataset(
            jdata, user_cfg("jax"), intercept_index=3, lazy=False)
        pds = pt_re.build_random_effect_dataset(
            pdata, user_cfg("pt"), intercept_index=3, lazy=False)
        jc = {"per-user": jax_re_alg.RandomEffectCoordinate(
            jds, JaxTask.LINEAR_REGRESSION, reg(0.5)["jax"])}
        pc = {"per-user": pt_re_alg.RandomEffectCoordinate(
            pds, TaskType.LINEAR_REGRESSION, reg(0.5)["pt"])}
        assert not pt_ff.fuse_eligible(pc)
        assert (pt_ff.fuse_ineligibility_reasons(pc)
                == jax_ff.fuse_ineligibility_reasons(jc))
        assert (pt_ff.fuse_ineligibility_reasons(pc, emitter=object())
                == jax_ff.fuse_ineligibility_reasons(jc, emitter=object()))


class TestFusedHistoryAndCache:
    def test_fused_history_seconds_is_none(self):
        _, pdata = both_datasets(game_arrays(11))
        _, pest = both_estimators()
        r = pest.fit(pdata)[0]
        assert pest._fused_cache
        assert len(r.descent.history) > 0
        assert all(rec.seconds is None for rec in r.descent.history)

    def test_alternating_static_keys_reuse_cached_programs(self,
                                                           monkeypatch):
        # Serial ingest keeps the count pure, as the reference's test
        # does: the pipelined prepare's warm stage builds one more
        # (skeleton) FusedFit by design, which is not a cache rebuild.
        monkeypatch.setenv("PHOTON_TPU_SERIAL_INGEST", "1")
        builds = []
        real = pt_ff.FusedFit

        class CountingFusedFit(real):
            def __init__(self, *args, **kwargs):
                builds.append(1)
                super().__init__(*args, **kwargs)

        monkeypatch.setattr(pt_ff, "FusedFit", CountingFusedFit)
        jdata, pdata = both_datasets(game_arrays(12))
        jest, pest = both_estimators()
        seq = [{"global": reg(0.01)}, {"global": reg(0.01, "L1")}] * 2
        jres = jest.fit(jdata, opt_config_sequence=[
            {k: v["jax"] for k, v in c.items()} for c in seq])
        pres = pest.fit(pdata, opt_config_sequence=[
            {k: v["pt"] for k, v in c.items()} for c in seq])
        assert len(pres) == 4
        assert len(builds) == 2, "each static key must build exactly once"
        assert len(pest._fused_cache) == 2
        entries = list(pest._fused_cache.values())
        assert all(f._mat_shared is pest._fused_mat_share for f in entries)
        assert "ebs" in pest._fused_mat_share
        assert all(f._mat_cache is None for f in entries)
        for p, j in zip(pres, jres, strict=True):
            assert_close(p.model, j.model)
            assert_diagnostics_equal(p, j)


def test_two_random_effects_match_the_unfused_reference():
    """Two random-effect coordinates: the port's fused fit against the
    reference's unfused loop (its fused fit departs from it on the
    second coordinate) and against its own unfused loop."""
    a = game_arrays(13, "logistic", n=900, dm=3, m=10)
    jdata, pdata = both_datasets(a)
    jest, pest = both_estimators("logistic", movie=True, unfused=True)
    _, fused = both_estimators("logistic", movie=True)
    jres = jest.fit(jdata)
    pres = fused.fit(pdata)
    assert fused._fused_cache is not None
    assert_close(pres[0].model, jres[0].model)
    assert_close(pres[0].model, pest.fit(pdata)[0].model)


# ---------------------------------------------------------------------------
# telemetry (the reference's tests/test_obs.py:295-412)
# ---------------------------------------------------------------------------


@pytest.fixture
def telemetry():
    obs.reset()
    obs.enable()
    yield
    obs.disable()
    obs.reset()


@pytest.fixture
def tiny_fit(telemetry):
    est, data = tiny_glmix()
    est.prepare(data)
    result = est.fit(data)[0]
    warm = est.fit(data)[0]
    return est, result, warm, obs.snapshot(), obs.TRACER.completed()


def test_fused_fit_records_convergence_series(tiny_fit):
    est, _, _, snap, _ = tiny_fit
    conv = snap["convergence"]
    assert conv["fits_recorded"] == 2
    last = conv["last"]
    assert set(last) == {"global", "per-user"}
    for series in last.values():
        assert set(series) == set(obs.convergence.METRICS)
        for values in series.values():
            assert len(values) == est.num_iterations
            assert all(np.isfinite(v) for v in values)
    assert all(v > 0 for v in last["global"]["loss"])
    assert last["per-user"]["loss"] == [0.0] * est.num_iterations


def test_fused_seconds_attributed_from_measured_wall(tiny_fit):
    est, _, warm, _, spans = tiny_fit
    secs = [rec.seconds for rec in warm.descent.history]
    assert len(secs) == est.num_iterations * 2
    assert all(isinstance(s, float) and s >= 0.0 for s in secs)
    fused = [s for s in spans if s.name == "fused_fit"][-1]
    fit_seconds = fused.attrs["fit_seconds"]
    assert 0.0 < fit_seconds <= fused.seconds
    assert sum(secs) == pytest.approx(fit_seconds, rel=1e-4, abs=5.1e-7)
    assert fused.device_wait_seconds is not None


def test_fused_cold_window_is_not_attributed(tiny_fit):
    """The first fit of a static structure builds its program (a capture
    on the card) inside the window: its records keep seconds None; the
    warm fit's window is pure."""
    _, cold, warm, _, spans = tiny_fit
    assert all(rec.seconds is None for rec in cold.descent.history)
    assert all(isinstance(rec.seconds, float)
               for rec in warm.descent.history)
    fused = [s for s in spans if s.name == "fused_fit"]
    assert [s.attrs["fit_window_pure"] for s in fused] == [False, True]


def test_fused_retried_dispatch_window_is_not_attributed(telemetry):
    est, data = tiny_glmix()
    est.fit(data)
    plan = faults.FaultPlan([dict(point="fit.dispatch", nth=1)])
    try:
        with faults.injected(plan):
            retried = est.fit(data)[0]
    finally:
        retry.reset_retry_stats()
    assert all(rec.seconds is None for rec in retried.descent.history)
    fused = [s for s in obs.TRACER.completed() if s.name == "fused_fit"]
    assert fused[-1].attrs["fit_window_pure"] is False


def test_fused_fit_telemetry_off_keeps_seconds_none():
    obs.reset()
    est, data = tiny_glmix()
    result = est.fit(data)[0]
    assert all(rec.seconds is None for rec in result.descent.history)
    assert obs.convergence.snapshot()["fits_recorded"] == 0
    assert obs.TRACER.completed() == []


def test_fused_fit_books_ledger_rows(telemetry):
    from photon_tpu_torch.obs import ledger

    ledger.reset()
    ledger.enable()
    try:
        est, data = tiny_glmix()
        est.fit(data)
        est.fit(data)
        snap = ledger.snapshot()
    finally:
        ledger.disable()
        ledger.reset()
    programs = {r["program"] for r in snap["rows"]}
    assert {"fused_fit", "materialize", "unattributed"} <= programs
    assert "coordinate_descent" not in programs
    parts = [r for r in snap["rows"] if r["program"] == "fused_fit"]
    assert {r["coordinate"] for r in parts} >= {"global", "per-user"}
    assert snap["resident_bytes"].get("fused_fit/slabs", 0) > 0
    assert obs.REGISTRY.snapshot()["counters"]["fused_fits_total"] == 2


# ---------------------------------------------------------------------------
# health (the reference's tests/test_health.py:437) and faults
# ---------------------------------------------------------------------------


@pytest.fixture
def health_armed():
    health.reset()
    yield
    health.disable()
    health.reset()


def test_fused_fit_parks_sentinel_when_armed(health_armed):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = (x @ np.asarray([1.0, -1.0, 0.5, 0.0]) > 0).astype(np.float32)
    data = pt_game_data.make_game_dataset(
        y, {"features": pt_dataset.DenseFeatures(x)}, device="cpu")
    est = pt_est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"global": pt_est.FixedEffectCoordinateConfiguration(
            "features", reg_pt(1e-2))},
        num_iterations=1, device="cpu")
    health.enable()
    before = health.sentinel_seq()
    est.fit(data)
    assert health.sentinel_seq() == before + 1
    rep = health.numerics_report(since_seq=before)
    assert rep["fits_scanned"] == 1
    assert rep["nonfinite_total"] == 0


def test_fit_dispatch_transient_fault_is_retried():
    est, data = tiny_glmix()
    want = coef_maps(est.fit(data)[0].model)
    plan = faults.FaultPlan([dict(point="fit.dispatch", nth=1)])
    try:
        with faults.injected(plan):
            got = coef_maps(est.fit(data)[0].model)
        stats = retry.retry_stats()
    finally:
        retry.reset_retry_stats()
    assert stats["retries"] == 1
    for cid in want:
        np.testing.assert_array_equal(got[cid], want[cid])


def test_fit_dispatch_poison_fault_raises():
    est, data = tiny_glmix()
    plan = faults.FaultPlan([dict(point="fit.dispatch", nth=1,
                                  error="poison")])
    with faults.injected(plan):
        with pytest.raises(PoisonError):
            est.fit(data)


# ---------------------------------------------------------------------------
# utils.device_loop, eagerly
# ---------------------------------------------------------------------------


def test_device_loop_eagerly_is_the_python_loop_and_counts_syncs():
    calls = []

    def any_running(mask):
        calls.append(1)
        return bool(mask.any())

    state = type("S", (), {})()
    state.x = torch.arange(5)
    state.n = torch.zeros(5, dtype=torch.int64)

    def body(active):
        state.x = torch.where(active, state.x + 3, state.x)
        state.n = state.n + active.long()

    device_loop.while_loop(lambda: state.x < 10, body, (state,),
                           any_running=any_running)
    x, n = torch.arange(5), torch.zeros(5, dtype=torch.int64)
    steps = 0
    while True:
        steps += 1
        active = x < 10
        if not bool(active.any()):
            break
        x = torch.where(active, x + 3, x)
        n = n + active.long()
    assert torch.equal(state.x, x) and torch.equal(state.n, n)
    assert len(calls) == steps
    seen = []
    device_loop.cond_apply(torch.zeros(3, dtype=torch.bool),
                           lambda: seen.append(1), (),
                           any_running=any_running)
    device_loop.cond_apply(torch.ones(3, dtype=torch.bool),
                           lambda: seen.append(2), (),
                           any_running=any_running)
    assert seen == [2] and len(calls) == steps + 2


def test_batched_solver_syncs_are_counted_once_a_step():
    before = batched.host_syncs
    w0 = torch.zeros(3, 2, dtype=torch.float64)

    def fun(w):
        return (torch.sum((w - 1.0) ** 2, dim=-1), 2.0 * (w - 1.0))

    res = batched.lbfgs(fun, w0, optim.OptimizerConfig())
    assert batched.host_syncs > before
    np.testing.assert_allclose(res.coefficients.numpy(), 1.0, atol=1e-6)


def test_random_effect_box_constraints_ride_the_fused_fit():
    """Box constraints on a random effect are no ineligibility reason:
    its buckets take the batched L-BFGS-B route inside the fused fit.
    The port's fused fit against the reference's and against its own
    unfused loop, float64."""
    jdata, pdata = both_datasets(game_arrays(14, "logistic"))
    box = (-0.3, 0.3)
    out = {}
    for name, unfused in (("fused", False), ("unfused", True)):
        jest, pest = both_estimators("logistic", num_iterations=2,
                                     unfused=unfused)
        for est in (jest, pest):
            cfg = est.coordinate_configs["per-user"]
            est.coordinate_configs["per-user"] = dataclasses.replace(
                cfg, optimization=dataclasses.replace(
                    cfg.optimization, optimizer=dataclasses.replace(
                        cfg.optimization.optimizer, box_constraints=box)))
        out[name] = fit_both(jest, pest, jdata, pdata)
        assert (pest._fused_cache is None) == unfused
    (jf, pf), (_, pu) = out["fused"], out["unfused"]
    assert_close(pf[0].model, jf[0].model)
    assert_diagnostics_equal(pf[0], jf[0])
    assert_close(pf[0].model, pu[0].model)
    w = coef_maps(pf[0].model)["per-user"]
    assert w.min() >= -0.3 and w.max() <= 0.3
