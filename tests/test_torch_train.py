"""The port's GLMix training path against the JAX package's.

The same numpy data, made from a seed, goes through both packages'
``make_game_dataset``; each side then plans, fits and scores on its own.
On the CPU the port's Newton solves take their plain routes; in float64
the JAX package takes its batch-minor XLA route too, so the two fits
differ only in the order of floating-point sums.

Tolerances:
- plan arrays are compared byte for byte;
- float64 fits: rtol 1e-6 / atol 1e-8 on coefficients. The solvers make
  the same decisions on the same values; only sums are reassociated,
  ~1e-15 per step, which the Newton and L-BFGS iterations carry to the
  stopping point. Iteration counts and convergence reasons must match;
- float32 fixed-effect L-BFGS: rtol 2e-4 / atol 2e-5. Reassociated f32
  sums (~1e-7) move the Wolfe probes slightly; the optimum agrees to
  the solver's own tolerance.
- checkpoints written by the port load in the JAX package with the same
  arrays, and score to 1e-12 in float64.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu import optim as jax_optim
from photon_tpu.algorithm.problems import (
    GLMOptimizationConfiguration as JaxGLMConfig,
)
from photon_tpu.algorithm.problems import _run_impl as jax_run_impl
from photon_tpu.algorithm.problems import VarianceComputationType as JaxVar
from photon_tpu.data import dataset as jax_dataset
from photon_tpu.data import game_data as jax_game_data
from photon_tpu.data import random_effect as jax_re
from photon_tpu.estimators import game_estimator as jax_est
from photon_tpu.io import model_io as jax_model_io
from photon_tpu.ops.normalization import NormalizationContext as JaxNorm
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch import optim
from photon_tpu_torch.algorithm import random_effect as pt_re_alg
from photon_tpu_torch.algorithm.problems import (
    GLMOptimizationConfiguration,
    VarianceComputationType,
    run_impl,
)
from photon_tpu_torch.data import dataset as pt_dataset
from photon_tpu_torch.data import game_data as pt_game_data
from photon_tpu_torch.data import random_effect as pt_re
from photon_tpu_torch.estimators import game_estimator as pt_est
from photon_tpu_torch.io import model_io as pt_model_io
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.types import TaskType

CPU = "cpu"
N, D, DU, DM = 2400, 6, 4, 3
N_USERS, N_MOVIES = 60, 25
JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
TASKS = {"logistic": (TaskType.LOGISTIC_REGRESSION,
                      JaxTask.LOGISTIC_REGRESSION),
         "poisson": (TaskType.POISSON_REGRESSION, JaxTask.POISSON_REGRESSION)}


def synth(seed=5, task="logistic", n=N):
    """Numpy arrays of a small GLMix problem: a global shard, a per-user
    and a per-movie shard (last column the intercept), skewed entity
    sizes so that buckets, the reservoir cap and the lower bound all
    bind."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D))
    x[:, -1] = 1.0
    xu = rng.normal(size=(n, DU))
    xu[:, -1] = 1.0
    xm = rng.normal(size=(n, DM))
    xm[:, -1] = 1.0
    users = np.minimum(rng.zipf(1.6, size=n) - 1, N_USERS - 1)
    movies = rng.integers(0, N_MOVIES, size=n)
    # User 3 never has its intercept: its subspace lacks that slot.
    xu[users == 3, -1] = 0.0
    z = (x @ (rng.normal(size=D) * 0.3)
         + np.einsum("nd,nd->n", xu, rng.normal(size=(N_USERS, DU))[users]
                     * 0.3)
         + np.einsum("nd,nd->n", xm, rng.normal(size=(N_MOVIES, DM))[movies]
                     * 0.2))
    if task == "logistic":
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(float)
    else:
        y = rng.poisson(np.exp(0.5 * z)).astype(float)
    return dict(x=x, xu=xu, xm=xm, users=users, movies=movies, y=y)


def both_datasets(arrays, dtype=torch.float64, sparse_user=False):
    """The same data as a JAX and a port GameDataset."""
    jd = JAX_DTYPE[dtype]

    def shards(mod):
        out = {"global": mod.DenseFeatures(arrays["x"]),
               "movieShard": mod.DenseFeatures(arrays["xm"])}
        if sparse_user:
            idx = np.tile(np.arange(DU, dtype=np.int32), (N, 1))
            idx[:, 0] = np.where(arrays["users"] % 2 == 0, 0, DU + 1)
            out["userShard"] = mod.SparseFeatures(idx, arrays["xu"], DU + 2)
        else:
            out["userShard"] = mod.DenseFeatures(arrays["xu"])
        return out

    tags = {"userId": arrays["users"], "movieId": arrays["movies"]}
    jdata = jax_game_data.make_game_dataset(
        arrays["y"], shards(jax_dataset), id_tags=tags, dtype=jd)
    pdata = pt_game_data.make_game_dataset(
        arrays["y"], shards(pt_dataset), id_tags=tags, dtype=dtype,
        device=CPU)
    return jdata, pdata


RE_CONFIGS = [
    dict(random_effect_type="userId", feature_shard_id="userShard",
         active_data_upper_bound=40, active_data_lower_bound=3,
         min_bucket_entities=4),
    dict(random_effect_type="userId", feature_shard_id="userShard",
         bucket_caps=(8, 32), min_bucket_entities=0),
    dict(random_effect_type="movieId", feature_shard_id="movieShard",
         active_data_upper_bound=64, min_bucket_entities=30),
]


@pytest.mark.parametrize("sparse_user", [False, True])
@pytest.mark.parametrize("cfg", RE_CONFIGS, ids=["cap", "caps", "movie"])
def test_plan_arrays_are_byte_identical(cfg, sparse_user):
    arrays = synth()
    jdata, pdata = both_datasets(arrays, sparse_user=sparse_user)
    shard = cfg["feature_shard_id"]
    icpt = {"userShard": DU - 1, "movieShard": DM - 1}[shard]
    jds = jax_re.build_random_effect_dataset(
        jdata, jax_re.RandomEffectDataConfiguration(**cfg),
        intercept_index=icpt)
    pds = pt_re.build_random_effect_dataset(
        pdata, pt_re.RandomEffectDataConfiguration(**cfg),
        intercept_index=icpt)
    assert len(jds.blocks) == len(pds.blocks) >= 1
    for jb, pb in zip(jds.blocks, pds.blocks):
        for f in ("entity_codes", "row_ids", "row_counts", "proj",
                  "intercept_slots"):
            a, b = np.asarray(getattr(jb, f)), np.asarray(getattr(pb, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), f
    assert np.asarray(jds.proj_all).tobytes() == pds.proj_all.tobytes()
    assert np.asarray(jds.sub_dims).tobytes() == pds.sub_dims.tobytes()
    inv_j = np.asarray(jds.score_inv_device())
    assert inv_j.tobytes() == pds.score_inv_np.tobytes()
    cov_j, passive_j = jds.covered_row_partition()
    cov_p, passive_p = pds.covered_row_partition()
    assert cov_j.tobytes() == cov_p.tobytes()
    assert passive_j.tobytes() == passive_p.tobytes()
    if cfg.get("active_data_upper_bound") == 40:
        # The fixture exercises what it claims to.
        assert passive_p.size > 0
        assert (pds.proj_all[3] == DU - 1).sum() == 0
        assert (np.concatenate(pds.block_intercepts_np) < 0).any()


def test_plan_with_prior_support_and_pearson_filter():
    arrays = synth(seed=8)
    jdata, pdata = both_datasets(arrays)
    extra = {1: np.array([DU + 3]), 4: np.array([0, 2])}
    kw = dict(random_effect_type="userId", feature_shard_id="userShard",
              features_to_samples_ratio=0.05)
    jds = jax_re.build_random_effect_dataset(
        jdata, jax_re.RandomEffectDataConfiguration(**kw),
        intercept_index=DU - 1, extra_features=extra)
    pds = pt_re.build_random_effect_dataset(
        pdata, pt_re.RandomEffectDataConfiguration(**kw),
        intercept_index=DU - 1, extra_features=extra)
    assert np.asarray(jds.proj_all).tobytes() == pds.proj_all.tobytes()
    assert (pds.proj_all[1] == DU + 3).any()
    for jb, pb in zip(jds.blocks, pds.blocks):
        assert np.asarray(jb.proj).tobytes() == np.asarray(pb.proj).tobytes()


@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float64, 1e-9, 1e-11),
    (torch.float32, 2e-4, 2e-5),
])
@pytest.mark.parametrize("normalized", [False, True])
def test_fixed_effect_lbfgs_matches_run_impl(dtype, rtol, atol, normalized):
    arrays = synth(seed=11)
    jdata, pdata = both_datasets(arrays, dtype)
    rng = np.random.default_rng(2)
    offsets = rng.normal(size=N) * 0.1
    factors = np.r_[rng.uniform(0.5, 2.0, size=D - 1), 1.0]
    shifts = np.r_[rng.normal(size=D - 1) * 0.1, 0.0]
    jnorm, pnorm = JaxNorm(), NormalizationContext()
    if normalized:
        jd = JAX_DTYPE[dtype]
        jnorm = JaxNorm(jnp.asarray(factors, jd), jnp.asarray(shifts, jd), D - 1)
        pnorm = NormalizationContext(torch.tensor(factors, dtype=dtype),
                                     torch.tensor(shifts, dtype=dtype), D - 1)
    jbatch = jdata.shard_batch("global")
    jbatch = jbatch.with_offsets(jnp.asarray(offsets, jbatch.labels.dtype))
    pbatch = pdata.shard_batch("global")
    pbatch = pbatch.with_offsets(torch.tensor(offsets, dtype=dtype))
    w0 = rng.normal(size=D) * 0.05
    cfg = jax_optim.OptimizerConfig()
    jm, _, jres = jax_run_impl(
        jbatch, jnp.asarray(w0, jbatch.labels.dtype),
        jnp.asarray(0.0, jbatch.labels.dtype),
        jnp.asarray(0.5, jbatch.labels.dtype), jnorm, None,
        jnp.asarray(1.0, jbatch.labels.dtype),
        task=JaxTask.LOGISTIC_REGRESSION, opt_config=cfg, use_owlqn=False,
        intercept_index=D - 1, variance_computation=JaxVar.NONE)
    pm, _, pres = run_impl(
        pbatch, torch.tensor(w0, dtype=dtype), 0.0, 0.5, pnorm, None, 1.0,
        task=TaskType.LOGISTIC_REGRESSION, opt_config=optim.OptimizerConfig(),
        intercept_index=D - 1,
        variance_computation=VarianceComputationType.NONE)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=rtol,
                               atol=atol)
    if dtype == torch.float64:
        assert int(pres.iterations) == int(jres.iterations)
        assert int(pres.convergence_reason) == int(jres.convergence_reason)
        np.testing.assert_allclose(pres.loss_history.numpy(),
                                   np.asarray(jres.loss_history), rtol=1e-12)


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
def test_glm_closures_and_penalties_match_reference(sparse, normalized):
    """Value and gradient, HVP, Hessian diagonal and every penalty
    wrapper, float64, against ``photon_tpu.ops.glm`` and
    ``photon_tpu.optim.regularization``: rtol 1e-12 (the same formulas,
    sums in another order)."""
    from photon_tpu.ops import glm as jax_glm
    from photon_tpu.ops import losses as jax_losses
    from photon_tpu_torch.ops import glm as pt_glm
    from photon_tpu_torch.ops import losses as pt_losses

    arrays = synth(seed=13)
    jdata, pdata = both_datasets(arrays, sparse_user=sparse)
    shard = "userShard"
    d = DU + 2 if sparse else DU
    rng = np.random.default_rng(6)
    w, v, m = (rng.normal(size=d) * 0.3 for _ in range(3))
    var = np.abs(rng.normal(size=d)) + 0.1
    var[1] = 0.0  # a feature absent from the prior
    mask = np.r_[np.ones(d - 1), 0.0]
    jnorm, pnorm = JaxNorm(), NormalizationContext()
    if normalized:
        fac = np.r_[rng.uniform(0.5, 2.0, size=d - 1), 1.0]
        sh = np.r_[rng.normal(size=d - 1) * 0.1, 0.0]
        icpt = DU - 1
        jnorm = JaxNorm(jnp.asarray(fac), jnp.asarray(sh), icpt)
        pnorm = NormalizationContext(torch.tensor(fac), torch.tensor(sh),
                                     icpt)
    jb, pb = jdata.shard_batch(shard), pdata.shard_batch(shard)
    jl, pl = jax_losses.LOGISTIC, pt_losses.LOGISTIC
    jw, pw = jnp.asarray(w), torch.tensor(w)
    jv, pv = jnp.asarray(v), torch.tensor(v)
    jfun = jax_glm.make_value_and_grad(jb, jl, jnorm)
    pfun = pt_glm.make_value_and_grad(pb, pl, pnorm)
    jhvp = jax_glm.make_hvp(jb, jl, jnorm)
    phvp = pt_glm.make_hvp(pb, pl, pnorm)
    jinv = jax_optim.inverse_prior_variances(jnp.asarray(var), 0.4)
    pinv = optim.inverse_prior_variances(torch.tensor(var), 0.4)
    pairs = [
        (jfun(jw), pfun(pw)),
        (jax_optim.with_l2(jfun, 0.4, DU - 1)(jw),
         optim.with_l2(pfun, 0.4, DU - 1)(pw)),
        (jax_optim.with_l2_masked(jfun, 0.4, jnp.asarray(mask))(jw),
         optim.with_l2_masked(pfun, 0.4, torch.tensor(mask))(pw)),
        (jax_optim.with_gaussian_prior(jfun, 0.7, jnp.asarray(m), jinv)(jw),
         optim.with_gaussian_prior(pfun, 0.7, torch.tensor(m), pinv)(pw)),
        ((jhvp(jw, jv),), (phvp(pw, pv),)),
        ((jax_optim.with_l2_hvp(jhvp, 0.4, DU - 1)(jw, jv),),
         (optim.with_l2_hvp(phvp, 0.4, DU - 1)(pw, pv),)),
        ((jax_optim.with_l2_hvp_masked(jhvp, 0.4, jnp.asarray(mask))(jw, jv),),
         (optim.with_l2_hvp_masked(phvp, 0.4, torch.tensor(mask))(pw, pv),)),
        ((jax_optim.with_gaussian_prior_hvp(jhvp, 0.7, jinv)(jw, jv),),
         (optim.with_gaussian_prior_hvp(phvp, 0.7, pinv)(pw, pv),)),
        ((jax_glm.hessian_diagonal(jb, jl, jw, jnorm), jinv),
         (pt_glm.hessian_diagonal(pb, pl, pw, pnorm), pinv)),
        ((jax_glm.margins(jb, jw, jnorm),), (pt_glm.margins(pb, pw, pnorm),)),
    ]
    for k, (want, got) in enumerate(pairs):
        for a, b in zip(want, got, strict=True):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                       atol=1e-12, err_msg=str(k))


def l2(weight):
    return dict(
        jax=JaxGLMConfig(
            regularization=jax_optim.RegularizationContext(
                jax_optim.RegularizationType.L2),
            regularization_weight=weight),
        pt=GLMOptimizationConfiguration(
            regularization=optim.RegularizationContext(
                optim.RegularizationType.L2),
            regularization_weight=weight),
    )


def both_estimators(task, coords, num_iterations=2, normalization=None):
    """A JAX and a port GameEstimator of the same coordinates."""
    ptask, jtask = TASKS[task]
    cfgs = {"jax": {}, "pt": {}}
    for cid, (kind, spec, weight) in coords.items():
        opt = l2(weight)
        if kind == "fixed":
            cfgs["jax"][cid] = jax_est.FixedEffectCoordinateConfiguration(
                spec, opt["jax"])
            cfgs["pt"][cid] = pt_est.FixedEffectCoordinateConfiguration(
                spec, opt["pt"])
        else:
            cfgs["jax"][cid] = jax_est.RandomEffectCoordinateConfiguration(
                jax_re.RandomEffectDataConfiguration(**spec), opt["jax"])
            cfgs["pt"][cid] = pt_est.RandomEffectCoordinateConfiguration(
                pt_re.RandomEffectDataConfiguration(**spec), opt["pt"])
    icpt = {"global": D - 1, "userShard": DU - 1, "movieShard": DM - 1}
    # The non-finite guard keeps both estimators on their unfused loops
    # (the fused fits are held in test_torch_fused_fit.py); it changes
    # no result of a finite fit.
    jest = jax_est.GameEstimator(
        jtask, cfgs["jax"], num_iterations=num_iterations, mesh="off",
        intercept_indices=icpt, non_finite_guard=True,
        normalization=(normalization or {}).get("jax"))
    pest = pt_est.GameEstimator(
        ptask, cfgs["pt"], num_iterations=num_iterations,
        intercept_indices=icpt, device=CPU, non_finite_guard=True,
        normalization=(normalization or {}).get("pt"))
    return jest, pest


USER = dict(random_effect_type="userId", feature_shard_id="userShard",
            active_data_upper_bound=40, active_data_lower_bound=2,
            min_bucket_entities=4)
MOVIE = dict(random_effect_type="movieId", feature_shard_id="movieShard",
             active_data_upper_bound=64)
FE_1RE = {"global": ("fixed", "global", 1e-3), "per-user": ("re", USER, 1.0)}
FE_2RE = {**FE_1RE, "per-movie": ("re", MOVIE, 0.5)}


def model_arrays(model):
    """Coefficient arrays of a GameModel of either package, by name."""
    out = {}
    for cid, m in model.items():
        if hasattr(m, "model"):
            out[cid] = np.asarray(m.model.coefficients.means)
        else:
            out[cid] = np.asarray(m.coefficients)
    return out


def assert_models_close(pmodel, jmodel, rtol, atol):
    pa, ja = model_arrays(pmodel), model_arrays(jmodel)
    assert pa.keys() == ja.keys()
    for cid in pa:
        np.testing.assert_allclose(pa[cid], ja[cid], rtol=rtol, atol=atol,
                                   err_msg=cid)


def assert_history_matches(pres, jres):
    for ph, jh in zip(pres.descent.history, jres.descent.history,
                      strict=True):
        assert ph.coordinate_id == jh.coordinate_id
        if hasattr(jh.diagnostics, "convergence_reason_counts"):
            assert (ph.diagnostics.convergence_reason_counts
                    == jh.diagnostics.convergence_reason_counts)
            np.testing.assert_array_equal(
                ph.diagnostics.iterations,
                jh.diagnostics._materialize()[1])
        else:
            assert int(ph.diagnostics.iterations) == int(
                jh.diagnostics.iterations)


@pytest.mark.parametrize("task", ["logistic", "poisson"])
@pytest.mark.parametrize("coords", [FE_1RE, FE_2RE], ids=["fe1re", "fe2re"])
def test_game_estimator_fit_matches_reference_f64(task, coords):
    arrays = synth(seed=21, task=task)
    jdata, pdata = both_datasets(arrays)
    jest, pest = both_estimators(task, coords)
    jres = jest.fit(jdata)
    pres = pest.fit(pdata)
    assert len(pres) == len(jres) == 1
    assert_models_close(pres[0].model, jres[0].model, 1e-6, 1e-8)
    assert_history_matches(pres[0], jres[0])


def test_fit_without_cached_slabs_matches_cached(monkeypatch):
    """Past the slab budget a bucket stays a plan: its slab is gathered
    inside every solve and again for its rows' scores. The fit is the
    same as with cached slabs."""
    arrays = synth(seed=27)
    _, pdata = both_datasets(arrays)
    _, cached = both_estimators("logistic", FE_2RE)
    want = cached.fit(pdata)[0].model
    monkeypatch.setattr(pt_re, "_DEVICE_SLAB_BUDGET_BYTES", 0)
    _, lazy = both_estimators("logistic", FE_2RE)
    datasets, _ = lazy.prepare(pdata)
    assert not any(isinstance(b, pt_re.EntityBlocks)
                   for cid in ("per-user", "per-movie")
                   for b in datasets[cid].device_blocks())
    got = lazy.fit(pdata)[0].model
    assert_models_close(got, want, 1e-12, 1e-12)


def test_fit_with_normalization_and_config_sequence_f64():
    arrays = synth(seed=23)
    rng = np.random.default_rng(4)
    fac = np.r_[rng.uniform(0.5, 2.0, size=DU - 1), 1.0]
    sh = np.r_[rng.normal(size=DU - 1) * 0.2, 0.0]
    norm = {
        "jax": {"userShard": JaxNorm(jnp.asarray(fac), jnp.asarray(sh),
                                     DU - 1)},
        "pt": {"userShard": NormalizationContext(
            torch.tensor(fac), torch.tensor(sh), DU - 1)},
    }
    user = dict(USER, active_data_lower_bound=None)
    coords = {"global": ("fixed", "global", 1e-3),
              "per-user": ("re", dict(user, feature_shard_id="userShard"),
                           1.0)}
    arrays["xu"][arrays["users"] == 3, -1] = 1.0  # every entity: intercept
    jdata, pdata = both_datasets(arrays)
    jest, pest = both_estimators("logistic", coords, normalization=norm)
    seq = [{"per-user": l2(w)["jax"]} for w in (3.0, 0.3)]
    pseq = [{"per-user": l2(w)["pt"]} for w in (3.0, 0.3)]
    jres = jest.fit(jdata, opt_config_sequence=seq)
    pres = pest.fit(pdata, opt_config_sequence=pseq)
    assert len(pres) == 2
    for p, j in zip(pres, jres):
        assert_models_close(p.model, j.model, 1e-6, 1e-8)
        assert_history_matches(p, j)


def test_warm_start_from_a_jax_trained_model():
    arrays = synth(seed=31)
    jdata, pdata = both_datasets(arrays)
    jest, pest = both_estimators("logistic", FE_2RE, num_iterations=1)
    seed_model = jest.fit(jdata)[0].model
    # The JAX model crosses as numpy arrays keyed as the checkpoint keys
    # them: fixed-effect means, RE coefficients, proj_all, entity keys.
    arr, manifest = {}, {}
    for cid, m in seed_model.items():
        if hasattr(m, "model"):
            arr[f"{cid}/means"] = np.asarray(m.model.coefficients.means)
            manifest[cid] = {"kind": "fixed", "shard": m.feature_shard_id,
                             "task": m.task.value}
        else:
            arr[f"{cid}/coefficients"] = np.asarray(m.coefficients)
            arr[f"{cid}/proj_all"] = np.asarray(m.proj_all)
            manifest[cid] = {"kind": "random", "shard": m.feature_shard_id,
                             "re_type": m.random_effect_type,
                             "task": m.task.value,
                             "entity_keys": list(m.entity_keys)}
    pinit = pt_model_io.game_model_from_numpy(arr, manifest, CPU)
    # ...and back: the port's arrays of it are the same arrays.
    back, back_manifest = pt_model_io.game_model_to_numpy(pinit)
    assert back_manifest == manifest
    for k in arr:
        assert back[k].tobytes() == arr[k].tobytes()
    jres = jest.fit(jdata, initial_model=seed_model)
    pres = pest.fit(pdata, initial_model=pinit)
    assert_models_close(pres[0].model, jres[0].model, 1e-6, 1e-8)
    assert_history_matches(pres[0], jres[0])
    # Warm-started solves converge in fewer Newton iterations.
    cold = pest.fit(pdata)[0]
    warm_it = pres[0].descent.history[1].diagnostics.iterations_mean
    cold_it = cold.descent.history[1].diagnostics.iterations_mean
    assert warm_it < cold_it


def test_port_checkpoint_loads_in_jax_and_scores_identically(tmp_path):
    arrays = synth(seed=41)
    jdata, pdata = both_datasets(arrays)
    _, pest = both_estimators("logistic", FE_2RE)
    pmodel = pest.fit(pdata)[0].model
    path = pt_model_io.save_checkpoint(pmodel, str(tmp_path / "m.npz"))
    jmodel = jax_model_io.load_checkpoint(path)
    pa, ja = model_arrays(pmodel), model_arrays(jmodel)
    for cid in pa:
        assert pa[cid].tobytes() == ja[cid].tobytes()
    # Scores of the training rows: the port's own scorers against the
    # JAX package's, each on its own dataset.
    pds, _ = pest.prepare(pdata)
    jest, _ = both_estimators("logistic", FE_2RE)
    jds = jest.prepare(jdata)[0]
    pz = pmodel["global"].model.coefficients.compute_score(
        pdata.feature_shards["global"]).numpy()
    jz = np.asarray(jmodel["global"].model.coefficients.compute_score(
        jdata.feature_shards["global"]))
    for cid in ("per-user", "per-movie"):
        pz = pz + pmodel[cid].score_dataset(pds[cid]).numpy()
        jz = jz + np.asarray(jmodel[cid].score_dataset(jds[cid]))
    np.testing.assert_allclose(pz, jz, rtol=1e-12, atol=1e-12)


def test_entry_points_default_to_cuda_and_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the default resolves to it")
    arrays = synth()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_est.GameEstimator(TaskType.LOGISTIC_REGRESSION, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_game_data.make_game_dataset(
            arrays["y"], {"global": pt_dataset.DenseFeatures(arrays["x"])})


def test_unported_routes_raise_not_implemented():
    """The routes that raised here before run: the lazy layout's ELL
    slab for a subspace wider than ``DENSE_SUB_DIM_MAX`` gathers the
    reference's indices and values (bf16 training now trains:
    tests/test_torch_precision.py). The L1 fixed effect
    (OWL-QN) and the smoothed hinge's per-entity quasi-Newton solve,
    which raised here before, run and match the reference in float64:
    coefficients within rtol 1e-6 / atol 1e-8 (the fit's tolerance),
    OWL-QN's exact zeros and the per-entity iterations equal."""
    from photon_tpu.algorithm import random_effect as jax_ra_alg

    arrays = synth()
    jdata, pdata = both_datasets(arrays)
    cfgs = {}
    for side, opt, cls in (("jax", jax_optim, JaxGLMConfig),
                           ("pt", optim, GLMOptimizationConfiguration)):
        cfgs[side] = cls(
            regularization=opt.RegularizationContext(
                opt.RegularizationType.L1), regularization_weight=40.0)
    est = pt_est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"global": pt_est.FixedEffectCoordinateConfiguration(
            "global", cfgs["pt"])}, device=CPU)
    jest = jax_est.GameEstimator(
        JaxTask.LOGISTIC_REGRESSION,
        {"global": jax_est.FixedEffectCoordinateConfiguration(
            "global", cfgs["jax"])}, mesh="off", non_finite_guard=True)
    pw = est.fit(pdata)[0].model["global"].model.coefficients.means.numpy()
    jw = np.asarray(jest.fit(jdata)[0].model["global"].model.coefficients
                    .means)
    np.testing.assert_allclose(pw, jw, rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(pw == 0.0, jw == 0.0)
    assert (pw == 0.0).any()
    # A lazy bucket wider than DENSE_SUB_DIM_MAX gathers the ELL slab
    # layout (the lookup-table gather of a dense shard), as the
    # reference's materialize does.
    rng = np.random.default_rng(5)
    wide = pt_re.DENSE_SUB_DIM_MAX + 2
    y_w = rng.normal(size=64).astype(np.float32)
    x_w = rng.normal(size=(64, wide)).astype(np.float32)
    g_w = {"g": rng.integers(0, 4, size=64)}
    wide_data = pt_game_data.make_game_dataset(
        y_w, {"w": pt_dataset.DenseFeatures(x_w)}, id_tags=g_w, device=CPU)
    lazy_wide = pt_re.build_random_effect_dataset(
        wide_data, pt_re.RandomEffectDataConfiguration("g", "w"), lazy=True)
    assert lazy_wide.is_lazy and lazy_wide.max_sub_dim == wide
    jwide = jax_re.build_random_effect_dataset(
        jax_game_data.make_game_dataset(
            y_w, {"w": jax_dataset.DenseFeatures(x_w)}, id_tags=g_w),
        jax_re.RandomEffectDataConfiguration("g", "w"), lazy=True)
    for pb, jp in zip(lazy_wide.device_blocks(), jwide.device_plans(),
                      strict=True):
        jb = jp.materialize()
        assert not pb.is_dense and pb.x_indices.shape[-1] == wide
        np.testing.assert_array_equal(pb.x_indices.numpy(),
                                      np.asarray(jb.x_indices))
        np.testing.assert_array_equal(pb.x_values.numpy(),
                                      np.asarray(jb.x_values))
    # The smoothed hinge on the materialized layout takes the
    # per-entity quasi-Newton route in both packages.
    spec = dict(random_effect_type="userId", feature_shard_id="userShard",
                score_table_width_cap=2)
    ds = pt_re.build_random_effect_dataset(
        pdata, pt_re.RandomEffectDataConfiguration(**spec))
    jds = jax_re.build_random_effect_dataset(
        jdata, jax_re.RandomEffectDataConfiguration(**spec))
    assert not ds.is_lazy
    before = pt_re_alg.quasi_newton_solves
    pm, ps = pt_re_alg.RandomEffectCoordinate(
        ds, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM, l2(1.0)["pt"]).train()
    assert pt_re_alg.quasi_newton_solves > before
    jm, js = jax_ra_alg.RandomEffectCoordinate(
        jds, JaxTask.SMOOTHED_HINGE_LOSS_LINEAR_SVM, l2(1.0)["jax"]).train()
    np.testing.assert_array_equal(ps.iterations, js._materialize()[1])
    np.testing.assert_allclose(pm.coefficients.numpy(),
                               np.asarray(jm.coefficients), rtol=1e-6,
                               atol=1e-8)


@pytest.mark.parametrize("task", ["logistic", "poisson"])
def test_fit_with_validation_matches_reference_f64(task):
    """``fit(validation=...)`` on a two-config sequence: every update's
    evaluation, each config's best model and best evaluation, and
    ``select_best`` equal the reference's unfused loop (float64)."""
    arrays = synth(seed=51, task=task)
    jdata, pdata = both_datasets(arrays)
    jval, pval = both_datasets(synth(seed=52, task=task, n=900))
    jest, pest = both_estimators(task, FE_2RE, num_iterations=3)
    metric = "AUC" if task == "logistic" else "POISSON_LOSS"
    jest.evaluators = pest.evaluators = [metric, "AUC:userId", "RMSE"]
    seq = [{"per-user": l2(w)["jax"]} for w in (30.0, 0.3)]
    pseq = [{"per-user": l2(w)["pt"]} for w in (30.0, 0.3)]
    jres = jest.fit(jdata, jval, seq)
    pres = pest.fit(pdata, pval, pseq)
    assert len(pres) == len(jres) == 2
    for p, j in zip(pres, jres):
        assert_models_close(p.model, j.model, 1e-6, 1e-8)
        assert_history_matches(p, j)
        for ph, jh in zip(p.descent.history, j.descent.history,
                          strict=True):
            assert ph.evaluation.evaluations.keys() == (
                jh.evaluation.evaluations.keys())
            for k, v in jh.evaluation.evaluations.items():
                assert ph.evaluation.evaluations[k] == pytest.approx(
                    v, rel=1e-9), k
        assert p.evaluation.evaluations == pytest.approx(
            j.evaluation.evaluations, rel=1e-9)
        # Only a full model may be the best.
        assert {cid for cid, _ in p.model.items()} == {
            "global", "per-user", "per-movie"}
    assert pres.index(pest.select_best(pres)) == jres.index(
        jest.select_best(jres))


def test_fit_init_model_path_matches_reference_f64(tmp_path):
    """``fit(init_model=PATH)`` warm-starts from a native checkpoint as
    the reference's does: the port's one-config model, saved by the
    port's ``save_checkpoint``, seeds both packages' fits (float64), and
    the port's equals its own ``fit(initial_model=...)`` of the loaded
    model. Giving both forms raises in both packages."""
    arrays = synth(seed=61)
    jdata, pdata = both_datasets(arrays)
    jest, pest = both_estimators("logistic", FE_2RE, num_iterations=1)
    path = pt_model_io.save_checkpoint(pest.fit(pdata)[0].model,
                                       str(tmp_path / "day0.npz"))
    jres = jest.fit(jdata, init_model=path)
    pres = pest.fit(pdata, init_model=path)
    assert_models_close(pres[0].model, jres[0].model, 1e-6, 1e-8)
    assert_history_matches(pres[0], jres[0])
    same = pest.fit(pdata,
                    initial_model=pt_model_io.load_checkpoint(path, CPU))
    assert_models_close(pres[0].model, same[0].model, 0, 0)
    seed_model = pt_model_io.load_checkpoint(path, CPU)
    with pytest.raises(ValueError, match="exactly one"):
        pest.fit(pdata, initial_model=seed_model, init_model=path)
    with pytest.raises(ValueError, match="exactly one"):
        jest.fit(jdata, initial_model=jax_model_io.load_checkpoint(path),
                 init_model=path)
