"""The training routes of the optimizer slice against the JAX package:
the per-entity quasi-Newton route, coefficient variances on every
route, the fixed effect's OWL-QN / TRON / L-BFGS-B / variances / prior,
down-sampling with the reference's draws, and a whole fit with every
new option followed by an incremental refit.

The data are ``tests/test_torch_train.py``'s GLMix (numpy from a seed,
the same arrays through both packages' ``make_game_dataset``).

Tolerances:
- float64: each entity's iterations and convergence reason equal to
  the reference's; coefficients within 1e-9 (1 + |w|) (an entity with
  no penalty, at ``incremental_weight`` 0, drifts to |w| ~ 20 along a
  flat valley), OWL-QN's exact zeros equal; variances within rtol
  1e-9 (the same formulas, sums in another order, one Cholesky or
  CG). Whole fits: rtol 1e-6 / atol 1e-8 on coefficients and
  variances, as ``test_torch_train.py`` holds a float64 fit;
- float32 (the quasi-Newton route, well-posed cases): each package's
  f32 coefficients within ``RE_FIT_ATOL`` = 2e-3 of the port's float64
  solve, the bound ``tests/test_torch_wide.py`` derives for an f32
  solve of a per-entity GLM (an f32 loop stops within 4 u F of the
  optimum; with curvature h ~ 0.2 R + l2, sqrt(24 u) ~ 1.2e-3, held at
  twice that);
- down-sampling: the weights the port's mask makes from the
  reference's uniforms equal the reference's, bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as tt
from photon_tpu import optim as jax_optim
from photon_tpu.algorithm import random_effect as jax_ra
from photon_tpu.algorithm.problems import (
    GLMOptimizationConfiguration as JaxGLMConfig,
)
from photon_tpu.algorithm.problems import VarianceComputationType as JaxVar
from photon_tpu.algorithm.problems import _run_impl as jax_run_impl
from photon_tpu.data import random_effect as jax_re
from photon_tpu.data import sampling as jax_sampling
from photon_tpu.estimators import game_estimator as jax_est
from photon_tpu.ops.normalization import NormalizationContext as JaxNorm
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch import optim
from photon_tpu_torch.algorithm import random_effect as pt_ra
from photon_tpu_torch.algorithm.problems import (
    GLMOptimizationConfiguration,
    VarianceComputationType,
    run_impl,
)
from photon_tpu_torch.data import random_effect as pt_re
from photon_tpu_torch.data import sampling as pt_sampling
from photon_tpu_torch.estimators import game_estimator as pt_est
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.optim import batched
from photon_tpu_torch.types import TaskType

COEF_ATOL, VAR_RTOL = 1e-9, 1e-9
RE_FIT_ATOL = 2e-3


def glm_configs(reg="L2", weight=1.0, *, alpha=None, tron=False, box=None,
                variance="NONE", incremental_weight=1.0, rate=1.0):
    """The same GLMOptimizationConfiguration in both packages."""
    out = {}
    for side, opt, cfg_cls, var in (
            ("jax", jax_optim, JaxGLMConfig, JaxVar),
            ("pt", optim, GLMOptimizationConfiguration,
             VarianceComputationType)):
        kw = {} if box is None else {"box_constraints": box}
        oc = (opt.OptimizerConfig.tron(**kw) if tron
              else opt.OptimizerConfig.lbfgs(**kw))
        out[side] = cfg_cls(
            optimizer=oc,
            regularization=opt.RegularizationContext(
                opt.RegularizationType(reg), alpha),
            regularization_weight=weight, variance_computation=var(variance),
            incremental_weight=incremental_weight, down_sampling_rate=rate)
    return out


def datasets(arrays, dtype, spec):
    jdata, pdata = tt.both_datasets(arrays, dtype)
    shard = spec["feature_shard_id"]
    icpt = {"userShard": tt.DU - 1, "movieShard": tt.DM - 1}[shard]
    jds = jax_re.build_random_effect_dataset(
        jdata, jax_re.RandomEffectDataConfiguration(**spec),
        intercept_index=icpt)
    pds = pt_re.build_random_effect_dataset(
        pdata, pt_re.RandomEffectDataConfiguration(**spec),
        intercept_index=icpt)
    return jds, pds


def movie_norm(dtype):
    """Factors and shifts on the movie shard (its intercept last)."""
    rng = np.random.default_rng(9)
    fac = np.r_[rng.uniform(0.5, 2.0, size=tt.DM - 1), 1.0]
    sh = np.r_[rng.normal(size=tt.DM - 1) * 0.2, 0.0]
    return (JaxNorm(jnp.asarray(fac, tt.JAX_DTYPE[dtype]),
                    jnp.asarray(sh, tt.JAX_DTYPE[dtype]), tt.DM - 1),
            NormalizationContext(torch.tensor(fac, dtype=dtype),
                                 torch.tensor(sh, dtype=dtype), tt.DM - 1))


def stats_arrays(stats, jax_side: bool):
    if jax_side:
        reasons, iters = stats._materialize()
        return np.asarray(reasons), np.asarray(iters)
    return stats.reasons, stats.iterations


def train_both(jds, pds, task, cfgs, *, norm=None, priors=None):
    """Each package's RandomEffectCoordinate trained once; ((model,
    reasons, iterations) of the reference, of the port)."""
    jtask, ptask = JaxTask[task], TaskType[task]
    jn, pn = norm if norm is not None else (JaxNorm(), NormalizationContext())
    jp, pp = priors if priors is not None else (None, None)
    jcoord = jax_ra.RandomEffectCoordinate(jds, jtask, cfgs["jax"], jn,
                                           prior=jp)
    pcoord = pt_ra.RandomEffectCoordinate(pds, ptask, cfgs["pt"], pn,
                                          prior=pp)
    jm, js = jcoord.train()
    pm, ps = pcoord.train()
    return ((jm, *stats_arrays(js, True)), (pm, *stats_arrays(ps, False)))


def assert_entities_match(j, p, *, variances: bool):
    jm, jr, ji = j
    pm, pr, pi = p
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pr, jr)
    jw, pw = np.asarray(jm.coefficients), pm.coefficients.numpy()
    np.testing.assert_allclose(pw, jw, rtol=COEF_ATOL, atol=COEF_ATOL)
    np.testing.assert_array_equal(pw == 0.0, jw == 0.0)
    if variances:
        jv, pv = np.asarray(jm.variances), pm.variances.numpy()
        np.testing.assert_array_equal(np.isinf(pv), np.isinf(jv))
        np.testing.assert_allclose(pv, jv, rtol=VAR_RTOL, atol=0)
    else:
        assert pm.variances is None


# name -> (task, glm_configs kwargs, dataset spec, normalized)
QN_CASES = {
    "l1": ("LOGISTIC_REGRESSION", dict(reg="L1", weight=2.0,
                                       variance="SIMPLE"), tt.USER, False),
    "elastic_net": ("LOGISTIC_REGRESSION",
                    dict(reg="ELASTIC_NET", weight=2.0, alpha=0.5,
                         variance="FULL"), tt.MOVIE, True),
    "l2_zero": ("LINEAR_REGRESSION", dict(weight=0.0), tt.USER, False),
    "box": ("POISSON_REGRESSION", dict(box=(-0.3, 0.3),
                                       variance="SIMPLE"), tt.USER, False),
    "smoothed_hinge": ("SMOOTHED_HINGE_LOSS_LINEAR_SVM",
                       dict(variance="FULL"), tt.MOVIE, True),
    "tron": ("SMOOTHED_HINGE_LOSS_LINEAR_SVM",
             dict(weight=0.5, tron=True, variance="SIMPLE"), tt.USER, False),
}


@pytest.mark.parametrize("case", sorted(QN_CASES))
def test_quasi_newton_route_matches_the_vmapped_reference_f64(case):
    """Every bucket of the dataset on the quasi-Newton route, float64:
    per-entity iterations, reasons, coefficients, zeros and variances
    equal the reference's ``jax.vmap`` of ``_solve_one_entity``."""
    task, kw, spec, normalized = QN_CASES[case]
    arrays = tt.synth(seed=5, task="poisson" if "POISSON" in task
                      else "logistic")
    jds, pds = datasets(arrays, torch.float64, spec)
    norm = movie_norm(torch.float64) if normalized else None
    before = pt_ra.quasi_newton_solves
    syncs = batched.host_syncs
    j, p = train_both(jds, pds, task, glm_configs(**kw), norm=norm)
    assert pt_ra.quasi_newton_solves - before == len(pds.blocks)
    assert batched.host_syncs > syncs
    assert len(set(p[2].tolist())) > 1, "entities should stop apart"
    assert_entities_match(j, p, variances=kw.get("variance", "NONE")
                          != "NONE")
    if kw.get("reg") in ("L1", "ELASTIC_NET"):
        # Exact zeros inside the entities' subspaces, not just padding.
        valid = pds.proj_all >= 0
        assert (p[0].coefficients.numpy()[valid] == 0.0).any()


@pytest.mark.parametrize("case", ["elastic_net", "box", "smoothed_hinge",
                                  "tron"])
def test_quasi_newton_route_f32_is_within_the_bound_of_f64(case):
    """The well-posed cases in float32: each package's coefficients
    within RE_FIT_ATOL of the port's float64 solve."""
    task, kw, spec, normalized = QN_CASES[case]
    arrays = tt.synth(seed=5, task="poisson" if "POISSON" in task
                      else "logistic")
    want = None
    for dtype in (torch.float64, torch.float32):
        jds, pds = datasets(arrays, dtype, spec)
        norm = movie_norm(dtype) if normalized else None
        j, p = train_both(jds, pds, task, glm_configs(**kw), norm=norm)
        if dtype == torch.float64:
            want = p[0].coefficients.numpy()
            continue
        for side, m in (("reference", np.asarray(j[0].coefficients)),
                        ("port", p[0].coefficients.numpy())):
            np.testing.assert_allclose(m, want, rtol=0, atol=RE_FIT_ATOL,
                                       err_msg=side)


def prior_models(jm, pm):
    """Each package's fitted model as its own prior (both are laid out
    on the dataset they were fitted on)."""
    assert jm.variances is not None and pm.variances is not None
    return jm, pm


@pytest.mark.parametrize("variance,prior", [
    ("SIMPLE", "none"), ("FULL", "none"), ("SIMPLE", "prior"),
    ("FULL", "prior"), ("SIMPLE", "prior_iw0")])
def test_newton_route_variances_and_prior_match_the_reference_f64(variance,
                                                                  prior):
    """The logistic L2 route (damped Newton) with variances, and a
    second fit with the first one's model as its Gaussian prior; at
    ``incremental_weight`` 0 the bucket is not well posed and takes the
    quasi-Newton route, as the reference's does. (FULL is left out at
    weight 0: an unpenalized entity whose rows separate has a Hessian
    singular to working precision, and whether its Cholesky pivots stay
    positive follows the order of the sums, in either package.)"""
    arrays = tt.synth(seed=23)
    jds, pds = datasets(arrays, torch.float64, tt.USER)
    task = "LOGISTIC_REGRESSION"
    cfgs = glm_configs(variance=variance)
    j, p = train_both(jds, pds, task, cfgs)
    assert_entities_match(j, p, variances=True)
    if prior == "none":
        return
    iw = 0.0 if prior == "prior_iw0" else 2.0
    before = pt_ra.quasi_newton_solves
    j2, p2 = train_both(jds, pds, task,
                        glm_configs(variance=variance, incremental_weight=iw),
                        priors=prior_models(j[0], p[0]))
    assert (pt_ra.quasi_newton_solves > before) == (iw == 0.0)
    assert_entities_match(j2, p2, variances=True)
    # The prior pulls the refit toward the first fit's means.
    if iw > 0:
        moved = np.abs(p2[0].coefficients.numpy()
                       - p[0].coefficients.numpy()).max()
        assert moved < np.abs(p[0].coefficients.numpy()).max()


@pytest.mark.parametrize("variance", ["SIMPLE", "FULL"])
@pytest.mark.parametrize("normalized", [False, True])
def test_direct_route_variances_match_the_reference_f64(variance,
                                                         normalized):
    """The squared-loss exact solve with variances (the reference's
    ``_solve_one_entity_direct`` per entity)."""
    arrays = tt.synth(seed=29)
    arrays["y"] = arrays["x"] @ np.linspace(-1, 1, tt.D) + 0.1
    jds, pds = datasets(arrays, torch.float64, tt.MOVIE)
    norm = movie_norm(torch.float64) if normalized else None
    j, p = train_both(jds, pds, "LINEAR_REGRESSION",
                      glm_configs(variance=variance), norm=norm)
    assert_entities_match(j, p, variances=True)


@pytest.mark.parametrize("case", [
    dict(reg="L1", weight=3.0, variance="SIMPLE"),
    dict(reg="ELASTIC_NET", weight=3.0, alpha=0.3, variance="FULL"),
    dict(weight=0.5, tron=True, variance="FULL"),
    dict(weight=0.5, box=(-0.2, 0.3), variance="SIMPLE"),
], ids=["owlqn", "elastic_net", "tron", "lbfgsb"])
@pytest.mark.parametrize("prior", [False, True])
def test_fixed_effect_routes_match_run_impl_f64(case, prior):
    """``run_impl`` against the reference's ``_run_impl``: the solver
    the factory picks, variances at the optimum in the original space,
    normalized, from a warm start, with or without a Gaussian prior."""
    arrays = tt.synth(seed=31)
    jdata, pdata = tt.both_datasets(arrays)
    rng = np.random.default_rng(4)
    d = tt.D
    fac = np.r_[rng.uniform(0.5, 2.0, size=d - 1), 1.0]
    sh = np.r_[rng.normal(size=d - 1) * 0.1, 0.0]
    jnorm = JaxNorm(jnp.asarray(fac), jnp.asarray(sh), d - 1)
    pnorm = NormalizationContext(torch.tensor(fac), torch.tensor(sh), d - 1)
    w0 = rng.normal(size=d) * 0.05
    pri = ((rng.normal(size=d) * 0.1, rng.uniform(0.1, 2.0, size=d))
           if prior else None)
    cfgs = glm_configs(**case)
    jc, pc = cfgs["jax"], cfgs["pt"]
    jm, jv, jres = jax_run_impl(
        jdata.shard_batch("global"), jnp.asarray(w0),
        jnp.asarray(jc.l1_weight), jnp.asarray(jc.l2_weight), jnorm,
        None if pri is None else tuple(map(jnp.asarray, pri)),
        jnp.asarray(1.5), task=JaxTask.LOGISTIC_REGRESSION,
        opt_config=jc.optimizer, use_owlqn=jc.l1_weight != 0.0,
        intercept_index=d - 1, variance_computation=jc.variance_computation)
    pm, pv, pres = run_impl(
        pdata.shard_batch("global"), torch.tensor(w0), pc.l1_weight,
        pc.l2_weight, pnorm,
        None if pri is None else tuple(map(torch.tensor, pri)), 1.5,
        task=TaskType.LOGISTIC_REGRESSION, opt_config=pc.optimizer,
        intercept_index=d - 1, variance_computation=pc.variance_computation)
    assert int(pres.iterations) == int(jres.iterations)
    assert int(pres.convergence_reason) == int(jres.convergence_reason)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0,
                               atol=COEF_ATOL)
    np.testing.assert_array_equal(pm.numpy() == 0, np.asarray(jm) == 0)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=VAR_RTOL)


@pytest.mark.parametrize("variance", ["SIMPLE", "FULL"])
@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
def test_variance_functions_match_the_reference_f64(variance, normalized,
                                                     sparse):
    """``variances_in_transformed_space`` (with an L2 diagonal that has
    a zero-curvature slot and with a prior's diagonal) and
    ``compute_variances`` on dense and ELL features, float64: rtol
    1e-9, inf where the reference has inf."""
    from photon_tpu.algorithm import problems as jp
    from photon_tpu.ops import losses as jax_losses
    from photon_tpu_torch.algorithm import problems as pp
    from photon_tpu_torch.ops import losses as pt_losses

    arrays = tt.synth(seed=47)
    jdata, pdata = tt.both_datasets(arrays, sparse_user=sparse)
    jb, pb = jdata.shard_batch("userShard"), pdata.shard_batch("userShard")
    d = pb.num_features
    rng = np.random.default_rng(8)
    w = rng.normal(size=d) * 0.3
    jnorm, pnorm = JaxNorm(), NormalizationContext()
    if normalized:
        fac = np.r_[rng.uniform(0.5, 2.0, size=d - 1), 1.0]
        sh = np.r_[rng.normal(size=d - 1) * 0.1, 0.0]
        jnorm = JaxNorm(jnp.asarray(fac), jnp.asarray(sh), tt.DU - 1)
        pnorm = NormalizationContext(torch.tensor(fac), torch.tensor(sh),
                                     tt.DU - 1)
    jv, pv = JaxVar(variance), VarianceComputationType(variance)
    jl, pl = jax_losses.LOGISTIC, pt_losses.LOGISTIC
    diags = [np.r_[np.full(d - 1, 0.7), 0.0],
             np.abs(rng.normal(size=d)) * 2.0 + 0.1]
    if sparse:
        # Column DU + 1 never occurs in the ELL fixture: no curvature,
        # and with no penalty there, variance inf.
        diags[0][tt.DU + 1] = 0.0
    for diag in diags:
        want = np.asarray(jp.variances_in_transformed_space(
            jb, jl, jnp.asarray(w), jnorm, jnp.asarray(diag), jv))
        got = pp.variances_in_transformed_space(
            pb, pl, torch.tensor(w), pnorm, torch.tensor(diag), pv).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got, want, rtol=VAR_RTOL)
    for icpt in (None, tt.DU - 1):
        want = np.asarray(jp.compute_variances(
            jb, jl, jnp.asarray(w), jnorm, 0.5, icpt, jv))
        got = pp.compute_variances(pb, pl, torch.tensor(w), pnorm, 0.5, icpt,
                                   pv).numpy()
        np.testing.assert_allclose(got, want, rtol=VAR_RTOL)
    assert pp.compute_variances(pb, pl, torch.tensor(w), pnorm, 0.5, None,
                                VarianceComputationType.NONE) is None


def reference_uniforms(seed: int, shape) -> torch.Tensor:
    return torch.tensor(np.asarray(
        jax.random.uniform(jax.random.key(seed), shape)))


@pytest.mark.parametrize("binary", [True, False])
def test_downsampling_masks_the_reference_draws_as_the_reference(binary):
    arrays = tt.synth(seed=37)
    jdata, pdata = tt.both_datasets(arrays)
    jb, pb = jdata.shard_batch("global"), pdata.shard_batch("global")
    for seed in (0, 5):
        want = jax_sampling.downsample(jb, 0.3, jax.random.key(seed),
                                       binary=binary)
        u = reference_uniforms(seed, pb.labels.shape)
        fn = (pt_sampling.downsample_binary_negatives if binary
              else pt_sampling.downsample_uniform)
        got = fn(pb, 0.3, u)
        assert got.weights.numpy().tobytes() == np.asarray(
            want.weights).tobytes()
    # The port's own draw: seeded, in [0, 1), on the labels' device.
    u1 = pt_sampling.draw_uniforms(1000, 3, pb.labels)
    assert torch.equal(u1, pt_sampling.draw_uniforms(1000, 3, pb.labels))
    assert not torch.equal(u1, pt_sampling.draw_uniforms(1000, 4, pb.labels))
    assert float(u1.min()) >= 0.0 and float(u1.max()) < 1.0
    with pytest.raises(ValueError, match="rate"):
        pt_sampling.downsample(pb, 1.5, 0, binary=binary)


@pytest.fixture
def reference_draws(monkeypatch):
    """The port's down-sampling draws replaced by the reference's
    ``jax.random.uniform(jax.random.key(seed), shape)``."""
    monkeypatch.setattr(
        pt_sampling, "draw_uniforms",
        lambda n, seed, like: reference_uniforms(seed, (n,)).to(like.dtype))


def every_option_estimators(num_iterations=2, incremental=False,
                            iw=1.0):
    """A GLMix with every option of the slice: global TRON with FULL
    variances and down-sampling 0.5, per-user elastic net (quasi-Newton
    route) with SIMPLE variances, per-movie logistic L2 (Newton route)
    with SIMPLE variances."""
    fe = glm_configs(weight=0.5, tron=True, variance="FULL", rate=0.5,
                     incremental_weight=iw)
    user = glm_configs(reg="ELASTIC_NET", weight=1.0, alpha=0.5,
                       variance="SIMPLE", incremental_weight=iw)
    movie = glm_configs(weight=0.5, variance="SIMPLE",
                        incremental_weight=iw)
    icpt = {"global": tt.D - 1, "userShard": tt.DU - 1,
            "movieShard": tt.DM - 1}
    out = {}
    for side, est, re_mod in (("jax", jax_est, jax_re),
                              ("pt", pt_est, pt_re)):
        cfgs = {
            "global": est.FixedEffectCoordinateConfiguration(
                "global", fe[side]),
            "per-user": est.RandomEffectCoordinateConfiguration(
                re_mod.RandomEffectDataConfiguration(**tt.USER), user[side]),
            "per-movie": est.RandomEffectCoordinateConfiguration(
                re_mod.RandomEffectDataConfiguration(**tt.MOVIE),
                movie[side]),
        }
        kw = dict(num_iterations=num_iterations, intercept_indices=icpt,
                  incremental_training=incremental)
        if side == "jax":
            out[side] = est.GameEstimator(
                JaxTask.LOGISTIC_REGRESSION, cfgs, mesh="off",
                non_finite_guard=True, **kw)
        else:
            out[side] = est.GameEstimator(
                TaskType.LOGISTIC_REGRESSION, cfgs, device=tt.CPU, **kw)
    return out


def assert_variances_close(pmodel, jmodel):
    for cid in ("global", "per-user", "per-movie"):
        pm, jm = pmodel[cid], jmodel[cid]
        if cid == "global":
            pv = pm.model.coefficients.variances.numpy()
            jv = np.asarray(jm.model.coefficients.variances)
        else:
            pv, jv = pm.variances.numpy(), np.asarray(jm.variances)
        np.testing.assert_array_equal(np.isinf(pv), np.isinf(jv))
        np.testing.assert_allclose(pv, jv, rtol=1e-6, atol=1e-8,
                                   err_msg=cid)


def test_fit_with_every_new_option_then_incremental_matches_reference(
        reference_draws):
    """``GameEstimator.fit`` with every option of the slice, float64,
    two iterations; then an incremental refit from each package's own
    model (its variances the prior): coefficients, variances and every
    update's per-entity iterations as the reference's."""
    arrays = tt.synth(seed=43)
    jdata, pdata = tt.both_datasets(arrays)
    est = every_option_estimators()
    jres = est["jax"].fit(jdata)[0]
    pres = est["pt"].fit(pdata)[0]
    tt.assert_models_close(pres.model, jres.model, 1e-6, 1e-8)
    tt.assert_history_matches(pres, jres)
    assert_variances_close(pres.model, jres.model)
    # The down-sampled fixed effect differs from a full-data fit.
    full = every_option_estimators(num_iterations=1)["pt"]
    full.coordinate_configs["global"] = dataclasses.replace(
        full.coordinate_configs["global"], optimization=dataclasses.replace(
            full.coordinate_configs["global"].optimization,
            down_sampling_rate=1.0))
    assert not np.allclose(
        full.fit(pdata)[0].model["global"].model.coefficients.means.numpy(),
        pres.model["global"].model.coefficients.means.numpy())

    inc = every_option_estimators(num_iterations=1, incremental=True,
                                  iw=2.0)
    jres2 = inc["jax"].fit(jdata, initial_model=jres.model)[0]
    pres2 = inc["pt"].fit(pdata, initial_model=pres.model)[0]
    tt.assert_models_close(pres2.model, jres2.model, 1e-6, 1e-8)
    tt.assert_history_matches(pres2, jres2)
    assert_variances_close(pres2.model, jres2.model)
