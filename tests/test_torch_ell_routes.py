"""The lazy layout's ELL fallbacks and the per-entity Newton route of an
ELL bucket: the port against the JAX package.

A lazy bucket whose one-hot operand would pass ``ONE_HOT_ELEMENT_BUDGET``
elements, or whose subspace is wider than ``DENSE_SUB_DIM_MAX``, stays
ELL: a lookup-table gather for a dense shard, a binary search of the
sorted projector for a sparse one. A float64 logistic or Poisson ELL
bucket then takes the ``ell`` route (densify takes no float64): the
reference's per-entity Newton solve, which its default
(``PHOTON_SEGMENT_KERNEL=auto``) takes on the CPU. An f32 bucket is
densified by the segment-sum kernel (its plain version on the CPU) and
solved by the dense Newton route, as the reference does under
``PHOTON_SEGMENT_KERNEL=force``.

The data is ``test_torch_wide``'s, its tag shard folded onto 120 tag ids
and the intercept, so every per-movie subspace has at most 121 slots and
the planners choose the lazy layout themselves. The budget is set low
(``budget`` fixture) so that these small buckets are over it: on the
port's module, and on the reference's two modules that read it where a
test compares with its ELL fallback or routes (a monkeypatch of a
module constant changes no file).

Tolerances:
- the ELL slabs and every other block array: equal, element for element;
- float64 routes: iterations and reasons equal, coefficients within
  ``EXACT64`` (rtol 1e-9 / atol 1e-11), variances within rtol 1e-9;
- f32 densify-then-Newton: each package's coefficients within
  ``RE_FIT_ATOL`` (2e-3) of the float64 ``ell`` route on the same
  f32-rounded data, the fixed effect of a fit within ``FE_FIT_ATOL``
  (5e-4) (``test_torch_wide``'s module docstring derives both);
- a float64 fit of the whole estimator, fused and unfused, against the
  reference's unfused fit: rtol 1e-6 / atol 1e-6 (``test_torch_wide``'s
  float64 ``TOL``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_wide as tw
from photon_tpu_torch.algorithm import random_effect as pt_ra
from photon_tpu_torch.data import dataset as pt_dataset
from photon_tpu_torch.data import game_data as pt_game_data
from photon_tpu_torch.data import random_effect as pt_re
from photon_tpu_torch.estimators import game_estimator as pt_est
from photon_tpu_torch.models import game as pt_game
from photon_tpu_torch.ops import segment_reduce as sr
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.types import TaskType

FOLD = 120  # tag ids after folding; the intercept is FOLD
SMALL_BUDGET = 1 << 12
MOVIE = dict(random_effect_type="movieId", feature_shard_id="tagShard",
             active_data_upper_bound=128, min_bucket_entities=4)
ICPT = {"global": tw.D - 1, "userShard": tw.DU - 1, "tagShard": FOLD}
forced = tw.forced  # the reference runs its Pallas segment reduce


def folded(arrays):
    """``arrays`` with the tag ids folded onto FOLD ids (duplicates in
    a row sum) and the intercept moved to FOLD."""
    out = dict(arrays)
    idx = arrays["idx"]
    out["idx"] = np.where(idx == tw.TAG_INTERCEPT, FOLD,
                          idx % FOLD).astype(np.int32)
    return out


def both_datasets(arrays, dtype=torch.float64, dense_tags=False):
    """Both packages' GameDatasets over ``folded(arrays)``; with
    ``dense_tags`` the tag shard is the dense [n, FOLD + 1] matrix of the
    same entries."""
    from photon_tpu.data import dataset as jax_dataset
    from photon_tpu.data import game_data as jax_game_data

    a = folded(arrays)
    if dense_tags:
        x = np.zeros((a["idx"].shape[0], FOLD + 1))
        np.add.at(x, (np.arange(x.shape[0])[:, None], a["idx"]), a["val"])

    def shards(mod):
        tags = (mod.DenseFeatures(x) if dense_tags
                else mod.SparseFeatures(a["idx"], a["val"], FOLD + 1))
        return {"global": mod.DenseFeatures(a["x"]),
                "userShard": mod.DenseFeatures(a["xu"]), "tagShard": tags}

    tags = {"userId": a["users"], "movieId": a["movies"]}
    jdata = jax_game_data.make_game_dataset(
        a["y"], shards(jax_dataset), id_tags=tags, dtype=tw._jdtype(dtype))
    pdata = pt_game_data.make_game_dataset(
        a["y"], shards(pt_dataset), id_tags=tags, dtype=dtype, device="cpu")
    return jdata, pdata


def both_re_datasets(jdata, pdata, cfg=MOVIE, lazy=None):
    from photon_tpu.data import random_effect as jax_re

    icpt = ICPT[cfg["feature_shard_id"]]
    jds = jax_re.build_random_effect_dataset(
        jdata, jax_re.RandomEffectDataConfiguration(**cfg),
        intercept_index=icpt, lazy=lazy)
    pds = pt_re.build_random_effect_dataset(
        pdata, pt_re.RandomEffectDataConfiguration(**cfg),
        intercept_index=icpt, lazy=lazy)
    return jds, pds


@pytest.fixture
def budget(monkeypatch):
    """A one-hot budget these small buckets pass: the port's always;
    ``budget.reference()`` lowers the reference's too."""
    import jax

    from photon_tpu.algorithm import random_effect as jax_ra
    from photon_tpu.data import random_effect as jax_re

    monkeypatch.setattr(pt_re, "ONE_HOT_ELEMENT_BUDGET", SMALL_BUDGET)
    jax.clear_caches()

    class Budget:
        @staticmethod
        def reference():
            # The reference reads it in its planner's materialize and,
            # bound at import, in ``_solve_block``'s one-hot gate.
            for mod in (jax_re, jax_ra):
                monkeypatch.setattr(mod, "ONE_HOT_ELEMENT_BUDGET",
                                    SMALL_BUDGET)
            jax.clear_caches()

    yield Budget
    jax.clear_caches()


BLOCK_FIELDS = ("x_indices", "x_values", "labels", "offsets", "weights",
                "row_ids", "proj", "penalty_mask", "valid_mask",
                "intercept_slots", "entity_codes")


@pytest.mark.parametrize("case", ["sparse_over_budget", "dense_over_budget",
                                  "sparse_wide", "dense_wide"])
def test_lazy_ell_fallbacks_match_reference_materialize(case, budget):
    """Every lazy bucket the fallbacks take comes out ELL with the
    reference's indices and values, element for element: over the
    budget (both budgets lowered) and past DENSE_SUB_DIM_MAX slots
    (unfolded tags, ``lazy=True``, any budget)."""
    dense = case.startswith("dense")
    arrays = tw.synth(seed=11)
    if case.endswith("wide"):
        jdata, pdata = tw.both_datasets(arrays)
        if dense:
            # A dense shard wider than 128: the per-user shard widened.
            from photon_tpu.data import dataset as jax_dataset
            from photon_tpu.data import game_data as jax_game_data

            rng = np.random.default_rng(3)
            xw = rng.normal(size=(arrays["y"].shape[0], 140))
            tags = {"userId": arrays["users"]}
            jdata = jax_game_data.make_game_dataset(
                arrays["y"], {"w": jax_dataset.DenseFeatures(xw)},
                id_tags=tags, dtype=tw._jdtype(torch.float64))
            pdata = pt_game_data.make_game_dataset(
                arrays["y"], {"w": pt_dataset.DenseFeatures(xw)},
                id_tags=tags, dtype=torch.float64, device="cpu")
            cfg = dict(random_effect_type="userId", feature_shard_id="w",
                       min_bucket_entities=4)
        else:
            cfg = dict(MOVIE, feature_shard_id="tagShard")
        from photon_tpu.data import random_effect as jax_re

        jds = jax_re.build_random_effect_dataset(
            jdata, jax_re.RandomEffectDataConfiguration(**cfg), lazy=True)
        pds = pt_re.build_random_effect_dataset(
            pdata, pt_re.RandomEffectDataConfiguration(**cfg), lazy=True)
        assert pds.max_sub_dim > pt_re.DENSE_SUB_DIM_MAX
    else:
        budget.reference()
        jdata, pdata = both_datasets(arrays, dense_tags=dense)
        jds, pds = both_re_datasets(jdata, pdata)
        assert pds.max_sub_dim <= pt_re.DENSE_SUB_DIM_MAX
    assert pds.is_lazy and jds.packed_view is not None
    blocks = pds.device_blocks()
    assert len(blocks) >= 2
    for pb, jp in zip(blocks, jds.device_plans(), strict=True):
        jb = jp.materialize()
        assert isinstance(pb, pt_re.EntityBlocks) and not pb.is_dense
        assert jb.x_indices is not None
        k = pb.x_indices.shape[-1]
        if dense:
            assert k == pdata.feature_shards[
                pds.config.feature_shard_id].x.shape[1]
        for f in BLOCK_FIELDS:
            np.testing.assert_array_equal(
                getattr(pb, f).numpy(), np.asarray(getattr(jb, f)),
                err_msg=f)


def test_materialize_has_no_host_sync(budget):
    """The fallbacks are tensor ops only: no ``.item()``, ``nonzero`` or
    host copy (the fused fit materializes them before its capture and a
    solve past the slab budget inside it). Counted with
    ``torch.cuda``-free instrumentation: every tensor method that makes
    the CPU wait is patched to fail."""
    _, pdata = both_datasets(tw.synth(seed=12))
    pds = pt_re.build_random_effect_dataset(
        pdata, pt_re.RandomEffectDataConfiguration(**MOVIE),
        intercept_index=FOLD)
    plans = pds.device_plans()
    banned = ("item", "tolist", "nonzero", "numpy")
    saved = {name: getattr(torch.Tensor, name) for name in banned}

    def refuse(*_a, **_k):
        raise AssertionError("host sync in materialize")

    try:
        for name in banned:
            setattr(torch.Tensor, name, refuse)
        outs = [p.materialize(torch.zeros(pdata.num_samples,
                                          dtype=torch.float64))
                for p in plans]
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
    assert all(o.x_indices is not None for o in outs)


def _prior(pds, dtype, seed=21):
    rng = np.random.default_rng(seed)
    shape = (pds.num_entities, pds.max_sub_dim)
    valid = pds.proj_all >= 0
    w = np.where(valid, rng.normal(size=shape) * 0.1, 0.0)
    v = np.where(valid, rng.uniform(0.5, 2.0, size=shape), 0.0)
    return w, v


def _norm(dtype):
    """Factors and shifts on the folded tag shard (its intercept last,
    factor 1 and shift 0)."""
    import jax.numpy as jnp

    from photon_tpu.ops.normalization import NormalizationContext as JN

    rng = np.random.default_rng(9)
    fac = np.r_[rng.uniform(0.5, 2.0, size=FOLD), 1.0]
    sh = np.r_[rng.normal(size=FOLD) * 0.2, 0.0]
    return (JN(jnp.asarray(fac, tw._jdtype(dtype)),
               jnp.asarray(sh, tw._jdtype(dtype)), FOLD),
            NormalizationContext(torch.tensor(fac, dtype=dtype),
                                 torch.tensor(sh, dtype=dtype), FOLD))


def _train_both(jds, pds, task, variant, dtype=torch.float64):
    """(port model, port stats, reference model, reference stats) of one
    coordinate; ``variant`` "prior_shifts" adds normalization with
    shifts, an incremental prior and SIMPLE variances."""
    import jax.numpy as jnp

    from photon_tpu.algorithm import random_effect as jax_ra
    from photon_tpu.algorithm.problems import VarianceComputationType as JV
    from photon_tpu.models import game as jax_game
    from photon_tpu.ops.normalization import NormalizationContext as JN
    from photon_tpu.types import TaskType as JaxTask

    cfg = tw.l2(1.0)
    jc, pc = cfg["jax"], cfg["pt"]
    jn, pn, jp, pp = JN(), NormalizationContext(), None, None
    if variant == "prior_shifts":
        jc = dataclasses.replace(jc, variance_computation=JV.SIMPLE)
        pc = dataclasses.replace(
            pc, variance_computation=pt_ra.VarianceComputationType.SIMPLE)
        jn, pn = _norm(dtype)
        w, v = _prior(pds, dtype)
        common = dict(random_effect_type="movieId",
                      feature_shard_id="tagShard", proj_all=pds.proj_all,
                      entity_keys=pds.entity_keys)
        pp = pt_game.RandomEffectModel(
            coefficients=torch.tensor(w, dtype=dtype),
            variances=torch.tensor(v, dtype=dtype), task=TaskType[task],
            **common)
        jp = jax_game.RandomEffectModel(
            coefficients=jnp.asarray(w, tw._jdtype(dtype)),
            variances=jnp.asarray(v, tw._jdtype(dtype)),
            task=JaxTask[task], **common)
    res = tw.residuals(pds.num_rows)
    pt_ra.route_solves.clear()
    pm, ps = pt_ra.RandomEffectCoordinate(
        pds, TaskType[task], pc, pn, prior=pp).train(
            torch.tensor(res, dtype=dtype))
    routes = dict(pt_ra.route_solves)
    jm, js = jax_ra.RandomEffectCoordinate(
        jds, JaxTask[task], jc, jn, prior=jp).train(
            jnp.asarray(res, tw._jdtype(dtype)))
    return pm, ps, jm, js, routes


@pytest.mark.parametrize("variant", ["plain", "prior_shifts"])
@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION",
                                  "POISSON_REGRESSION"])
def test_ell_newton_route_matches_reference_f64(task, variant, budget):
    """Over-budget float64 buckets in both packages: the port's ``ell``
    route against the reference's per-entity Newton solve: iterations
    and reasons equal, coefficients within EXACT64, variances within
    rtol 1e-9."""
    budget.reference()
    jdata, pdata = both_datasets(tw.synth(seed=13, task="logistic"))
    jds, pds = both_re_datasets(jdata, pdata)
    assert pds.is_lazy
    pm, ps, jm, js, routes = _train_both(jds, pds, task, variant)
    assert routes == {"ell": len(pds.blocks)}
    reasons, iters = js._materialize()
    np.testing.assert_array_equal(ps.iterations, np.asarray(iters))
    np.testing.assert_array_equal(ps.reasons, np.asarray(reasons))
    assert ps.iterations.max() >= 2
    np.testing.assert_allclose(pm.coefficients.numpy(),
                               np.asarray(jm.coefficients), **tw.EXACT64)
    if variant == "plain":
        assert pm.variances is None
        return
    pv, jv = pm.variances.numpy(), np.asarray(jm.variances)
    np.testing.assert_array_equal(np.isinf(pv), np.isinf(jv))
    assert (pv > 0).any()
    np.testing.assert_allclose(pv, jv, rtol=1e-9)


def test_ell_route_is_deterministic(budget):
    """Two solves of the ``ell`` route are equal bit for bit (the
    densify scatters one ELL column at a time)."""
    _, pdata = both_datasets(tw.synth(seed=14, task="logistic"))
    pds = pt_re.build_random_effect_dataset(
        pdata, pt_re.RandomEffectDataConfiguration(**MOVIE),
        intercept_index=FOLD)
    coord = pt_ra.RandomEffectCoordinate(
        pds, TaskType.LOGISTIC_REGRESSION, tw.l2(1.0)["pt"])
    a, _ = coord.train()
    b, _ = coord.train()
    assert torch.equal(a.coefficients, b.coefficients)


def test_f32_densify_then_newton_matches_reference(budget, forced):
    """f32 over-budget buckets: the port densifies them through the
    segment-sum kernel's route (``densify``) and solves them by the
    dense Newton route, as the reference does with its kernel forced;
    each package's coefficients within RE_FIT_ATOL of the float64
    ``ell`` route on the same f32-rounded data."""
    budget.reference()
    arrays = tw.synth(seed=15, task="logistic")
    jdata, pdata = both_datasets(arrays, torch.float32)
    jds, pds = both_re_datasets(jdata, pdata)
    pm, _, jm, _, routes = _train_both(
        jds, pds, "LOGISTIC_REGRESSION", "plain", torch.float32)
    assert routes == {"densify": len(pds.blocks)}
    rounded = {k: (v.astype(np.float32).astype(np.float64)
                   if v.dtype == np.float64 else v)
               for k, v in arrays.items()}
    _, pdata64 = both_datasets(rounded)
    pds64 = pt_re.build_random_effect_dataset(
        pdata64, pt_re.RandomEffectDataConfiguration(**MOVIE),
        intercept_index=FOLD)
    coord = pt_ra.RandomEffectCoordinate(
        pds64, TaskType.LOGISTIC_REGRESSION, tw.l2(1.0)["pt"])
    res = tw.residuals(pds64.num_rows).astype(np.float32).astype(np.float64)
    pt_ra.route_solves.clear()
    w64 = coord.train(torch.tensor(res))[0].coefficients.numpy()
    assert pt_ra.route_solves == {"ell": len(pds64.blocks)}
    for side, w in (("port", pm.coefficients.numpy()),
                    ("reference", np.asarray(jm.coefficients))):
        np.testing.assert_allclose(w, w64, rtol=0, atol=tw.RE_FIT_ATOL,
                                   err_msg=side)


def _estimators(listener: bool):
    from photon_tpu.data import random_effect as jax_re
    from photon_tpu.estimators import game_estimator as jax_est
    from photon_tpu.types import TaskType as JaxTask

    specs = {"global": ("fixed", "global", 1e-3),
             "per-movie": ("re", MOVIE, 1.0)}
    cfgs = {"jax": {}, "pt": {}}
    for cid, (kind, spec, weight) in specs.items():
        opt = tw.l2(weight)
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
    jest = jax_est.GameEstimator(
        JaxTask.LOGISTIC_REGRESSION, cfgs["jax"], num_iterations=2,
        mesh="off", intercept_indices=ICPT, non_finite_guard=True)
    pest = pt_est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION, cfgs["pt"], num_iterations=2,
        intercept_indices=ICPT, device="cpu",
        listeners=[lambda e: None] if listener else None)
    return jest, pest


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_over_budget_lazy_fit_matches_reference(fused, budget):
    """A float64 logistic GameEstimator fit whose per-movie coordinate is
    lazy and over the budget (every bucket ELL, on the ``ell`` route):
    the port's fused and unfused fits against the reference's unfused
    fit with its budget lowered too."""
    budget.reference()
    jdata, pdata = both_datasets(tw.synth(seed=16, task="logistic"))
    jest, pest = _estimators(listener=not fused)
    jres = jest.fit(jdata)
    pt_ra.route_solves.clear()
    sr.reset_counts()
    pres = pest.fit(pdata)
    assert sr.launches == 0
    pds = pest.prepare(pdata)[0]["per-movie"]
    assert pds.is_lazy
    assert (pest._fused_cache is not None) == fused
    assert pt_ra.route_solves == {"ell": 2 * len(pds.blocks)}
    for cid in ("global", "per-movie"):
        pm, jm = pres[0].model[cid], jres[0].model[cid]
        pw = (pm.model.coefficients.means if cid == "global"
              else pm.coefficients).numpy()
        jw = np.asarray(jm.model.coefficients.means if cid == "global"
                        else jm.coefficients)
        np.testing.assert_allclose(pw, jw, err_msg=cid,
                                   **tw.TOL[torch.float64])


def test_warm_capture_predicts_the_over_budget_routes(monkeypatch):
    """The warm stage's skeleton of a dense lazy coordinate over the
    budget takes the same ELL layout and routes as the built dataset:
    its static key, which records each bucket's route, is the fit's."""
    from photon_tpu_torch.algorithm.fused_fit import fused_static_key

    monkeypatch.setattr(pt_re, "ONE_HOT_ELEMENT_BUDGET", 16)
    _, pdata = both_datasets(tw.synth(seed=18, task="logistic"))
    cfg = pt_est.RandomEffectCoordinateConfiguration(
        pt_re.RandomEffectDataConfiguration(**tw.USER), tw.l2(1.0)["pt"])
    est = pt_est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION, {"per-user": cfg}, device="cpu",
        intercept_indices=ICPT)
    warm = est._warm_capture(pdata)
    assert warm is not None
    datasets = est.prepare(pdata)[0]
    coords = est._build_coordinates(
        datasets, {"per-user": cfg.optimization}, {})
    key = fused_static_key(coords, est.update_sequence, est.num_iterations,
                           est.locked_coordinates, est.precision)
    assert warm["key"] == key
    routes = key[-1][-1]
    assert routes and set(routes) == {"ell"}
    pt_ra.route_solves.clear()
    est.fit(pdata)
    assert est._fused_cache is not None
    assert pt_ra.route_solves == {"ell": len(routes)}
