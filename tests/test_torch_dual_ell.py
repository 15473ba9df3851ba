"""The dual-ELL layout (a bounded-width ELL slab plus a COO tail): the
port's ``DualEllFeatures`` against the JAX package's, on the cases of the
reference's ``tests/test_sparse_scale.py`` (its two feature-sharding
cases are ``tests/test_torch_column.py``'s, on real ranks;
``pad_batch``'s refusal is ``tests/test_torch_mesh.py``'s).

The same seeded numpy rows go through both packages in float64:
- the slab and tail ``ell_to_dual_ell`` makes: equal, element for
  element;
- matvecs against the plain ELL matrix and the reference: rtol 1e-12
  (sums of a few products in another order);
- a GLM fit through the dual layout against the plain ELL fit, and
  against the reference's: rtol 1e-6 / atol 1e-8 (the reference's
  bound, the fits' own tolerance);
- feature statistics: rtol 1e-10; the capped and uncapped score tables:
  rtol 1e-10; a random effect on a dual shard against the same data in
  plain ELL: rtol 1e-8 / atol 1e-10 (the reference's bounds);
- the whole estimator on a dual fixed-effect and random-effect shard
  against the reference's unfused fit: rtol 1e-6 / atol 1e-6
  (``test_torch_wide``'s float64 ``TOL``).
On the CPU every reduce runs the segment-sum kernel's plain version, so
nothing launches.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from photon_tpu_torch import optim
from photon_tpu_torch.algorithm.problems import (
    GLMOptimizationConfiguration,
    GLMOptimizationProblem,
)
from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_tpu_torch.data import random_effect as pt_re
from photon_tpu_torch.data.dataset import (
    DenseFeatures,
    DualEllFeatures,
    GLMBatch,
    SparseFeatures,
    ell_to_dual_ell,
    rows_to_ell,
)
from photon_tpu_torch.data.game_data import make_game_dataset
from photon_tpu_torch.data.validators import sanity_check_data
from photon_tpu_torch.estimators import game_estimator as pt_est
from photon_tpu_torch.models.game import RandomEffectModel
from photon_tpu_torch.ops import segment_reduce as sr
from photon_tpu_torch.stat import FeatureDataStatistics
from photon_tpu_torch.types import TaskType

CPU = "cpu"
F64 = torch.float64
L2 = optim.RegularizationContext(optim.RegularizationType.L2)


def random_ell(rng, n, d, k_max, heavy_rows=0, heavy_k=None):
    """An ELL slab whose first ``heavy_rows`` rows hold ``heavy_k``
    entries (the width hazard) and the rest 1..k_max."""
    heavy_k = heavy_k or k_max
    rows = []
    for i in range(n):
        k = heavy_k if i < heavy_rows else rng.integers(1, k_max + 1)
        idx = rng.choice(d, size=k, replace=False)
        rows.append([(int(j), float(rng.normal())) for j in idx])
    width = max(len(r) for r in rows)
    return rows_to_ell(rows, d, capacity=width, dtype=np.float64)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def jax_dual(idx, val, d, cap):
    from photon_tpu.data.dataset import ell_to_dual_ell as jax_e2d

    return jax_e2d(idx, val, d, width_cap=cap, dtype=np.float64)


def test_ell_to_dual_ell_matches_reference(rng):
    idx, val = random_ell(rng, 50, 30, k_max=4, heavy_rows=3, heavy_k=12)
    dual = ell_to_dual_ell(idx, val, 30, width_cap=4, dtype=F64,
                           device=CPU)
    ref = jax_dual(idx, val, 30, 4)
    for f in ("indices", "values", "tail_rows", "tail_indices",
              "tail_values"):
        got, want = getattr(dual, f).numpy(), np.asarray(getattr(ref, f))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert dual.d == ref.d == 30 and dual.num_rows == 50
    assert dual.tail_rows.shape[0] > 0


class TestDualEll:
    def test_matvecs_match_plain_ell(self, rng):
        import jax.numpy as jnp

        n, d = 60, 40
        idx, val = random_ell(rng, n, d, k_max=5, heavy_rows=3, heavy_k=25)
        plain = SparseFeatures(torch.from_numpy(idx), t64(val), d)
        dual = ell_to_dual_ell(idx, val, d, width_cap=5, dtype=F64,
                               device=CPU)
        ref = jax_dual(idx, val, d, 5)
        assert dual.values.shape[1] == 5
        assert dual.tail_values.shape[0] > 0
        w = rng.normal(size=d)
        g = rng.normal(size=n)
        sr.reset_counts()
        for name, arg in (("matvec", w), ("rmatvec", g),
                          ("rmatvec_sq", g)):
            got = getattr(dual, name)(t64(arg)).numpy()
            np.testing.assert_allclose(
                got, getattr(plain, name)(t64(arg)).numpy(), rtol=1e-12,
                err_msg=name)
            np.testing.assert_allclose(
                got, np.asarray(getattr(ref, name)(jnp.asarray(arg))),
                rtol=1e-12, err_msg=name)
        assert sr.launches == 0
        # The transpose reduces the slab and the tail through one plan,
        # kept with the features.
        plan = dual.transpose_plan()
        assert dual.transpose_plan() is plan
        assert plan.ids.shape[0] == idx.shape[0] * 5 + int(
            dual.tail_rows.shape[0])

    def test_fit_through_dual_ell(self, rng):
        """A GLM trains against DualEllFeatures as against ELL, and as
        the reference trains against its own."""
        import jax.numpy as jnp

        from photon_tpu import optim as jax_optim
        from photon_tpu.algorithm.problems import (
            GLMOptimizationConfiguration as JaxCfg,
        )
        from photon_tpu.algorithm.problems import (
            GLMOptimizationProblem as JaxProblem,
        )
        from photon_tpu.data.dataset import GLMBatch as JaxBatch
        from photon_tpu.types import TaskType as JaxTask

        n, d = 300, 20
        idx, val = random_ell(rng, n, d, k_max=4, heavy_rows=2, heavy_k=15)
        w_true = rng.normal(size=d)
        plain = SparseFeatures(torch.from_numpy(idx), t64(val), d)
        y = plain.matvec(t64(w_true)).numpy() + 0.01 * rng.normal(size=n)
        cfg = GLMOptimizationConfiguration(regularization=L2,
                                           regularization_weight=1e-3)
        prob = GLMOptimizationProblem(TaskType.LINEAR_REGRESSION, cfg)

        def fit(feats):
            batch = GLMBatch(feats, t64(y), torch.zeros(n, dtype=F64),
                             torch.ones(n, dtype=F64))
            return prob.run(batch).model.coefficients.means.numpy()

        w_plain = fit(plain)
        w_dual = fit(ell_to_dual_ell(idx, val, d, 4, dtype=F64,
                                     device=CPU))
        np.testing.assert_allclose(w_dual, w_plain, rtol=1e-6, atol=1e-8)
        jprob = JaxProblem(JaxTask.LINEAR_REGRESSION, JaxCfg(
            regularization=jax_optim.RegularizationContext(
                jax_optim.RegularizationType.L2),
            regularization_weight=1e-3))
        jw = np.asarray(jprob.run(JaxBatch(
            jax_dual(idx, val, d, 4), jnp.asarray(y), jnp.zeros(n),
            jnp.ones(n))).model.coefficients.means)
        np.testing.assert_allclose(w_dual, jw, rtol=1e-6, atol=1e-8)


class TestScoreTableWidthCap:
    def test_capped_table_scores_identically(self, rng):
        n, d, e = 120, 10, 6
        x = rng.normal(size=(n, d))
        game = make_game_dataset(
            rng.normal(size=n), {"shard": DenseFeatures(x)},
            id_tags={"userId": rng.integers(0, e, size=n)}, dtype=F64,
            device=CPU)
        full = pt_re.build_random_effect_dataset(
            game, pt_re.RandomEffectDataConfiguration("userId", "shard"),
            lazy=False)
        capped = pt_re.build_random_effect_dataset(
            game, pt_re.RandomEffectDataConfiguration(
                "userId", "shard", score_table_width_cap=3), lazy=False)
        assert capped.score_values.shape[1] == 3
        assert capped.score_tail_rows.shape[0] > 0
        w = rng.normal(size=(full.num_entities, full.max_sub_dim))
        w[full.proj_all < 0] = 0.0

        def model(ds):
            return RandomEffectModel(
                coefficients=t64(w[:, :ds.max_sub_dim]),
                random_effect_type="userId", feature_shard_id="shard",
                task=TaskType.LINEAR_REGRESSION, proj_all=ds.proj_all,
                entity_keys=ds.entity_keys)

        s_full = model(full).score_dataset(full).numpy()
        s_capped = model(capped).score_dataset(capped).numpy()
        np.testing.assert_allclose(s_capped, s_full, rtol=1e-10)
        lazy = pt_re.build_random_effect_dataset(
            game, pt_re.RandomEffectDataConfiguration("userId", "shard"))
        assert lazy.is_lazy
        np.testing.assert_allclose(model(lazy).score_dataset(lazy).numpy(),
                                   s_full, rtol=1e-10)


class TestDualEllConsumers:
    def test_feature_stats_include_tail(self, rng):
        from photon_tpu.stat import FeatureDataStatistics as JaxStats

        n, d = 40, 15
        idx, val = random_ell(rng, n, d, k_max=4, heavy_rows=2, heavy_k=10)
        plain = SparseFeatures(idx, val, d)
        dual = ell_to_dual_ell(idx, val, d, width_cap=4, dtype=F64,
                               device=CPU)
        w = rng.uniform(0.5, 2.0, size=n)
        s_plain = FeatureDataStatistics.from_features(plain, w)
        s_dual = FeatureDataStatistics.from_features(dual, w)
        s_ref = JaxStats.from_features(jax_dual(idx, val, d, 4), w)
        for field in ("mean", "variance", "min", "max", "num_nonzeros"):
            got = getattr(s_dual, field)
            np.testing.assert_allclose(got, getattr(s_plain, field),
                                       rtol=1e-10, err_msg=field)
            np.testing.assert_allclose(got, getattr(s_ref, field),
                                       rtol=1e-10, err_msg=field)

    def test_validators_see_tail_nan(self, rng):
        n, d = 10, 8
        idx, val = random_ell(rng, n, d, k_max=2, heavy_rows=1, heavy_k=6)
        val[0, 5] = np.nan  # lands in the tail after cap=2
        dual = ell_to_dual_ell(idx, val, d, width_cap=2, dtype=F64,
                               device=CPU)
        assert not torch.isfinite(dual.tail_values).all()
        assert torch.isfinite(dual.values).all()
        data = make_game_dataset(np.zeros(n), {"features": dual}, dtype=F64,
                                 device=CPU)
        with pytest.raises(ValueError, match="feature"):
            sanity_check_data(data, TaskType.LINEAR_REGRESSION, "FULL")
        clean = ell_to_dual_ell(idx, np.nan_to_num(val), d, width_cap=2,
                                dtype=F64, device=CPU)
        sanity_check_data(
            make_game_dataset(np.zeros(n), {"features": clean}, dtype=F64,
                              device=CPU),
            TaskType.LINEAR_REGRESSION, "FULL")

    def test_host_views_keep_the_slab_bounded(self, rng):
        n, d = 30, 12
        idx, val = random_ell(rng, n, d, k_max=3, heavy_rows=2, heavy_k=9)
        dual = ell_to_dual_ell(idx, val, d, width_cap=3, dtype=F64,
                               device=CPU)
        data = make_game_dataset(np.zeros(n), {"features": dual}, dtype=F64,
                                 device=CPU)
        si, sv, dd = data.host_shard_coo("features")
        assert si.shape == (n, 3) and dd == d
        tr, ti, tv = data.host_shard_tail("features")
        np.testing.assert_array_equal(tr, dual.tail_rows.numpy())
        assert isinstance(data.feature_shards["features"], DualEllFeatures)
        narrow = ell_to_dual_ell(idx, val, d, width_cap=9, dtype=F64,
                                 device=CPU)
        assert narrow.tail_rows.shape[0] == 0
        data = make_game_dataset(np.zeros(n), {"features": narrow},
                                 dtype=F64, device=CPU)
        assert data.host_shard_tail("features") is None
        with pytest.raises(KeyError):
            data.host_shard_tail("missing")


def test_validation_scorer_width_cap_parity(rng):
    """A capped remap scores as the uncapped one, unseen entities 0; on a
    dual shard too, against the same rows in plain ELL."""
    from photon_tpu_torch.transformers import random_effect_scorer

    n, d, e = 90, 8, 5
    x = rng.normal(size=(n, d))
    train = make_game_dataset(
        rng.normal(size=n), {"shard": DenseFeatures(x)},
        id_tags={"userId": rng.integers(0, e, size=n)}, dtype=F64,
        device=CPU)
    ds = pt_re.build_random_effect_dataset(
        train, pt_re.RandomEffectDataConfiguration("userId", "shard"))
    w = rng.normal(size=(ds.num_entities, ds.max_sub_dim))
    w[ds.proj_all < 0] = 0.0
    model = RandomEffectModel(
        coefficients=t64(w), random_effect_type="userId",
        feature_shard_id="shard", task=TaskType.LINEAR_REGRESSION,
        proj_all=ds.proj_all, entity_keys=ds.entity_keys)
    m = 60
    xv = rng.normal(size=(m, d))
    ids = {"userId": rng.integers(0, e + 3, size=m)}
    val = make_game_dataset(rng.normal(size=m), {"shard": DenseFeatures(xv)},
                            id_tags=ids, dtype=F64, device=CPU)
    kw = dict(re_type="userId", feature_shard_id="shard",
              entity_keys=ds.entity_keys, proj_all=ds.proj_all)
    s_full = random_effect_scorer(val, **kw)(model).numpy()
    s_capped = random_effect_scorer(val, width_cap=2, **kw)(model).numpy()
    np.testing.assert_allclose(s_capped, s_full, rtol=1e-10)
    full_idx = np.broadcast_to(np.arange(d, dtype=np.int32), (m, d))
    dual = ell_to_dual_ell(full_idx, xv, d, width_cap=3, dtype=F64,
                           device=CPU)
    val_dual = make_game_dataset(val.host_column("labels"),
                                 {"shard": dual}, id_tags=ids, dtype=F64,
                                 device=CPU)
    for cap in (None, 2):
        got = random_effect_scorer(val_dual, width_cap=cap, **kw)(model)
        np.testing.assert_allclose(got.numpy(), s_full, rtol=1e-10,
                                   atol=1e-12)


def dual_games(rng, n=120, d=30, e=6, cap=4):
    """(dual, sparse) GameDatasets of the same rows, their labels and
    entities, and the host ELL."""
    idx, val = random_ell(rng, n, d, k_max=4, heavy_rows=4, heavy_k=20)
    y = rng.normal(size=n)
    entities = rng.integers(0, e, size=n)
    dual = ell_to_dual_ell(idx, val, d, width_cap=cap, dtype=F64,
                           device=CPU)
    assert dual.tail_values.shape[0] > 0
    tags = {"userId": entities}
    game_dual = make_game_dataset(y, {"shard": dual}, id_tags=tags,
                                  dtype=F64, device=CPU)
    game_sparse = make_game_dataset(y, {"shard": SparseFeatures(idx, val, d)},
                                    id_tags=tags, dtype=F64, device=CPU)
    return game_dual, game_sparse, (idx, val, y, entities, d)


class TestDualEllRandomEffect:
    def test_dual_ell_shard_trains_and_scores_like_sparse(self, rng):
        """A random effect over a dual shard is materialized (slab and
        tail both in its blocks and projectors) and trains and scores
        as the same rows in plain ELL, and as the reference's."""
        import jax.numpy as jnp

        from photon_tpu.algorithm.problems import (
            GLMOptimizationConfiguration as JaxCfg,
        )
        from photon_tpu import optim as jax_optim
        from photon_tpu.algorithm import random_effect as jax_ra
        from photon_tpu.data import random_effect as jax_re
        from photon_tpu.data.game_data import make_game_dataset as jax_mgd
        from photon_tpu.types import TaskType as JaxTask

        game_dual, game_sparse, (idx, val, y, ents, d) = dual_games(rng)
        cfg = pt_re.RandomEffectDataConfiguration(
            "userId", "shard", score_table_width_cap=4)
        ds_dual = pt_re.build_random_effect_dataset(game_dual, cfg)
        assert not ds_dual.is_lazy
        ds_sparse = pt_re.build_random_effect_dataset(game_sparse, cfg,
                                                      lazy=False)
        np.testing.assert_array_equal(ds_dual.proj_all, ds_sparse.proj_all)
        with pytest.raises(TypeError, match="DualEllFeatures"):
            pt_re.build_random_effect_dataset(game_dual, cfg, lazy=True)
        conf = GLMOptimizationConfiguration(regularization=L2,
                                            regularization_weight=0.5)
        m_dual, _ = RandomEffectCoordinate(
            ds_dual, TaskType.LINEAR_REGRESSION, conf).train()
        m_sparse, _ = RandomEffectCoordinate(
            ds_sparse, TaskType.LINEAR_REGRESSION, conf).train()
        np.testing.assert_allclose(m_dual.coefficients.numpy(),
                                   m_sparse.coefficients.numpy(),
                                   rtol=1e-8, atol=1e-10)
        s_dual = m_dual.score_dataset(ds_dual).numpy()
        np.testing.assert_allclose(
            s_dual, m_sparse.score_dataset(ds_sparse).numpy(), rtol=1e-8,
            atol=1e-10)
        # The reference on its own dual shard: plan, model and scores.
        jgame = jax_mgd(y, {"shard": jax_dual(idx, val, d, 4)},
                        id_tags={"userId": ents}, dtype=jnp.float64)
        jds = jax_re.build_random_effect_dataset(
            jgame, jax_re.RandomEffectDataConfiguration(
                "userId", "shard", score_table_width_cap=4))
        np.testing.assert_array_equal(ds_dual.proj_all, jds.proj_all)
        for pb, jb in zip(ds_dual.blocks, jds.blocks, strict=True):
            for f in ("x_indices", "x_values", "row_ids"):
                np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                              np.asarray(getattr(jb, f)))
        for f in ("score_indices", "score_values", "score_tail_rows",
                  "score_tail_indices", "score_tail_values"):
            np.testing.assert_array_equal(getattr(ds_dual, f).numpy(),
                                          np.asarray(getattr(jds, f)))
        jm, _ = jax_ra.RandomEffectCoordinate(
            jds, JaxTask.LINEAR_REGRESSION, JaxCfg(
                regularization=jax_optim.RegularizationContext(
                    jax_optim.RegularizationType.L2),
                regularization_weight=0.5)).train()
        np.testing.assert_allclose(m_dual.coefficients.numpy(),
                                   np.asarray(jm.coefficients), rtol=1e-8,
                                   atol=1e-10)
        si, _, _ = game_dual.host_shard_coo("shard")
        assert si.shape[1] == 4

    def test_pearson_selection_sees_the_tail(self, rng):
        """``features_to_samples_ratio`` ranks the tail's entries too:
        the projectors equal the reference's on the same dual rows."""
        import jax.numpy as jnp

        from photon_tpu.data import random_effect as jax_re
        from photon_tpu.data.game_data import make_game_dataset as jax_mgd

        game_dual, _, (idx, val, y, ents, d) = dual_games(rng)
        spec = dict(random_effect_type="userId", feature_shard_id="shard",
                    features_to_samples_ratio=0.2)
        pds = pt_re.build_random_effect_dataset(
            game_dual, pt_re.RandomEffectDataConfiguration(**spec))
        jgame = jax_mgd(y, {"shard": jax_dual(idx, val, d, 4)},
                        id_tags={"userId": ents}, dtype=jnp.float64)
        jds = jax_re.build_random_effect_dataset(
            jgame, jax_re.RandomEffectDataConfiguration(**spec))
        np.testing.assert_array_equal(pds.proj_all, jds.proj_all)


def _dual_estimators(listener: bool):
    import test_torch_wide as tw
    from photon_tpu.data import random_effect as jax_re
    from photon_tpu.estimators import game_estimator as jax_est
    from photon_tpu.types import TaskType as JaxTask

    spec = dict(random_effect_type="userId", feature_shard_id="shard",
                score_table_width_cap=4)
    cfgs = {"jax": {}, "pt": {}}
    for side, est, re_mod in (("jax", jax_est, jax_re),
                              ("pt", pt_est, pt_re)):
        cfgs[side]["global"] = est.FixedEffectCoordinateConfiguration(
            "shard", tw.l2(1e-3)[side])
        cfgs[side]["per-user"] = est.RandomEffectCoordinateConfiguration(
            re_mod.RandomEffectDataConfiguration(**spec), tw.l2(0.5)[side])
    jest = jax_est.GameEstimator(
        JaxTask.LINEAR_REGRESSION, cfgs["jax"], num_iterations=2,
        mesh="off", non_finite_guard=True)
    pest = pt_est.GameEstimator(
        TaskType.LINEAR_REGRESSION, cfgs["pt"], num_iterations=2,
        device=CPU, listeners=[lambda e: None] if listener else None)
    return jest, pest


def test_game_estimator_on_dual_shards_matches_reference(rng):
    """A fixed effect and a random effect on one dual shard: the
    materialized random effect keeps the fit off the fused path, with
    the reference's reason; the fit matches the reference's."""
    import jax.numpy as jnp

    from photon_tpu.data.game_data import make_game_dataset as jax_mgd

    game_dual, _, (idx, val, y, ents, d) = dual_games(rng)
    jest, pest = _dual_estimators(listener=False)
    pres = pest.fit(game_dual)
    assert pest._fused_cache is None
    coords = pest._build_coordinates(
        pest.prepare(game_dual)[0],
        {c: cfg.optimization for c, cfg in pest.coordinate_configs.items()},
        {})
    from photon_tpu_torch.algorithm.fused_fit import (
        fuse_ineligibility_reasons,
    )

    reasons = fuse_ineligibility_reasons(coords)
    assert reasons == ["coordinate 'per-user': materialized score tables "
                       "ride the legacy scoring path"]
    jgame = jax_mgd(y, {"shard": jax_dual(idx, val, d, 4)},
                    id_tags={"userId": ents}, dtype=jnp.float64)
    jres = jest.fit(jgame)
    pg = pres[0].model["global"].model.coefficients.means.numpy()
    jg = np.asarray(jres[0].model["global"].model.coefficients.means)
    np.testing.assert_allclose(pg, jg, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        pres[0].model["per-user"].coefficients.numpy(),
        np.asarray(jres[0].model["per-user"].coefficients), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_dual_fixed_effect_rides_the_fused_fit(rng, fused):
    """A dual shard's fixed effect alone fits fused (its matvecs are
    sync-free) and equals the unfused fit and the plain ELL fit."""
    game_dual, game_sparse, _ = dual_games(rng)

    def est(listener):
        cfg = pt_est.FixedEffectCoordinateConfiguration(
            "shard", GLMOptimizationConfiguration(
                regularization=L2, regularization_weight=1e-3))
        return pt_est.GameEstimator(
            TaskType.LINEAR_REGRESSION, {"global": cfg}, device=CPU,
            listeners=[lambda e: None] if listener else None)

    e = est(listener=not fused)
    w = e.fit(game_dual)[0].model["global"].model.coefficients.means
    assert (e._fused_cache is not None) == fused
    w_sparse = est(listener=True).fit(game_sparse)[0].model[
        "global"].model.coefficients.means
    np.testing.assert_allclose(w.numpy(), w_sparse.numpy(), rtol=1e-6,
                               atol=1e-8)


def test_score_cli_scores_a_dual_dataset_through_the_transformer(rng):
    """``specs_from_dataset`` refuses a dual shard with ``TypeError``;
    ``cli.score``'s batch scorer then scores through ``GameTransformer``
    and gives the transformer's scores and evaluation."""
    from photon_tpu_torch.cli import score as score_cli
    from photon_tpu_torch.serve.programs import specs_from_dataset
    from photon_tpu_torch.transformers import GameTransformer

    game_dual, game_sparse, _ = dual_games(rng)
    jest, pest = _dual_estimators(listener=True)
    model = pest.fit(game_sparse)[0].model
    with pytest.raises(TypeError, match="GameTransformer"):
        specs_from_dataset(game_dual)
    report: dict = {}
    scores, evaluation = score_cli.score_game_dataset(
        model, game_dual, evaluators=["RMSE"], report=report)
    assert report["serve_kernel"] == "transformer"
    want, want_eval = GameTransformer(model).transform(game_sparse, ["RMSE"])
    np.testing.assert_allclose(scores, want.numpy(), rtol=1e-10, atol=1e-12)
    assert json.dumps(evaluation.evaluations) and (
        evaluation.evaluations["RMSE"] == pytest.approx(
            want_eval.evaluations["RMSE"], rel=1e-10))


def test_libsvm_with_vocab_dir_rejected(tmp_path, rng):
    """The reference's ``test_sparse_scale.py`` case on the port's
    ``cli.train``: a libsvm input with a ``feature_index_dir`` is
    refused (identity-indexed, one shard)."""
    from photon_tpu_torch.cli.train import main

    p = tmp_path / "d.txt"
    p.write_text("\n".join(
        f"{rng.integers(0, 2) * 2 - 1} 1:{rng.normal():.4f}"
        for _ in range(20)))
    (tmp_path / "vocab").mkdir()
    (tmp_path / "vocab" / "features.index.json").write_text('{"a": 0}')
    cfg = {
        "task": "LOGISTIC_REGRESSION",
        "input": {"format": "libsvm", "train_path": str(p),
                  "feature_index_dir": str(tmp_path / "vocab")},
        "coordinates": {"global": {"type": "fixed"}},
        "output_dir": str(tmp_path / "out"),
    }
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="avro input only"):
        main(["--config", str(cfg_path), "--device", "cpu"])
