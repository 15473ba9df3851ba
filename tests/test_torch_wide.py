"""Squared-loss GLMix on the materialized wide-subspace layout: the port
against the JAX package.

The same numpy data, made from a seed, goes through both packages: a
global dense shard, a narrow dense per-user shard (the lazy layout) and
a sparse per-movie tag shard whose subspaces are wider than 128 slots,
which both planners lay out materialized (ELL blocks, score table with
a COO tail). The JAX side runs its Pallas segment reduce in interpret
mode (``PHOTON_SEGMENT_KERNEL=force``, set by the tests that reach it),
so it takes the routes it takes on a TPU; the port takes the same
routes with the kernel's plain version on the CPU.

Tolerances:
- plan arrays, gram window bounds, score tables and tails: byte for
  byte;
- f32 solves and scores: rtol 1e-4 / atol 1e-5 (f32 sums in other
  orders, carried through a CG solve);
- float64 solves: rtol 1e-6 / atol 1e-6 on the gram route, whose pair
  products are f32 in both packages and summed in other orders (an f32
  rounding of each gram entry, ~1e-7, moves a coefficient by that much);
  rtol 1e-9 / atol 1e-11 where no f32 reduce is on the path;
- the scores of a trained coordinate: the coefficients' tolerance with
  ten times its atol, since a row adds up to ten coefficient-by-value
  products;
- logistic on a densified wide bucket, and the f32 fit: each package's
  f32 result against the float64 solution within ``FE_FIT_ATOL`` (fixed
  effect) and ``RE_FIT_ATOL`` (random effects), the bounds below, and
  their scores within ten times that per coordinate; trajectories
  (iterations and reasons) are compared in float64, where no decision
  sits on a rounding boundary.

An f32 solve stops where its objective F no longer resolves an
improvement. Its last step's true gain can be under an ulp of F, and
then whether the line search takes the step is decided by the rounding
of the sums, whose order differs between the packages and between
machines: each package's f32 loop may take one step more or fewer than
the other's. Either way the solve ends within F - F* <= 4 u F of the
optimum (u = 2**-24, the f32 unit round-off), so with curvature at
least h a coefficient is at most sqrt(2 * 4 u F / h) from the float64
solution. For the fixed effect (squared loss over N rows of N(0, 1)
features) F ~ 0.5 N s^2 with residual variance s^2 < 1, and h ~ N: at
most sqrt(4 u) ~ 4.9e-4, held at ``FE_FIT_ATOL`` = 5e-4. For a logistic
entity of R rows F ~ 0.6 R and h ~ 0.2 R + l2: sqrt(24 u) ~ 1.2e-3, held
at twice that, ``RE_FIT_ATOL`` = 2e-3, as ``chip_smoke.py`` holds a
trained fit's random effects. A squared-loss random effect is an exact
solve on residuals that carry the fixed effect's error, and is held at
the same ``RE_FIT_ATOL``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from photon_tpu_torch import optim
from photon_tpu_torch.algorithm import random_effect as pt_ra
from photon_tpu_torch.algorithm.problems import GLMOptimizationConfiguration
from photon_tpu_torch.data import dataset as pt_dataset
from photon_tpu_torch.data import game_data as pt_game_data
from photon_tpu_torch.data import random_effect as pt_re
from photon_tpu_torch.estimators import game_estimator as pt_est
from photon_tpu_torch.models import game as pt_game
from photon_tpu_torch.ops import newton_kernel as nk
from photon_tpu_torch.ops import segment_reduce as sr
from photon_tpu_torch.types import TaskType

N, D, DU = 3_000, 5, 4
N_USERS, N_MOVIES = 120, 40
POOL, TAGS = 150, 2_000  # tag pool per movie, tag vocabulary
K = 9  # 2-8 tags and the intercept per row
TAG_INTERCEPT = TAGS

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
       torch.float64: dict(rtol=1e-6, atol=1e-6)}
EXACT64 = dict(rtol=1e-9, atol=1e-11)
# An f32 solve against the float64 solution (module docstring).
FE_FIT_ATOL, RE_FIT_ATOL = 5e-4, 2e-3


def synth(seed=0, task="linear", n=N):
    """A small GLMix: global dense, per-user dense (last column the
    intercept) and per-movie tags: each movie owns a pool of POOL tag
    ids; each row carries 2-8 of its movie's tags with N(0, 1) values
    and the intercept id TAGS at 1. User and movie popularity are
    Zipf-like, so buckets and the reservoir caps bind."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D))
    x[:, -1] = 1.0
    xu = rng.normal(size=(n, DU))
    xu[:, -1] = 1.0
    pu = 1.0 / (np.arange(N_USERS) + 1.0)
    users = rng.choice(N_USERS, size=n, p=pu / pu.sum())
    p = 1.0 / (np.arange(N_MOVIES) + 3.0)
    movies = rng.choice(N_MOVIES, size=n, p=p / p.sum())
    pools = np.stack([rng.choice(TAGS, size=POOL, replace=False)
                      for _ in range(N_MOVIES)])
    counts = rng.integers(2, 9, size=n)
    pick = np.argsort(rng.random((n, POOL)), axis=1)[:, :K - 1]
    idx = np.zeros((n, K), np.int32)
    val = np.zeros((n, K))
    live = np.arange(K - 1)[None, :] < counts[:, None]
    idx[:, :K - 1] = np.where(live, pools[movies[:, None], pick], 0)
    val[:, :K - 1] = np.where(live, rng.normal(size=(n, K - 1)), 0.0)
    idx[np.arange(n), counts] = TAG_INTERCEPT
    val[np.arange(n), counts] = 1.0
    wm = rng.normal(size=(N_MOVIES, TAGS + 1)) * 0.2
    z = (x @ (rng.normal(size=D) * 0.3)
         + np.einsum("nd,nd->n", xu, rng.normal(size=(N_USERS, DU))[users]
                     * 0.3)
         + np.sum(val * wm[movies[:, None], idx], axis=1))
    if task == "linear":
        y = z + rng.normal(size=n) * 0.2
    else:
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(float)
    return dict(x=x, xu=xu, users=users, movies=movies, idx=idx, val=val,
                y=y)


def _jdtype(dtype):
    import jax.numpy as jnp

    return {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]


def both_datasets(arrays, dtype=torch.float64):
    from photon_tpu.data import dataset as jax_dataset
    from photon_tpu.data import game_data as jax_game_data

    def shards(mod):
        return {"global": mod.DenseFeatures(arrays["x"]),
                "userShard": mod.DenseFeatures(arrays["xu"]),
                "tagShard": mod.SparseFeatures(arrays["idx"], arrays["val"],
                                               TAGS + 1)}

    tags = {"userId": arrays["users"], "movieId": arrays["movies"]}
    jdata = jax_game_data.make_game_dataset(
        arrays["y"], shards(jax_dataset), id_tags=tags,
        dtype=_jdtype(dtype))
    pdata = pt_game_data.make_game_dataset(
        arrays["y"], shards(pt_dataset), id_tags=tags, dtype=dtype,
        device="cpu")
    return jdata, pdata


MOVIE = dict(random_effect_type="movieId", feature_shard_id="tagShard",
             active_data_upper_bound=128, score_table_width_cap=6,
             min_bucket_entities=4)
USER = dict(random_effect_type="userId", feature_shard_id="userShard",
            active_data_upper_bound=64, min_bucket_entities=4)
ICPT = {"global": D - 1, "userShard": DU - 1, "tagShard": TAG_INTERCEPT}


def both_re_datasets(jdata, pdata, cfg, lazy=None):
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
def forced(monkeypatch):
    """The reference runs its Pallas segment reduce (interpreted)."""
    import jax

    monkeypatch.setenv("PHOTON_SEGMENT_KERNEL", "force")
    jax.clear_caches()
    yield
    jax.clear_caches()


def assert_same_bytes(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


BLOCK_FIELDS = ("entity_codes", "x_indices", "x_values", "labels", "offsets",
                "weights", "row_ids", "proj", "penalty_mask", "valid_mask",
                "intercept_slots")
TABLE_FIELDS = ("score_codes", "score_indices", "score_values",
                "score_tail_rows", "score_tail_indices", "score_tail_values")


# ---------------------------------------------------------------------------
# the materialized planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["wide_capped", "wide_uncapped",
                                  "narrow_forced"])
def test_materialized_plan_is_byte_identical(case, dtype):
    jdata, pdata = both_datasets(synth(seed=1), dtype)
    cfg, lazy = MOVIE, None
    if case == "wide_uncapped":
        cfg = dict(MOVIE, score_table_width_cap=None)
    elif case == "narrow_forced":
        cfg, lazy = USER, False
    jds, pds = both_re_datasets(jdata, pdata, cfg, lazy)
    assert not jds.is_lazy and not pds.is_lazy
    assert len(jds.blocks) == len(pds.blocks) >= 2
    for jb, pb in zip(jds.blocks, pds.blocks):
        for f in BLOCK_FIELDS:
            assert_same_bytes(getattr(jb, f), getattr(pb, f).numpy(), f)
    assert jds.block_gram_mults == pds.block_gram_mults
    for f in TABLE_FIELDS:
        jv, pv = getattr(jds, f), getattr(pds, f)
        assert (jv is None) == (pv is None), f
        if pv is not None:
            assert_same_bytes(jv, pv.numpy(), f)
    assert jds.score_tail_mult == pds.score_tail_mult
    assert_same_bytes(jds.covered_np, pds.covered_np, "covered")
    assert_same_bytes(jds.proj_all, pds.proj_all, "proj_all")
    if case == "wide_capped":
        # The fixture exercises what it claims to: subspaces past 128,
        # gram bounds on every bucket, and a tail.
        assert pds.max_sub_dim > pt_re.DENSE_SUB_DIM_MAX
        assert all(m is not None for m in pds.block_gram_mults)
        assert pds.score_tail_mult >= 2
        assert pds.score_tail_rows.shape[0] > 0
    if case == "narrow_forced":
        assert all(m is None for m in pds.block_gram_mults)


def test_score_table_arrays_match_reference():
    from photon_tpu.data import random_effect as jax_re

    rng = np.random.default_rng(4)
    n, k = 50, 4
    idx = rng.integers(0, 30, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k))
    val[rng.random((n, k)) < 0.2] = 0.0
    codes = rng.integers(0, 5, size=n)
    projs = [np.sort(rng.choice(30, size=12, replace=False))
             for _ in range(5)]
    pt_table = pt_re._ProjectorTable.from_lists(projs, 30)
    jax_table = jax_re._ProjectorTable.from_lists(projs, 30)
    for cap in (None, 2, 4):
        got = pt_re._score_table_arrays(codes, idx, val, pt_table, cap)
        want = jax_re._score_table_arrays(codes, idx, val, jax_table, cap)
        assert_same_bytes(got[0], want[0], "si")
        assert_same_bytes(got[1], want[1], "sv")
        assert (got[2] is None) == (want[2] is None)
        if got[2] is not None:
            for a, b in zip(got[2], want[2]):
                assert_same_bytes(a, b, "tail")


def test_materialized_dataset_accessors():
    _, pdata = both_datasets(synth(seed=2))
    pds = pt_re.build_random_effect_dataset(
        pdata, pt_re.RandomEffectDataConfiguration(**MOVIE),
        intercept_index=TAG_INTERCEPT)
    assert not pds.is_lazy and pds.raw is None
    assert pds.device_blocks() is pds.blocks
    assert pds.device_plans() is pds.blocks
    assert all(not b.is_dense for b in pds.blocks)
    with pytest.raises(ValueError, match="lazy"):
        pds.covered_row_partition()


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_score_table_with_tail_matches_reference(dtype, forced):
    import jax.numpy as jnp

    from photon_tpu.models import game as jax_game

    jdata, pdata = both_datasets(synth(seed=3), dtype)
    jds, pds = both_re_datasets(jdata, pdata, MOVIE)
    w = np.random.default_rng(5).normal(size=(pds.num_entities,
                                              pds.max_sub_dim))
    want = np.asarray(jax_game.score_entity_table_with_tail(
        jnp.asarray(w, _jdtype(dtype)), jds.score_codes, jds.score_indices,
        jds.score_values,
        (jds.score_tail_rows, jds.score_tail_indices, jds.score_tail_values),
        tail_multiplicity=jds.score_tail_mult))
    sr.reset_counts()
    model = pt_game.RandomEffectModel(
        coefficients=torch.tensor(w, dtype=dtype), random_effect_type="movieId",
        feature_shard_id="tagShard", task=TaskType.LINEAR_REGRESSION,
        proj_all=pds.proj_all, entity_keys=pds.entity_keys)
    got = model.score_dataset(pds).numpy()
    assert got.dtype == np.dtype(str(dtype).split(".")[1])
    tol = TOL[torch.float32] if dtype == torch.float32 else EXACT64
    np.testing.assert_allclose(got, want, **tol)
    assert sr.launches == 0  # CPU tensors launch nothing
    # The table alone and the tail alone both matter on this fixture.
    no_tail = pt_game.score_entity_table(
        model.coefficients, pds.score_codes, pds.score_indices,
        pds.score_values).numpy()
    assert np.abs(no_tail - got).max() > 1e-3


def test_score_entity_table_one_hot_and_gather_agree():
    rng = np.random.default_rng(6)
    w = torch.tensor(rng.normal(size=(7, 20)))
    codes = torch.tensor(rng.integers(0, 7, size=50))
    idx = torch.tensor(rng.integers(0, 20, size=(50, 3)))
    val = torch.tensor(rng.normal(size=(50, 3)))
    one_hot = pt_game.score_entity_table(w, codes, idx, val)
    wide = torch.nn.functional.pad(w, (0, 120))  # S = 140: the gather
    gather = pt_game.score_entity_table(wide, codes, idx, val)
    np.testing.assert_allclose(one_hot.numpy(), gather.numpy(), rtol=0,
                               atol=1e-15)
    want = (val * w[codes[:, None], idx]).sum(-1)
    np.testing.assert_allclose(gather.numpy(), want.numpy(), rtol=1e-15)


# ---------------------------------------------------------------------------
# one coordinate
# ---------------------------------------------------------------------------


def l2(weight, tolerance=None):
    from photon_tpu import optim as jax_optim
    from photon_tpu.algorithm.problems import (
        GLMOptimizationConfiguration as JaxGLMConfig,
    )

    kw_j, kw_p = {}, {}
    if tolerance is not None:
        kw_j["optimizer"] = jax_optim.OptimizerConfig(tolerance=tolerance)
        kw_p["optimizer"] = optim.OptimizerConfig(tolerance=tolerance)
    return dict(
        jax=JaxGLMConfig(
            regularization=jax_optim.RegularizationContext(
                jax_optim.RegularizationType.L2),
            regularization_weight=weight, **kw_j),
        pt=GLMOptimizationConfiguration(
            regularization=optim.RegularizationContext(
                optim.RegularizationType.L2),
            regularization_weight=weight, **kw_p))


def residuals(n):
    """The residuals ``train_both`` trains a coordinate on."""
    return np.random.default_rng(1).normal(size=n) * 0.1


def train_both(jds, pds, task, dtype, weight=1.0, tolerance=None, *,
               same_scores=True):
    """One coordinate trained by each package on the same residuals;
    returns (port model, port stats, JAX model, JAX stats, routes).
    With ``same_scores`` the two models' scores are held to each other
    as well; a caller that holds each side to a float64 solution
    instead passes False."""
    import jax.numpy as jnp

    from photon_tpu.algorithm import random_effect as jax_ra
    from photon_tpu.types import TaskType as JaxTask

    cfg = l2(weight, tolerance)
    jc = jax_ra.RandomEffectCoordinate(jds, JaxTask[task.name], cfg["jax"])
    pc = pt_ra.RandomEffectCoordinate(pds, task, cfg["pt"])
    res = residuals(pds.num_rows)
    jmodel, jstats = jc.train(jnp.asarray(res, _jdtype(dtype)))
    pt_ra.route_solves.clear()
    sr.reset_counts()
    pmodel, pstats = pc.train(torch.tensor(res, dtype=dtype))
    routes = dict(pt_ra.route_solves)
    assert sr.launches == 0  # CPU tensors launch nothing
    if same_scores:
        tol = TOL[dtype]
        np.testing.assert_allclose(pc.score(pmodel).numpy(),
                                   np.asarray(jc.score(jmodel)),
                                   rtol=tol["rtol"], atol=10 * tol["atol"])
    return pmodel, pstats, jmodel, jstats, routes


def assert_direct_stats(pstats, jstats):
    jreasons, jiters = jstats._materialize()
    np.testing.assert_array_equal(pstats.reasons, jreasons)
    np.testing.assert_array_equal(pstats.iterations, jiters)
    assert set(pstats.convergence_reason_counts) == {"GRADIENT_CONVERGED"}
    assert pstats.iterations_max == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_wide_linear_coordinate_gram_route(dtype, forced):
    jdata, pdata = both_datasets(synth(seed=4), dtype)
    jds, pds = both_re_datasets(jdata, pdata, MOVIE)
    pmodel, pstats, jmodel, jstats, routes = train_both(
        jds, pds, TaskType.LINEAR_REGRESSION, dtype)
    assert routes == {"gram": len(pds.blocks)}
    np.testing.assert_allclose(pmodel.coefficients.numpy(),
                               np.asarray(jmodel.coefficients), **TOL[dtype])
    assert_direct_stats(pstats, jstats)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_wide_linear_coordinate_densify_route(dtype, forced, monkeypatch):
    """With no pair budget the gram route is refused in both packages:
    an f32 bucket is densified by the segment reduce; an f64 one, which
    the reduce does not take, is solved per entity from its ELL rows."""
    from photon_tpu.ops import segment_reduce as jax_sr

    monkeypatch.setattr(jax_sr, "GRAM_ELEMENT_BUDGET", 0)
    monkeypatch.setattr(sr, "GRAM_ELEMENT_BUDGET", 0)
    jdata, pdata = both_datasets(synth(seed=4), dtype)
    jds, pds = both_re_datasets(jdata, pdata, MOVIE)
    pmodel, pstats, jmodel, jstats, routes = train_both(
        jds, pds, TaskType.LINEAR_REGRESSION, dtype)
    route = "densify" if dtype == torch.float32 else "ell"
    assert routes == {route: len(pds.blocks)}
    tol = TOL[torch.float32] if dtype == torch.float32 else EXACT64
    np.testing.assert_allclose(pmodel.coefficients.numpy(),
                               np.asarray(jmodel.coefficients), **tol)
    assert_direct_stats(pstats, jstats)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("lazy", [None, False], ids=["lazy", "materialized"])
def test_narrow_linear_coordinate_direct_route(dtype, lazy):
    jdata, pdata = both_datasets(synth(seed=5), dtype)
    jds, pds = both_re_datasets(jdata, pdata, USER, lazy)
    assert pds.is_lazy == (lazy is None)
    pmodel, pstats, jmodel, jstats, routes = train_both(
        jds, pds, TaskType.LINEAR_REGRESSION, dtype)
    assert routes == {"dense" if lazy is None else "one_hot":
                      len(pds.blocks)}
    tol = TOL[torch.float32] if dtype == torch.float32 else EXACT64
    np.testing.assert_allclose(pmodel.coefficients.numpy(),
                               np.asarray(jmodel.coefficients), **tol)
    assert_direct_stats(pstats, jstats)


def newton_float64_both(pds, dtype_res, weight, tolerance):
    """Both packages' batch-minor Newton loops run directly in float64 on
    every bucket of ``pds``: the same inputs the f32 coordinate solves
    (the f32 slab, densified exactly, since a row names a slot once, and
    the f32 residuals), widened to float64. Returns, per package, the
    [E, Smax] coefficient table and each bucket's (iterations, reasons)
    over its real entities."""
    import jax.numpy as jnp

    from photon_tpu import optim as jax_optim
    from photon_tpu.algorithm import random_effect as jax_ra
    from photon_tpu.types import TaskType as JaxTask

    f64 = torch.float64
    res = torch.tensor(residuals(pds.num_rows), dtype=dtype_res).to(f64)
    shape = (pds.num_entities, pds.max_sub_dim)
    tables = {"pt": torch.zeros(shape, dtype=f64),
              "jax": torch.zeros(shape, dtype=f64)}
    stats = {"pt": [], "jax": []}
    for i, blk in enumerate(pds.blocks):
        s = blk.sub_dim
        x = sr.densify_ell_plain(blk.x_indices, blk.x_values.to(f64), s)
        offsets = blk.offsets.to(f64) + torch.where(
            blk.weights > 0, res[blk.row_ids.long()],
            torch.zeros((), dtype=f64))
        arrays = (x, blk.labels.to(f64), offsets, blk.weights.to(f64),
                  blk.penalty_mask.to(f64), blk.valid_mask.to(f64))
        w0 = torch.zeros((x.shape[0], s), dtype=f64)
        common = dict(sub_dim=s, l2_weight=weight, incremental_weight=1.0)
        got = {"pt": pt_ra._solve_newton_batched(
            *arrays, None, None, blk.intercept_slots, w0, None,
            task=TaskType.LOGISTIC_REGRESSION,
            opt_config=optim.OptimizerConfig(tolerance=tolerance),
            variance_computation=pt_ra.VarianceComputationType.NONE,
            **common)}
        out = jax_ra._solve_newton_batched(
            *(jnp.asarray(a.numpy()) for a in arrays), None, None,
            jnp.asarray(blk.intercept_slots.numpy()), jnp.asarray(w0.numpy()),
            None, task=JaxTask.LOGISTIC_REGRESSION,
            opt_config=jax_optim.OptimizerConfig(tolerance=tolerance),
            variance_computation=jax_ra.VarianceComputationType.NONE,
            **common)
        got["jax"] = tuple(torch.tensor(np.asarray(a)) for a in out)
        real = pds.real_entity_mask(i)
        for side, (w, v, it, reason) in got.items():
            tables[side], *_ = pt_ra._scatter_results(
                tables[side], None, blk.entity_codes, w, v, it, reason)
            stats[side].append((it.numpy()[real], reason.numpy()[real]))
    return tables, stats


def test_wide_logistic_coordinate_densify_then_newton(forced, monkeypatch):
    """Wide logistic buckets densified, then solved by the Newton loop.
    On the CPU the reference runs its batch-minor loop for every bucket
    (its kernel only on a TPU or when forced); the port's gate is held to
    that here, so the two loops are compared like for like. In float64,
    run directly on the same densified slabs, the two loops take the same
    trajectory (iterations and reasons) to the same coefficients. In f32
    through the coordinate, an entity whose last step gains less than an
    ulp of its objective can stop one step apart in the two packages (or
    on two machines), so each side is held to the float64 solution within
    ``RE_FIT_ATOL`` (module docstring). The Newton-step route at these
    widths is held by the next test and by the ``cuda`` tests of the
    kernel."""
    dtype = torch.float32
    weight, tolerance = 10.0, 1e-4
    jdata, pdata = both_datasets(synth(seed=6, task="logistic"), dtype)
    jds, pds = both_re_datasets(jdata, pdata, MOVIE)
    # Wide buckets within the reference's Newton gate and past it.
    shapes = [(b.x_indices.shape[1], b.sub_dim) for b in pds.blocks]
    assert any(s > nk.NARROW_SUB_DIM and r * s <= nk.MAX_RS
               for r, s in shapes)
    assert any(r * s > nk.MAX_RS for r, s in shapes)
    monkeypatch.setattr(nk, "kernel_supported", lambda *a, **k: False)
    plain_before = pt_ra.plain_route_solves
    pmodel, pstats, jmodel, jstats, routes = train_both(
        jds, pds, TaskType.LOGISTIC_REGRESSION, dtype, weight=weight,
        tolerance=tolerance, same_scores=False)
    assert routes == {"densify": len(pds.blocks)}
    assert pt_ra.plain_route_solves == plain_before + len(pds.blocks)
    assert pstats.iterations.max() >= 2

    tables, stats = newton_float64_both(pds, dtype, weight, tolerance)
    for (pit, preason), (jit, jreason) in zip(stats["pt"], stats["jax"],
                                              strict=True):
        np.testing.assert_array_equal(pit, jit)
        np.testing.assert_array_equal(preason, jreason)
    w64 = tables["pt"].numpy()
    np.testing.assert_allclose(w64, tables["jax"].numpy(), **EXACT64)
    for what, w in (("port", pmodel.coefficients.numpy()),
                    ("reference", np.asarray(jmodel.coefficients))):
        np.testing.assert_allclose(w, w64, rtol=0, atol=RE_FIT_ATOL,
                                   err_msg=what)
    # A row adds up to ten coefficient-by-value products.
    want = dataclasses.replace(pmodel, coefficients=tables["pt"].to(dtype))
    want = want.score_dataset(pds).numpy()
    for what, z in (("port", pmodel.score_dataset(pds).numpy()),
                    ("reference", np.asarray(jmodel.score_dataset(jds)))):
        np.testing.assert_allclose(z, want, rtol=0, atol=10 * RE_FIT_ATOL,
                                   err_msg=what)


def test_newton_gate_takes_a_wide_bucket_to_the_newton_step(monkeypatch):
    from photon_tpu.ops import newton_kernel as jax_nk
    from photon_tpu.types import TaskType as JaxTask

    lr = TaskType.LOGISTIC_REGRESSION
    monkeypatch.setenv("PHOTON_NEWTON_KERNEL", "force")
    for r, s in ((64, 160), (64, 256), (64, 257), (2, 8_192), (128, 128)):
        assert nk.kernel_supported(lr, torch.float32, r, s) == (
            jax_nk.kernel_supported(JaxTask.LOGISTIC_REGRESSION,
                                    np.float32, r, s)), (r, s)
    assert nk.kernel_supported(lr, torch.float32, 64, 160)

    steps = []
    step = nk.newton_step

    def counting_step(*a, **k):
        steps.append(tuple(a[0].shape))
        return step(*a, **k)

    monkeypatch.setattr(nk, "newton_step", counting_step)
    rng = np.random.default_rng(8)
    b, r, s = 5, 64, 160
    x = torch.tensor(rng.normal(size=(b, r, s)) * 0.1, dtype=torch.float32)
    y = torch.tensor(rng.random((b, r)) > 0.5, dtype=torch.float32)
    ones_bs = torch.ones((b, s))
    before = pt_ra.plain_route_solves
    w, _, it, code = pt_ra._solve_newton_batched(
        x, y, torch.zeros((b, r)), torch.ones((b, r)), ones_bs, ones_bs,
        None, None, torch.full((b,), -1), torch.zeros((b, s)), None,
        sub_dim=s, task=lr, opt_config=optim.OptimizerConfig(tolerance=1e-4),
        variance_computation=pt_ra.VarianceComputationType.NONE,
        l2_weight=1.0, incremental_weight=1.0)
    assert pt_ra.plain_route_solves == before
    assert steps and set(steps) == {(b, r, s)}
    assert bool(torch.isfinite(w).all()) and int(it.min()) >= 1


def test_unported_wide_routes_raise_with_their_names(forced):
    """The routes that raised here before the port had them run and
    match the reference in float64: the f64 logistic ELL bucket on the
    per-entity Newton route (``ell``: densify takes no f64), a direct
    solve with variances, and the quasi-Newton route of the smoothed
    hinge on the wide ELL buckets. Iterations and reasons equal,
    coefficients and variances within EXACT64."""
    from photon_tpu.algorithm import random_effect as jax_ra
    from photon_tpu.algorithm.problems import VarianceComputationType as JV
    from photon_tpu.types import TaskType as JaxTask

    jdata, pdata = both_datasets(synth(seed=7))
    jds, pds = both_re_datasets(jdata, pdata, MOVIE)
    cfg = l2(1.0)["pt"]
    pt_ra.route_solves.clear()
    pm, ps = pt_ra.RandomEffectCoordinate(
        pds, TaskType.LOGISTIC_REGRESSION, cfg).train()
    assert pt_ra.route_solves.get("ell", 0) == len(pds.blocks)
    jm, js = jax_ra.RandomEffectCoordinate(
        jds, JaxTask.LOGISTIC_REGRESSION, l2(1.0)["jax"]).train()
    reasons, iters = js._materialize()
    np.testing.assert_array_equal(ps.iterations, np.asarray(iters))
    np.testing.assert_array_equal(ps.reasons, np.asarray(reasons))
    np.testing.assert_allclose(pm.coefficients.numpy(),
                               np.asarray(jm.coefficients), **EXACT64)
    jcfg = l2(1.0)["jax"]
    for task, variance in (("LINEAR_REGRESSION", "SIMPLE"),
                           ("SMOOTHED_HINGE_LOSS_LINEAR_SVM", "NONE")):
        pc = dataclasses.replace(
            cfg, variance_computation=pt_ra.VarianceComputationType[variance])
        jc = dataclasses.replace(jcfg, variance_computation=JV[variance])
        before = pt_ra.quasi_newton_solves
        pm, ps = pt_ra.RandomEffectCoordinate(pds, TaskType[task],
                                              pc).train()
        jm, js = jax_ra.RandomEffectCoordinate(jds, JaxTask[task],
                                               jc).train()
        assert (pt_ra.quasi_newton_solves > before) == (
            task != "LINEAR_REGRESSION")
        reasons, iters = js._materialize()
        np.testing.assert_array_equal(ps.iterations, np.asarray(iters))
        np.testing.assert_array_equal(ps.reasons, np.asarray(reasons))
        np.testing.assert_allclose(pm.coefficients.numpy(),
                                   np.asarray(jm.coefficients), **EXACT64)
        if variance == "NONE":
            assert pm.variances is None
            continue
        pv, jv = pm.variances.numpy(), np.asarray(jm.variances)
        np.testing.assert_array_equal(np.isinf(pv), np.isinf(jv))
        assert np.isfinite(pv).any() and (pv > 0).any()
        np.testing.assert_allclose(pv, jv, rtol=1e-9)


# ---------------------------------------------------------------------------
# the whole fit
# ---------------------------------------------------------------------------


def both_estimators(dtype, num_iterations=2):
    from photon_tpu.data import random_effect as jax_re
    from photon_tpu.estimators import game_estimator as jax_est
    from photon_tpu.types import TaskType as JaxTask

    specs = {"global": ("fixed", "global", 1e-3),
             "per-user": ("re", USER, 1.0),
             "per-movie": ("re", MOVIE, 1.0)}
    cfgs = {"jax": {}, "pt": {}}
    for cid, (kind, spec, weight) in specs.items():
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
    # The non-finite guard keeps the JAX estimator on its unfused loop,
    # the loop the port mirrors.
    jest = jax_est.GameEstimator(
        JaxTask.LINEAR_REGRESSION, cfgs["jax"], num_iterations=num_iterations,
        mesh="off", intercept_indices=ICPT, non_finite_guard=True)
    pest = pt_est.GameEstimator(
        TaskType.LINEAR_REGRESSION, cfgs["pt"], num_iterations=num_iterations,
        intercept_indices=ICPT, device="cpu")
    return jest, pest


def total_scores(model, datasets, data, fe_shard="global"):
    z = np.asarray(model["global"].model.coefficients.compute_score(
        data.feature_shards[fe_shard]))
    for cid in ("per-user", "per-movie"):
        z = z + np.asarray(model[cid].score_dataset(datasets[cid]))
    return z


def fit_coefficients(result):
    """{coordinate: coefficient array} of a fit."""
    out = {}
    for cid in ("global", "per-user", "per-movie"):
        m = result[0].model[cid]
        out[cid] = np.asarray(m.model.coefficients.means if cid == "global"
                              else m.coefficients)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_linear_game_estimator_fit_matches_reference(dtype, forced):
    """In float64 the two fits take the same trajectory (the fixed
    effect's L-BFGS iterations and reasons, every direct solve's) to the
    same coefficients. In f32 the fixed effect's L-BFGS can stop one
    step apart in the two packages (or on two machines) where its last
    step gains less than an ulp of the objective, and the random effects
    solve on the residuals it leaves, so each side is held to the port's
    float64 fit on the same (f32-rounded) data within ``FE_FIT_ATOL`` and
    ``RE_FIT_ATOL`` (module docstring)."""
    arrays = synth(seed=9)
    jdata, pdata = both_datasets(arrays, dtype)
    jest, pest = both_estimators(dtype)
    jres = jest.fit(jdata)
    pt_ra.route_solves.clear()
    sr.reset_counts()
    pres = pest.fit(pdata)
    assert sr.launches == 0  # CPU tensors launch nothing
    pds, _ = pest.prepare(pdata)
    assert pds["per-user"].is_lazy and not pds["per-movie"].is_lazy
    n_movie = len(pds["per-movie"].blocks)
    n_user = len(pds["per-user"].blocks)
    assert pt_ra.route_solves == {"gram": 2 * n_movie, "dense": 2 * n_user}
    for ph, jh in zip(pres[0].descent.history, jres[0].descent.history,
                      strict=True):
        assert ph.coordinate_id == jh.coordinate_id
        if ph.coordinate_id != "global":
            assert_direct_stats(ph.diagnostics, jh.diagnostics)
        elif dtype == torch.float64:
            pd, jd = ph.diagnostics, jh.diagnostics
            assert int(pd.iterations) == int(jd.iterations)
            assert int(pd.convergence_reason) == int(jd.convergence_reason)
    jds = jest.prepare(jdata)[0]
    sides = {"port": (fit_coefficients(pres),
                      total_scores(pres[0].model, pds, pdata)),
             "reference": (fit_coefficients(jres),
                           total_scores(jres[0].model, jds, jdata))}
    if dtype == torch.float64:
        tol = TOL[dtype]
        (pw, pz), (jw, jz) = sides["port"], sides["reference"]
        for cid in pw:
            np.testing.assert_allclose(pw[cid], jw[cid], err_msg=cid, **tol)
        np.testing.assert_allclose(pz, jz, rtol=tol["rtol"],
                                   atol=10 * tol["atol"])
        return
    rounded = {k: (v.astype(np.float32).astype(np.float64)
                   if v.dtype == np.float64 else v) for k, v in arrays.items()}
    _, pdata64 = both_datasets(rounded, torch.float64)
    _, pest64 = both_estimators(torch.float64)
    res64 = pest64.fit(pdata64)
    w64 = fit_coefficients(res64)
    z64 = total_scores(res64[0].model, pest64.prepare(pdata64)[0],
                       pdata64)
    atol = {"global": FE_FIT_ATOL, "per-user": RE_FIT_ATOL,
            "per-movie": RE_FIT_ATOL}
    for what, (w, z) in sides.items():
        for cid in w:
            np.testing.assert_allclose(w[cid], w64[cid], rtol=0,
                                       atol=atol[cid], err_msg=f"{what} {cid}")
        # Ten coefficient-by-value products per row, per coordinate.
        np.testing.assert_allclose(z, z64, rtol=0,
                                   atol=10 * sum(atol.values()), err_msg=what)
