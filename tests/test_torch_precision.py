"""bf16 (mixed-precision) GLMix training in the port against the JAX
package's, on the CPU.

The reference's ``tests/test_precision.py`` cases on the port: the
policy helpers (``ops/precision.py``), the four families' bf16 fits on
that file's ``_workload`` data (3,000 rows, d 8, du 5, 40 users; the
reference with ``mesh="off"``), the score quantization, the static key
and the bucket merging of ``min_bucket_entities``.

The bounds:

- each package's bf16 fit lies within ``FAMILY_RTOL`` (the reference's
  table, ``tests/test_precision.py:145-150``) of its own f32 fit, fused
  and unfused, measured by that file's ``_rel_err``: the largest
  absolute difference over the f32 model's largest magnitude;
- the port's bf16 fit lies within ``PORT_RTOL`` of the reference's bf16
  fit, fused against fused and unfused against unfused (both packages'
  unfused loops through ``non_finite_guard=True``). Both round the same
  f32 slabs to bf16 the same way, but the margins read each coefficient
  rounded to bf16 (8 significant bits): where two correct solvers'
  f32 iterates differ in the last bits (their sums run in other
  orders; the f32 fits here already differ by up to 7.5e-4), a rounded
  coefficient can land one bf16 step apart, and the solve's fixed point
  moves by up to about that step, 2^-8 of the largest coefficient. Two
  such roundings (the margins' and the score carry's) give
  ``PORT_RTOL`` = 2 * 2^-8; the largest error measured on these data
  was 4.3e-3 (poisson, random effect, fused).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu import optim as jax_optim
from photon_tpu.algorithm.problems import (
    GLMOptimizationConfiguration as JaxGLMConfig,
)
from photon_tpu.data import dataset as jax_dataset
from photon_tpu.data import game_data as jax_game_data
from photon_tpu.data import random_effect as jax_re
from photon_tpu.estimators import game_estimator as jax_est
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch import optim
from photon_tpu_torch.algorithm import fused_fit as pt_ff
from photon_tpu_torch.algorithm.problems import GLMOptimizationConfiguration
from photon_tpu_torch.data import dataset as pt_dataset
from photon_tpu_torch.data import game_data as pt_game_data
from photon_tpu_torch.data import random_effect as pt_re
from photon_tpu_torch.estimators import game_estimator as pt_est
from photon_tpu_torch.ops import precision as px
from photon_tpu_torch.types import TaskType

FAMILY_RTOL = {
    "linear": 2e-2,
    "logistic": 2e-2,
    "poisson": 3e-2,
    "hinge": 2e-2,
}
PORT_RTOL = 2 * 2.0 ** -8
FAMILIES = {
    "linear": (TaskType.LINEAR_REGRESSION, JaxTask.LINEAR_REGRESSION),
    "logistic": (TaskType.LOGISTIC_REGRESSION, JaxTask.LOGISTIC_REGRESSION),
    "poisson": (TaskType.POISSON_REGRESSION, JaxTask.POISSON_REGRESSION),
    "hinge": (TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
              JaxTask.SMOOTHED_HINGE_LOSS_LINEAR_SVM),
}
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the policy helpers
# ---------------------------------------------------------------------------


def test_resolve_aliases():
    assert px.resolve(None) == "float32"
    assert px.resolve("f32") == "float32"
    assert px.resolve("bf16") == "bfloat16"
    assert px.resolve("BFLOAT16") == "bfloat16"
    with pytest.raises(ValueError, match="unknown precision"):
        px.resolve("float16")


def test_storage_and_cast():
    x = torch.ones(4)
    assert px.in_storage(x, "float32") is x
    assert px.in_storage(x, "bfloat16").dtype == torch.bfloat16
    ids = torch.ones(4, dtype=torch.int32)
    assert px.in_storage(ids, "bfloat16") is ids


def test_acc_einsum_accumulates_f32_on_bf16():
    """A bf16 contraction returns f32, equal to the f32 product of the
    bf16 values (a bf16 x bf16 product is exact in f32)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(3, 4096)).astype(np.float32)
                         ).to(torch.bfloat16)
    b = torch.from_numpy(rng.normal(size=4096).astype(np.float32)
                         ).to(torch.bfloat16)
    out = px.acc_einsum("rs,s->r", a, b)
    assert out.dtype == torch.float32
    want = a.double().numpy() @ b.double().numpy()
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-4)
    f32 = px.acc_einsum("rs,s->r", a.float(), b.float())
    assert f32.dtype == torch.float32


def test_acc_sum_bf16_accumulates_f32():
    """4,096 ones: a bf16 accumulator would stall at 256."""
    out = px.acc_sum(torch.ones(4096, dtype=torch.bfloat16))
    assert out.dtype == torch.float32
    assert float(out) == 4096.0
    assert px.acc_sum(torch.ones(8)).dtype == torch.float32


def test_like_storage():
    x = torch.ones(2)
    assert px.like_storage(x, torch.ones(2, dtype=torch.bfloat16)
                           ).dtype == torch.bfloat16
    assert px.like_storage(x, torch.ones(2)) is x


# ---------------------------------------------------------------------------
# the fits
# ---------------------------------------------------------------------------


def _arrays(family: str, seed: int = 0) -> dict:
    """The reference's ``_workload`` as numpy, drawn in its order."""
    rng = np.random.default_rng(seed)
    n, d, du, users = 3_000, 8, 5, 40
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, -1] = 1.0
    xu = rng.normal(size=(n, du)).astype(np.float32)
    xu[:, -1] = 1.0
    uid = rng.integers(0, users, n)
    w = 0.3 * rng.normal(size=d).astype(np.float32)
    wu = 0.3 * rng.normal(size=(users, du)).astype(np.float32)
    z = x @ w + np.einsum("nd,nd->n", xu, wu[uid])
    if family == "logistic":
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.float32)
    elif family == "poisson":
        y = rng.poisson(np.exp(np.clip(0.3 * z, -3, 3))).astype(np.float32)
    elif family == "hinge":
        y = (z > 0).astype(np.float32)
    else:
        y = (z + 0.2 * rng.normal(size=n)).astype(np.float32)
    return dict(x=x, xu=xu, uid=uid, y=y)


def _l2(opt, cls, weight):
    return cls(regularization=opt.RegularizationContext(
        opt.RegularizationType.L2), regularization_weight=weight)


def _pt_estimator(family: str, precision: str, *, guard: bool = False,
                  min_bucket: int = 0):
    return pt_est.GameEstimator(
        FAMILIES[family][0],
        {"global": pt_est.FixedEffectCoordinateConfiguration(
            "g", _l2(optim, GLMOptimizationConfiguration, 1e-2)),
         "per-user": pt_est.RandomEffectCoordinateConfiguration(
             pt_re.RandomEffectDataConfiguration(
                 "userId", "u", min_bucket_entities=min_bucket),
             _l2(optim, GLMOptimizationConfiguration, 1.0))},
        num_iterations=2, precision=precision, non_finite_guard=guard,
        device=CPU)


def _pt_data(family: str):
    a = _arrays(family)
    return pt_game_data.make_game_dataset(
        a["y"], {"g": pt_dataset.DenseFeatures(a["x"]),
                 "u": pt_dataset.DenseFeatures(a["xu"])},
        id_tags={"userId": a["uid"]}, device=CPU)


@functools.lru_cache(maxsize=None)
def _pt_fit(family: str, precision: str, fused: bool):
    """(global means, per-user table) of the port's fit, and whether it
    took the fused program."""
    est = _pt_estimator(family, precision, guard=not fused)
    model = est.fit(_pt_data(family))[0].model
    return (model["global"].model.coefficients.means.numpy(),
            model["per-user"].coefficients.numpy(),
            est._fused_cache is not None)


@functools.lru_cache(maxsize=None)
def _jax_fit(family: str, precision: str, fused: bool):
    a = _arrays(family)
    data = jax_game_data.make_game_dataset(
        a["y"], {"g": jax_dataset.DenseFeatures(a["x"]),
                 "u": jax_dataset.DenseFeatures(a["xu"])},
        id_tags={"userId": a["uid"]})
    est = jax_est.GameEstimator(
        FAMILIES[family][1],
        {"global": jax_est.FixedEffectCoordinateConfiguration(
            "g", _l2(jax_optim, JaxGLMConfig, 1e-2)),
         "per-user": jax_est.RandomEffectCoordinateConfiguration(
             jax_re.RandomEffectDataConfiguration("userId", "u"),
             _l2(jax_optim, JaxGLMConfig, 1.0))},
        num_iterations=2, mesh="off", precision=precision,
        non_finite_guard=not fused)
    model = est.fit(data)[0].model
    return (np.asarray(model.models["global"].model.coefficients.means),
            np.asarray(model.models["per-user"].coefficients),
            bool(est._fused_cache))


def _rel_err(a, b) -> float:
    """The reference's ``_rel_err``: the largest absolute difference over
    the largest magnitude of ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-9)
    return float(np.abs(a - b).max()) / scale


def _errs(got, want) -> tuple[float, float]:
    return _rel_err(got[0], want[0]), _rel_err(got[1], want[1])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_fit_matches_the_references(family, fused):
    """The port's bf16 fit against the reference's, fused against fused
    and unfused against unfused, within ``PORT_RTOL``."""
    pt = _pt_fit(family, "bfloat16", fused)
    jx = _jax_fit(family, "bfloat16", fused)
    assert pt[2] == fused and jx[2] == fused
    fe, re = _errs(pt, jx)
    assert fe <= PORT_RTOL and re <= PORT_RTOL, (family, fe, re)


@pytest.mark.parametrize("package", ["port", "reference"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_fit_within_family_tolerance_of_f32(family, package):
    """Each package's bf16 fit within ``FAMILY_RTOL`` of its own f32
    fit, fused and unfused; and not equal to it (the slabs and carries
    really were rounded)."""
    fit = _pt_fit if package == "port" else _jax_fit
    for fused in (True, False):
        fe, re = _errs(fit(family, "bfloat16", fused),
                       fit(family, "float32", fused))
        assert fe <= FAMILY_RTOL[family], (family, fused, fe)
        assert re <= FAMILY_RTOL[family], (family, fused, re)
        assert max(fe, re) > 0.0, (family, fused)


def test_bf16_fused_matches_its_unfused_loop():
    """The port's two bf16 loops agree as closely as the reference's
    two do (the fused fit's carries are bf16, the unfused loop's f32)."""
    for family in sorted(FAMILIES):
        pt = _errs(_pt_fit(family, "bfloat16", True),
                   _pt_fit(family, "bfloat16", False))
        jx = _errs(_jax_fit(family, "bfloat16", True),
                   _jax_fit(family, "bfloat16", False))
        assert max(pt) <= max(2.0 * max(jx), PORT_RTOL), (family, pt, jx)


def test_bf16_slabs_and_carries_are_stored_bf16():
    """A bf16 fused fit materializes bf16 slabs, half the f32 fit's
    slab bytes, and stores its score carries in bf16."""
    data = _pt_data("logistic")
    est16 = _pt_estimator("logistic", "bfloat16")
    est32 = _pt_estimator("logistic", "float32")
    est16.fit(data)
    est32.fit(data)
    f16 = next(iter(est16._fused_cache.values()))
    f32 = next(iter(est32._fused_cache.values()))
    assert f16.slab_nbytes() * 2 == f32.slab_nbytes() > 0
    for mat in est16._fused_mat_share["ebs"].values():
        assert all(eb.x_values.dtype == torch.bfloat16 for eb in mat["ebs"])
    datasets, _ = est16.prepare(data)
    coords = est16._build_coordinates(datasets, {}, {})
    out = f16._fit_fn(f16._operands(coords, None),
                      est16._fused_mat_share["ebs"],
                      f16._statics(coords, None))
    assert all(z.dtype == torch.bfloat16 for z in out[1])
    assert out[2].dtype == torch.float32


def test_score_quantization_is_idempotent_against_storage():
    """bf16(f32(bf16(z))) == bf16(z): a converged coordinate's
    ``total - read(store(z))`` is exactly 0; f32 returns ``z`` itself."""
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.normal(size=512).astype(np.float32))
    q = pt_ff.FusedFit._quantize_score
    f = type("F", (), {"precision": "bfloat16", "_quantize_score": q})()
    zq = f._quantize_score(z)
    np.testing.assert_array_equal(
        zq.numpy(), zq.to(torch.bfloat16).to(torch.float32).numpy())
    assert not torch.equal(zq, z)
    jq = np.asarray(jnp.asarray(z.numpy()).astype(jnp.bfloat16).astype(
        jnp.float32))
    np.testing.assert_array_equal(zq.numpy(), jq)
    f32 = type("F", (), {"precision": "float32", "_quantize_score": q})()
    assert f32._quantize_score(z) is z


def test_bf16_warm_start_reenters_the_same_program():
    """A bf16 warm start adds no fused cache key."""
    data = _pt_data("logistic")
    est = _pt_estimator("logistic", "bf16")
    model = est.fit(data)[0].model
    keys = set(est._fused_cache)
    est.fit(data, initial_model=model)
    assert set(est._fused_cache) == keys


def test_precision_is_a_static_key():
    data = _pt_data("linear")
    est = _pt_estimator("linear", "float32")
    datasets, _ = est.prepare(data)
    coords = est._build_coordinates(datasets, {}, {})
    k32 = pt_ff.fused_static_key(coords, est.update_sequence, 2, set(),
                                 "float32")
    k16 = pt_ff.fused_static_key(coords, est.update_sequence, 2, set(),
                                 "bfloat16")
    assert k32 != k16
    assert k16 == pt_ff.fused_static_key(coords, est.update_sequence, 2,
                                         set(), "bf16")


# ---------------------------------------------------------------------------
# min_bucket_entities
# ---------------------------------------------------------------------------

_CAPS = (16, 64, 256, 1024, 4096)


@pytest.mark.parametrize("floor", [0, 4, 5, 20])
@pytest.mark.parametrize("case", ["small", "random"])
def test_bucket_merges_match_the_references(case, floor):
    """``_assign_buckets`` merges undersized buckets upward exactly as
    the reference's does: the same caps, the same members."""
    if case == "small":
        counts = np.asarray([3, 10, 10, 100, 2000])
        active = np.ones(5, bool)
    else:
        rng = np.random.default_rng(0)
        counts = rng.integers(1, 5000, 200)
        active = rng.uniform(size=200) < 0.8
    got = pt_re._assign_buckets(counts, active, _CAPS, floor)
    want = jax_re._assign_buckets(counts, active, _CAPS,
                                  min_bucket_entities=floor)
    assert sorted(got) == sorted(want)
    for cap in want:
        np.testing.assert_array_equal(np.sort(got[cap]),
                                      np.sort(np.asarray(want[cap])))


def test_estimator_merging_keeps_the_optimum():
    """A floor above every bucket gives one slab and the same model: in
    float64, where merging only widens the zero-weight padding, to the
    last bits (in f32 an entity at a convergence boundary can stop one
    Newton iteration apart, 4.8e-4 on these data)."""
    a = _arrays("logistic")
    data = pt_game_data.make_game_dataset(
        a["y"], {"g": pt_dataset.DenseFeatures(a["x"]),
                 "u": pt_dataset.DenseFeatures(a["xu"])},
        id_tags={"userId": a["uid"]}, device=CPU, dtype=torch.float64)

    def fit(floor):
        est = _pt_estimator("logistic", "float32", min_bucket=floor)
        datasets, _ = est.prepare(data)
        return (est.fit(data)[0].model["per-user"].coefficients.numpy(),
                len(datasets["per-user"].blocks))

    base, n_base = fit(0)
    merged, n_merged = fit(10_000)
    assert n_merged == 1 < n_base
    np.testing.assert_allclose(merged, base, rtol=1e-12, atol=1e-14)
