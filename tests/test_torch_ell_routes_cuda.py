"""The lazy ELL fallbacks, the ``ell`` Newton route and the dual-ELL
layout on the card (``cuda`` cases, no JAX): run with ``python -m pytest
--noconftest tests/test_torch_ell_routes_cuda.py -m cuda``.

- the ELL slabs a lazy bucket past the one-hot budget gathers on the
  card equal the CPU's, element for element;
- the float64 ``ell`` route on the card against the CPU: iterations and
  reasons equal, coefficients within rtol 1e-9 / atol 1e-11; two solves
  on the card bit-identical;
- a fused fit over an over-budget f32 coordinate replays with the
  densify and Newton kernels launched (device counters) and equals its
  second replay bit for bit;
- a dual-ELL shard's transposes launch the segment-sum kernel at the
  ``fixed_effect`` site and its matvec at ``dual_ell_tail``, within 1e-5
  of the CPU's float64 and bit-identical run to run.
"""

from __future__ import annotations

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
from photon_tpu_torch.ops import segment_reduce as sr
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import device_loop

needs_gpu = pytest.mark.skipif(not torch.cuda.is_available(),
                               reason="needs a GPU")
FOLD, N, MOVIES = 60, 6_000, 40


def l2(weight):
    return GLMOptimizationConfiguration(
        regularization=optim.RegularizationContext(
            optim.RegularizationType.L2),
        regularization_weight=weight)


def tag_data(device, dtype=torch.float32, seed=3):
    """Logistic rows with a per-movie tag shard of FOLD ids and the
    intercept FOLD, 2-8 tags a row."""
    rng = np.random.default_rng(seed)
    n = N
    p = 1.0 / (np.arange(MOVIES) + 3.0)
    movies = rng.choice(MOVIES, size=n, p=p / p.sum())
    counts = rng.integers(2, 9, size=n)
    idx = np.zeros((n, 9), np.int32)
    val = np.zeros((n, 9))
    live = np.arange(8)[None, :] < counts[:, None]
    idx[:, :8] = np.where(live, rng.integers(0, FOLD, size=(n, 8)), 0)
    val[:, :8] = np.where(live, rng.normal(size=(n, 8)), 0.0)
    idx[np.arange(n), counts] = FOLD
    val[np.arange(n), counts] = 1.0
    x = rng.normal(size=(n, 4))
    x[:, -1] = 1.0
    y = (rng.uniform(size=n) < 0.5).astype(float)
    arrays = dict(idx=idx, val=val, movies=movies, x=x, y=y)
    data = pt_game_data.make_game_dataset(
        y, {"global": pt_dataset.DenseFeatures(x),
            "tags": pt_dataset.SparseFeatures(idx, val, FOLD + 1)},
        id_tags={"movieId": movies}, dtype=dtype, device=device)
    return data, arrays


MOVIE = pt_re.RandomEffectDataConfiguration(
    "movieId", "tags", active_data_upper_bound=512, min_bucket_entities=4)


@pytest.fixture
def small_budget(monkeypatch):
    monkeypatch.setattr(pt_re, "ONE_HOT_ELEMENT_BUDGET", 1 << 12)


@pytest.mark.cuda
@needs_gpu
def test_lazy_ell_slabs_on_the_card_equal_the_cpu(small_budget):
    slabs = {}
    for dev in ("cpu", "cuda"):
        data, _ = tag_data(dev)
        ds = pt_re.build_random_effect_dataset(data, MOVIE,
                                               intercept_index=FOLD)
        assert ds.is_lazy
        slabs[dev] = [p.materialize(None) for p in ds.device_plans()]
    for c, g in zip(slabs["cpu"], slabs["cuda"], strict=True):
        assert c.x_indices is not None and g.x_indices is not None
        for f in ("x_indices", "x_values", "labels", "weights", "row_ids"):
            assert torch.equal(getattr(c, f), getattr(g, f).cpu()), f


@pytest.mark.cuda
@needs_gpu
def test_ell_route_f64_card_against_cpu(small_budget):
    out = {}
    for dev in ("cpu", "cuda"):
        data, _ = tag_data(dev, torch.float64)
        ds = pt_re.build_random_effect_dataset(data, MOVIE,
                                               intercept_index=FOLD)
        coord = pt_ra.RandomEffectCoordinate(
            ds, TaskType.LOGISTIC_REGRESSION, l2(1.0))
        pt_ra.route_solves.clear()
        model, stats = coord.train()
        assert pt_ra.route_solves == {"ell": len(ds.blocks)}
        out[dev] = (model.coefficients.cpu(), stats.iterations,
                    stats.reasons)
        if dev == "cuda":
            again, _ = coord.train()
            assert torch.equal(again.coefficients, model.coefficients)
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_array_equal(out["cuda"][2], out["cpu"][2])
    np.testing.assert_allclose(out["cuda"][0].numpy(), out["cpu"][0].numpy(),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.cuda
@needs_gpu
def test_fused_fit_replays_the_densify_and_newton_kernels(small_budget):
    device_loop.count_graph_launches("cuda")
    data, _ = tag_data("cuda")
    est = pt_est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"global": pt_est.FixedEffectCoordinateConfiguration(
            "global", l2(1e-3)),
         "per-movie": pt_est.RandomEffectCoordinateConfiguration(
             MOVIE, l2(1.0))},
        intercept_indices={"global": 3, "tags": FOLD}, num_iterations=2,
        device="cuda")
    est.fit(data)
    assert est._fused_cache is not None
    ff = next(iter(est._fused_cache.values()))
    assert ff.captured().segment.get("segment_reduce/densify", 0) > 0
    models = []
    for _ in range(2):
        device_loop.reset_graph_launches()
        models.append(est.fit(data)[0].model)
        assert device_loop.graph_launches("segment_sum") > 0
        assert device_loop.graph_launches("newton_step") > 0
    a, b = (m["per-movie"].coefficients for m in models)
    assert torch.equal(a, b)


@pytest.mark.cuda
@needs_gpu
def test_dual_ell_transposes_launch_the_kernel():
    rng = np.random.default_rng(5)
    n, d, k = 4_000, 300, 12
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k))
    val[rng.random((n, k)) < 0.4] = 0.0
    dual = pt_dataset.ell_to_dual_ell(idx, val, d, 4, device="cuda")
    ref = pt_dataset.ell_to_dual_ell(idx, val, d, 4, dtype=torch.float64,
                                     device="cpu")
    assert dual.tail_rows.shape[0] > 0
    g = torch.tensor(rng.normal(size=n), dtype=torch.float32, device="cuda")
    w = torch.tensor(rng.normal(size=d), dtype=torch.float32, device="cuda")
    sr.reset_counts()
    outs = [dual.rmatvec(g), dual.rmatvec(g), dual.rmatvec_sq(g),
            dual.matvec(w)]
    assert sr.launches_by_site.get("fixed_effect", 0) >= 3
    assert sr.launches_by_site.get("dual_ell_tail", 0) == 1
    assert torch.equal(outs[0], outs[1])
    want = [ref.rmatvec(g.double().cpu()), ref.rmatvec_sq(g.double().cpu()),
            ref.matvec(w.double().cpu())]
    for got, exp in zip((outs[0], outs[2], outs[3]), want):
        np.testing.assert_allclose(got.double().cpu().numpy(), exp.numpy(),
                                   rtol=1e-5, atol=1e-5)
