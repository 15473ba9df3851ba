"""The optimizer slice's routes and the deterministic evaluation on the
card, each against the same call on the CPU; plus the CPU check of the
card's blocked running sum. JAX-free, so the ``cuda`` tests run where
JAX is not installed (``pytest --noconftest -m cuda``).

Tolerances:
- the blocked running sum against ``torch.cumsum`` in float64: 1e-12
  relative to the total (the same sum, two association orders);
- the card's quasi-Newton route in float64 against the CPU's: each
  entity's iterations and reason equal, coefficients within 1e-9
  (1 + |w|) (the same decisions on values that differ by sum order);
  in float32 within ``RE_FIT_ATOL`` = 2e-3 of the CPU's float64 solve
  (``tests/test_torch_wide.py`` derives it for an f32 per-entity solve);
- the Newton kernel route with variances in f32 against the CPU's
  float64 plain route: coefficients within ``RE_FIT_ATOL``; SIMPLE
  variances 1 / (sum c x^2 + l2) within 1e-2 relative: the curvature
  c = w s (1 - s) moves by at most 0.1 |dz| for a margin error dz, and
  dz <= |x|_1 * 2e-3 ~ 8e-3 at these widths, so c (~0.2) moves by
  under 0.5% and the variance by as much, held at twice that;
- the grouped AUC on the card: two runs bit-identical, and within
  1e-5 of the CPU's float64 evaluation of the same f32 scores;
- the evaluators' segment sums on the card against the plain version:
  1e-6 (1 + sum |v|) per segment, the segment-sum kernel's parity bound
  (``chip_smoke.py``'s segment_parity).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_tpu_torch import optim
from photon_tpu_torch.algorithm import random_effect as ra
from photon_tpu_torch.algorithm.problems import (
    GLMOptimizationConfiguration,
    VarianceComputationType,
)
from photon_tpu_torch.data import dataset as ds_mod
from photon_tpu_torch.data import game_data
from photon_tpu_torch.data import random_effect as re_data
from photon_tpu_torch.evaluation import evaluators as ev
from photon_tpu_torch.ops import newton_kernel as nk
from photon_tpu_torch.ops import segment_reduce as sr
from photon_tpu_torch.types import TaskType

RE_FIT_ATOL = 2e-3
N, DU, N_USERS = 3_000, 5, 80


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 70_000, 2_100_000])
def test_blocked_running_sum_matches_cumsum(n):
    """The scan the card takes, on CPU tensors: the same running sums
    as ``torch.cumsum`` up to association."""
    x = torch.tensor(np.random.default_rng(n).random(n))
    got = ev.blocked_running_sum(x)
    want = torch.cumsum(x, 0)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12 * float(want[-1])
    assert torch.equal(ev.running_sum(x), want)


def glmix(dtype, device, seed=3, task="logistic"):
    """A per-user GLMix shard (last column the intercept) and labels."""
    rng = np.random.default_rng(seed)
    xu = rng.normal(size=(N, DU))
    xu[:, -1] = 1.0
    p = 1.0 / (np.arange(N_USERS) + 2.0)
    users = rng.choice(N_USERS, size=N, p=p / p.sum())
    z = np.einsum("nd,nd->n", xu, rng.normal(size=(N_USERS, DU))[users] * .4)
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-z))).astype(float)
    data = game_data.make_game_dataset(
        y, {"userShard": ds_mod.DenseFeatures(xu)},
        id_tags={"userId": users}, dtype=dtype, device=device)
    return re_data.build_random_effect_dataset(
        data, re_data.RandomEffectDataConfiguration(
            "userId", "userShard", active_data_upper_bound=64,
            active_data_lower_bound=3, min_bucket_entities=4),
        intercept_index=DU - 1)


def config(**kw):
    opt = kw.pop("optimizer", optim.OptimizerConfig())
    reg = kw.pop("reg", optim.RegularizationType.L2)
    return GLMOptimizationConfiguration(
        optimizer=opt, regularization=optim.RegularizationContext(
            reg, kw.pop("alpha", None)), **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def train(dtype, device, task, cfg, prior=None):
    coord = ra.RandomEffectCoordinate(glmix(dtype, device), task, cfg,
                                      prior=prior)
    model, stats = coord.train()
    return model, stats


ROUTES = {
    "elastic_net": (TaskType.LOGISTIC_REGRESSION,
                    dict(reg=optim.RegularizationType.ELASTIC_NET, alpha=0.5,
                         regularization_weight=2.0,
                         variance_computation=VarianceComputationType.FULL)),
    "tron_hinge": (TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
                   dict(optimizer=optim.OptimizerConfig.tron(),
                        regularization_weight=0.5)),
    "box": (TaskType.LOGISTIC_REGRESSION,
            dict(optimizer=optim.OptimizerConfig(box_constraints=(-.3, .3)),
                 regularization_weight=1.0,
                 variance_computation=VarianceComputationType.SIMPLE)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ROUTES))
def test_cuda_quasi_newton_route_matches_the_cpu(cuda_device, case):
    task, kw = ROUTES[case]
    cfg = config(**kw)
    want, wstats = train(torch.float64, "cpu", task, cfg)
    before = ra.quasi_newton_solves
    got, gstats = train(torch.float64, cuda_device, task, cfg)
    assert ra.quasi_newton_solves > before
    np.testing.assert_array_equal(gstats.iterations, wstats.iterations)
    np.testing.assert_array_equal(gstats.reasons, wstats.reasons)
    w = want.coefficients.numpy()
    np.testing.assert_allclose(got.coefficients.cpu().numpy(), w, rtol=1e-9,
                               atol=1e-9)
    f32, _ = train(torch.float32, cuda_device, task, cfg)
    np.testing.assert_allclose(f32.coefficients.double().cpu().numpy(), w,
                               rtol=0, atol=RE_FIT_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("variance", ["SIMPLE", "FULL"])
def test_cuda_newton_route_with_variances_and_prior(cuda_device, variance):
    """The logistic L2 route on the Newton kernel with variances, then a
    refit with that model as its prior, against the CPU's float64."""
    task = TaskType.LOGISTIC_REGRESSION
    cfg = config(regularization_weight=1.0,
                 variance_computation=VarianceComputationType[variance])
    want, _ = train(torch.float64, "cpu", task, cfg)
    nk.launches = 0
    got, _ = train(torch.float32, cuda_device, task, cfg)
    assert nk.launches > 0
    np.testing.assert_allclose(got.coefficients.double().cpu().numpy(),
                               want.coefficients.numpy(), rtol=0,
                               atol=RE_FIT_ATOL)
    np.testing.assert_allclose(got.variances.double().cpu().numpy(),
                               want.variances.numpy(), rtol=1e-2, atol=0)
    inc = config(regularization_weight=1.0, incremental_weight=2.0,
                 variance_computation=VarianceComputationType[variance])
    want2, _ = train(torch.float64, "cpu", task, inc, prior=want)
    nk.launches = 0
    prior = ra.RandomEffectModel(
        coefficients=got.coefficients, random_effect_type="userId",
        feature_shard_id="userShard", task=task, proj_all=got.proj_all,
        variances=got.variances, entity_keys=got.entity_keys)
    got2, _ = train(torch.float32, cuda_device, task, inc, prior=prior)
    assert nk.launches > 0
    np.testing.assert_allclose(got2.coefficients.double().cpu().numpy(),
                               want2.coefficients.numpy(), rtol=0,
                               atol=2 * RE_FIT_ATOL)


def grouped_inputs(device, n=200_000, groups=5_000, seed=11):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=n).astype(np.float32)
    y = (rng.random(n) < 0.3).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    g = rng.integers(0, groups, size=n)
    return [torch.from_numpy(a).to(device) for a in (s, y, w, g)] + [groups]


@pytest.mark.cuda
def test_cuda_grouped_auc_is_bit_identical_across_runs(cuda_device):
    s, y, w, g, groups = grouped_inputs(cuda_device)
    sr.reset_counts()
    runs = [ev.grouped_auc(s, y, g, groups, w) for _ in range(3)]
    assert sr.launches_by_site.get("evaluation", 0) > 0
    assert all(torch.equal(r, runs[0]) for r in runs)
    want = ev.grouped_auc(*(t.cpu().double() for t in (s, y)), g.cpu(),
                          groups, w.cpu().double())
    assert float(runs[0]) == pytest.approx(float(want), rel=1e-5)
    pr = [ev.auc_pr(s, y) for _ in range(2)]
    pf = [ev.peak_f1(s, y, w) for _ in range(2)]
    assert torch.equal(pr[0], pr[1]) and torch.equal(pf[0], pf[1])
    x = torch.rand(3_000_000, device=cuda_device)
    assert torch.equal(ev.running_sum(x), ev.running_sum(x))
    ref = torch.cumsum(x.double(), 0)
    assert float((ev.running_sum(x).double() - ref).abs().max()) <= (
        1e-5 * float(ref[-1]))


@pytest.mark.cuda
def test_cuda_evaluator_segment_sums_match_plain(cuda_device):
    s, y, w, g, groups = grouped_inputs(cuda_device)
    ids, order = torch.sort(g)
    vals = w[order]
    got = ev._segment_sum(vals, ids, groups)
    want = sr.sorted_segment_sum_plain(vals, ids.to(torch.int32), groups)
    bound = 1e-6 * (1.0 + sr.sorted_segment_sum_plain(
        vals.abs(), ids.to(torch.int32), groups))
    assert bool(((got - want).abs() <= bound).all())
