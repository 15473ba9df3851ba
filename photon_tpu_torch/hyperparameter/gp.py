"""Gaussian-process regression for Bayesian hyperparameter search (port
of ``photon_tpu/hyperparameter/gp.py``).

Counterpart of photon-lib
hyperparameter/estimators/GaussianProcessEstimator.scala:36 (slice-sampled
kernel hyperparameters, burn-in + posterior samples) and
GaussianProcessModel.scala:118 (GPML Algorithm 2.1 predictions via Cholesky).

Where it runs, by design: on the host CPU, in float64. Slice sampling
makes hundreds of sequential likelihood calls on a handful of
observations (n <= ~100), and a prediction is a few [n, n] solves; a
kernel launch or a copy to the card would cost more than the work. The
reference pins its GP to the host CPU for the same reason
(``photon_tpu/hyperparameter/gp.py`` ``_gp_device``). This is the GP's
place, not a fallback: every fit the tuner drives still trains on the
estimator's device.

- The posterior samples live in one ``[S, p]`` theta tensor; their
  Cholesky factors, solves and predictions are batched over S
  (``torch.linalg.cholesky_ex``, ``torch.cholesky_solve``,
  ``torch.linalg.solve_triangular``), as the reference ``vmap``s them.
- Observations are padded to a bucket size with a validity mask, as in
  the reference (``_pad_to_bucket``), so both packages solve systems of
  the same size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.hyperparameter import kernels
from photon_tpu_torch.hyperparameter.slice_sampler import SliceSampler


def _pad_to_bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class _Precomputed:
    chols: torch.Tensor  # [S, n, n]
    alphas: torch.Tensor  # [S, n]


def _precompute(name: str, thetas, x, y, valid) -> _Precomputed:
    """Each sample's Cholesky factor of K and alpha = K^-1 y."""
    k = kernels.gram(name, thetas, x, valid)
    chols = torch.linalg.cholesky_ex(k)[0]
    rhs = (y * valid).expand(*k.shape[:-1])[..., None]
    return _Precomputed(chols=chols,
                        alphas=torch.cholesky_solve(rhs, chols)[..., 0])


def _predict_all(name, thetas, pre: _Precomputed, x_train, valid, xq):
    """GPML Alg. 2.1 lines 4-6 for every theta sample
    (GaussianProcessModel.predictWithKernel :92-110): [S, m] means and
    variances."""
    ktrans = kernels.cross(name, thetas, x_train, xq) * valid[:, None]
    y_pred = torch.sum(ktrans * pre.alphas[..., None], dim=-2)
    v = torch.linalg.solve_triangular(pre.chols, ktrans, upper=False)
    amplitude, noise, _ = kernels.split_theta(thetas)
    kx_diag = amplitude + noise  # one-matrix apply: f(0)=1 plus noise
    y_var = torch.clamp(kx_diag[:, None] - torch.sum(v * v, dim=-2),
                        min=1e-12)
    return y_pred, y_var


@dataclasses.dataclass(frozen=True)
class GaussianProcessModel:
    """Posterior GP over the evaluation function (GaussianProcessModel.scala).

    ``thetas`` holds one kernel-hyperparameter sample per row; predictions
    average over samples (the reference's mean over its kernels list).
    """

    kernel_name: str
    x_train: torch.Tensor  # [n_pad, d]
    y_train: torch.Tensor  # [n_pad] (already mean-shifted by y_mean)
    y_mean: float
    valid: torch.Tensor  # [n_pad]
    thetas: torch.Tensor  # [S, p]
    _pre: _Precomputed

    @property
    def feature_dimension(self) -> int:
        return int(self.x_train.shape[1])

    def _predict(self, x):
        return _predict_all(self.kernel_name, self.thetas, self._pre,
                            self.x_train, self.valid, kernels.as_tensor(x))

    def predict(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(means, variances) at query points, averaged over theta samples
        (GaussianProcessModel.predict :58-66)."""
        means, variances = self._predict(x)
        return ((torch.mean(means, dim=0) + self.y_mean).numpy(),
                torch.mean(variances, dim=0).numpy())

    def predict_transformed(self, x: np.ndarray, transformation) -> np.ndarray:
        """Mean over samples of transformation(mean_s, var_s)
        (predictTransformed :72-84); the transformation sees *shifted* means,
        matching the reference (yPred + yMean happens per kernel there; the
        EI criterion receives the same shifted values either way because the
        best-eval it compares against is shifted identically)."""
        means, variances = self._predict(x)
        vals = transformation(means + self.y_mean, variances)
        return torch.mean(vals, dim=0).numpy()


class GaussianProcessEstimator:
    """Slice-sample kernel hyperparameters, return a posterior-averaged model.

    Reference: GaussianProcessEstimator.scala:36 — burn-in
    (monteCarloNumBurnInSamples=100) then monteCarloNumSamples=10 posterior
    draws; amplitude/noise sampled jointly (or amplitude alone with fixed
    noise when ``noisy_target`` is False), length scales dimension-wise
    (sampleNext :94-137).
    """

    def __init__(
        self,
        kernel: str = "matern52",
        normalize_labels: bool = False,
        noisy_target: bool = False,
        num_burn_in_samples: int = 100,
        num_samples: int = 10,
        seed: int = 0,
    ):
        if kernel not in kernels.KERNEL_NAMES:
            raise ValueError(f"unknown kernel {kernel!r}")
        self.kernel = kernel
        self.normalize_labels = normalize_labels
        self.noisy_target = noisy_target
        self.num_burn_in_samples = num_burn_in_samples
        self.num_samples = num_samples
        self.seed = seed

    def fit(self, x: np.ndarray, y: np.ndarray) -> GaussianProcessModel:
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        if x.ndim != 2 or x.shape[0] == 0:
            raise ValueError("empty input")
        if x.shape[0] != y.shape[0]:
            raise ValueError("x and y must have the same number of rows")
        y_mean = float(np.mean(y)) if self.normalize_labels else 0.0
        y = y - y_mean

        n, d = x.shape
        n_pad = _pad_to_bucket(n)
        x_pad = np.zeros((n_pad, d))
        x_pad[:n] = x
        y_pad = np.zeros(n_pad)
        y_pad[:n] = y
        valid = np.zeros(n_pad)
        valid[:n] = 1.0

        # The sampler's logp is numpy: step-out makes O(100) tiny
        # sequential likelihood calls per draw (see log_likelihood_np).
        def logp(theta_np: np.ndarray) -> float:
            return kernels.log_likelihood_np(self.kernel, theta_np, x, y)

        theta = kernels.initial_theta(y, d).numpy()
        sampler = SliceSampler(rng=np.random.default_rng(self.seed))
        for _ in range(self.num_burn_in_samples):
            theta = self._sample_next(theta, logp, sampler)
        samples = []
        for _ in range(self.num_samples):
            theta = self._sample_next(theta, logp, sampler)
            samples.append(theta.copy())

        xt, yt, vt = (kernels.as_tensor(a) for a in (x_pad, y_pad, valid))
        thetas = kernels.as_tensor(np.stack(samples))
        return GaussianProcessModel(
            kernel_name=self.kernel,
            x_train=xt,
            y_train=yt,
            y_mean=y_mean,
            valid=vt,
            thetas=thetas,
            _pre=_precompute(self.kernel, thetas, xt, yt, vt),
        )

    def _sample_next(self, theta, logp, sampler) -> np.ndarray:
        """One sweep: amplitude(+noise), then length scales
        (GaussianProcessEstimator.sampleNext :94-137)."""
        amp_noise = theta[:2]
        ls = theta[2:]

        if self.noisy_target:
            amp_noise = sampler.draw(
                amp_noise,
                lambda an: logp(np.concatenate([an, ls])),
            )
        else:
            amp = sampler.draw(
                amp_noise[:1],
                lambda a: logp(np.concatenate(
                    [a, [kernels.DEFAULT_NOISE], ls])),
            )
            amp_noise = np.concatenate([amp, [kernels.DEFAULT_NOISE]])

        ls = sampler.draw_dimension_wise(
            ls,
            lambda l: logp(np.concatenate([amp_noise, l])),
        )
        return np.concatenate([amp_noise, ls])
