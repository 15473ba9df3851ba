"""Stationary covariance kernels for GP hyperparameter search (port of
``photon_tpu/hyperparameter/kernels.py``).

Counterpart of the reference's kernel classes (photon-lib
hyperparameter/estimators/kernels/StationaryKernel.scala, Matern52.scala:44,
RBF.scala:34). A kernel is a (name, theta) pair and every operation is a
function of ``theta = [amplitude, noise, length_scale...]``, in host torch
float64:

- ``gram(name, theta, x)``: K = amplitude * f(d2) + noise * I
  (StationaryKernel.apply one-matrix form, :61-70).
- ``cross(name, theta, x1, x2)``: amplitude * f(d2), no noise (:76-87).
- ``log_likelihood(name, theta, x, y, valid)``: GPML Algorithm 2.1 marginal
  likelihood via Cholesky, plus the reference's priors: lognormal on
  amplitude, horseshoe on noise, tophat [0, 2] on each length scale
  (StationaryKernel.logLikelihood :110-152).

``theta`` may carry leading batch dimensions ([S, p]: one row per
posterior sample); the outputs gain the same ones. Rows may be padding:
a ``valid`` mask turns padded rows into unit-diagonal, zero-coupling
entries, as the reference pads its observations to a bucket size.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Priors (StationaryKernel.scala): lognormal amplitude scale, horseshoe
# noise scale, tophat max for length scales.
AMPLITUDE_SCALE = 1.0
NOISE_SCALE = 0.1
LENGTH_SCALE_MAX = 2.0

DEFAULT_NOISE = 1e-4

KERNEL_NAMES = ("matern52", "rbf")

DTYPE = torch.float64


def as_tensor(a) -> torch.Tensor:
    """``a`` as a float64 tensor on the host CPU, where the GP runs."""
    return torch.as_tensor(a, dtype=DTYPE, device="cpu")


def _from_sq_dists(name: str, d2: torch.Tensor) -> torch.Tensor:
    """Covariance from squared scaled distances (fromPairwiseDistances)."""
    if name == "matern52":
        f = torch.sqrt(5.0 * d2)
        return (1.0 + f + (5.0 / 3.0) * d2) * torch.exp(-f)
    if name == "rbf":
        return torch.exp(-0.5 * d2)
    raise ValueError(f"unknown kernel {name!r}")


def split_theta(theta: torch.Tensor):
    """theta [..., p] -> (amplitude [...], noise [...], length_scale
    [..., d or 1])."""
    return theta[..., 0], theta[..., 1], theta[..., 2:]


def make_theta(amplitude, noise, length_scale) -> torch.Tensor:
    return torch.cat([as_tensor([amplitude, noise]),
                      as_tensor(np.atleast_1d(np.asarray(length_scale,
                                                         dtype=float)))])


def initial_theta(y, num_length_scales: int) -> torch.Tensor:
    """Matern52.getInitialKernel: amplitude = stddev(y), defaults elsewhere.

    The reference keeps a single shared length scale; one per
    hyperparameter dimension (ARD) is carried here, initialized to 1.0.
    """
    amp = float(torch.std(as_tensor(y), correction=0))
    amp = amp if amp > 0 else 1.0
    return make_theta(amp, DEFAULT_NOISE, np.ones(num_length_scales))


def _sq_dists(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances [..., n1, n2]
    (pairwiseDistances)."""
    d2 = (torch.sum(x1 * x1, dim=-1)[..., :, None]
          - 2.0 * x1 @ x2.transpose(-1, -2)
          + torch.sum(x2 * x2, dim=-1)[..., None, :])
    return torch.clamp(d2, min=0.0)


def _scaled(x: torch.Tensor, length_scale: torch.Tensor) -> torch.Tensor:
    # A length-1 scale broadcasts across all dims (expandDimensions).
    return x / length_scale[..., None, :]


def gram(name: str, theta, x, valid=None) -> torch.Tensor:
    """K(x, x) with noise on the diagonal; padded rows become identity."""
    theta, x = as_tensor(theta), as_tensor(x)
    amplitude, noise, ls = split_theta(theta)
    xs = _scaled(x, ls)
    eye = torch.eye(x.shape[0], dtype=DTYPE)
    k = (amplitude[..., None, None] * _from_sq_dists(name, _sq_dists(xs, xs))
         + noise[..., None, None] * eye)
    if valid is not None:
        v = as_tensor(valid)
        k = torch.where(v[:, None] * v[None, :] > 0, k, eye)
    return k


def cross(name: str, theta, x1, x2, valid2=None) -> torch.Tensor:
    """K(x1, x2) without noise; padded x2 rows contribute zero coupling."""
    theta = as_tensor(theta)
    amplitude, _, ls = split_theta(theta)
    k = amplitude[..., None, None] * _from_sq_dists(
        name, _sq_dists(_scaled(as_tensor(x1), ls),
                        _scaled(as_tensor(x2), ls)))
    if valid2 is not None:
        k = k * as_tensor(valid2)[None, :]
    return k


def log_likelihood(name: str, theta, x, y, valid) -> torch.Tensor:
    """GP marginal log likelihood + hyperprior terms; -inf out of bounds.

    Reference: StationaryKernel.logLikelihood :110-152 — bounds checks
    (nonneg params, tophat length-scale max), GPML 2.1 line 7 via Cholesky,
    lognormal amplitude prior, horseshoe noise prior; any numerical failure
    (non-PD K) yields -inf.
    """
    theta, y, valid = as_tensor(theta), as_tensor(y), as_tensor(valid)
    amplitude, noise, ls = split_theta(theta)
    n_real = torch.sum(valid)
    k = gram(name, theta, x, valid)
    chol, info = torch.linalg.cholesky_ex(k)
    ym = (y * valid).expand(*k.shape[:-1])
    alpha = torch.cholesky_solve(ym[..., None], chol)[..., 0]
    # Padded rows have unit diagonal: their log-det contribution is 0 and
    # alpha entries are y*0 = 0.
    lik = (-0.5 * torch.sum(ym * alpha, dim=-1)
           - torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1))
                       * valid, dim=-1)
           - 0.5 * n_real * math.log(2.0 * math.pi))
    # Lognormal amplitude prior + horseshoe noise prior.
    lik = lik - 0.5 * torch.log(torch.sqrt(amplitude / AMPLITUDE_SCALE)) ** 2
    lik = lik + torch.where(
        noise > 0, torch.log(torch.log1p((NOISE_SCALE / noise) ** 2)),
        torch.zeros_like(noise))
    in_bounds = ((amplitude > 0) & (noise >= 0) & torch.all(ls > 0, dim=-1)
                 & torch.all(ls <= LENGTH_SCALE_MAX, dim=-1) & (info == 0))
    return torch.where(in_bounds & torch.isfinite(lik), lik,
                       torch.full_like(lik, -math.inf))


def log_likelihood_np(name: str, theta, x, y) -> float:
    """Host-side scalar twin of ``log_likelihood`` for the slice sampler.

    Slice sampling's step-out walk evaluates the likelihood hundreds of
    times sequentially at tiny n, so it stays in numpy, as the
    reference's does (the same code, so both packages' samplers walk
    the same path).
    """
    theta = np.asarray(theta, dtype=float)
    amplitude, noise, ls = theta[0], theta[1], theta[2:]
    if (
        amplitude <= 0
        or noise < 0
        or (ls <= 0).any()
        or (ls > LENGTH_SCALE_MAX).any()
    ):
        return -np.inf
    xs = np.asarray(x, dtype=float) / ls
    d2 = (
        (xs * xs).sum(1)[:, None]
        - 2.0 * xs @ xs.T
        + (xs * xs).sum(1)[None, :]
    )
    d2 = np.maximum(d2, 0.0)
    if name == "matern52":
        f = np.sqrt(5.0 * d2)
        k = (1.0 + f + (5.0 / 3.0) * d2) * np.exp(-f)
    elif name == "rbf":
        k = np.exp(-0.5 * d2)
    else:
        raise ValueError(f"unknown kernel {name!r}")
    k = amplitude * k + noise * np.eye(xs.shape[0])
    try:
        chol = np.linalg.cholesky(k)
    except np.linalg.LinAlgError:
        return -np.inf
    y = np.asarray(y, dtype=float)
    alpha = np.linalg.solve(chol.T, np.linalg.solve(chol, y))
    lik = (
        -0.5 * float(y @ alpha)
        - float(np.log(np.diagonal(chol)).sum())
        - 0.5 * xs.shape[0] * np.log(2.0 * np.pi)
    )
    lik -= 0.5 * np.log(np.sqrt(amplitude / AMPLITUDE_SCALE)) ** 2
    if noise > 0:
        lik += np.log(np.log1p((NOISE_SCALE / noise) ** 2))
    return lik if np.isfinite(lik) else -np.inf
