"""The GLM objective: value, gradient, Hessian-vector product, Hessian
diagonal and full Hessian as matvecs (port of ``photon_tpu/ops/glm.py``).

    z     = X @ ew - es + offset
    value = sum(weight * l(z, y))
    grad  = f * (X^T c - shift * sum(c)),  c = weight * dl/dz
    Hv    = f * (X^T h - shift * sum(h)),  h = weight * d2l/dz2 * (X @ ev - es_v)

with (ew, es) the normalization's effective coefficients, so the raw
data is never transformed in memory.

On a row-sharded batch (``batch.mesh``: ``parallel.mesh.shard_batch``)
every row sum above is this rank's partial sum; the partial sums of one
evaluation cross the ranks in ONE collective (``Mesh.sum_parts``: an
all-gather added in rank order, so every rank holds the same bits),
where the reference's XLA inserts an all-reduce
(``photon_tpu/ops/glm.py:23``, :56).
"""

from __future__ import annotations

from typing import Callable

import torch

from photon_tpu_torch.data.dataset import DenseFeatures, GLMBatch
from photon_tpu_torch.ops.losses import PointwiseLoss
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.parallel.mesh import SITE_ROW_SUMS

ValueAndGrad = Callable[[torch.Tensor], tuple]
HessianVectorProduct = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _across_ranks(batch: GLMBatch, *parts: torch.Tensor) -> tuple:
    """The sums of ``parts`` over every rank of a row-sharded batch. A
    column-sharded batch (``parallel.mesh.FeatureShardedSparse``) keeps
    its rows whole and carries no mesh: its row sums stay local, and
    only its margins cross the ranks (in ``matvec``)."""
    if batch.mesh is None:
        return parts
    return batch.mesh.sum_parts(*parts, site=SITE_ROW_SUMS)


def margins(batch: GLMBatch, coef: torch.Tensor,
            norm: NormalizationContext) -> torch.Tensor:
    ew, es = norm.effective_coefficients(coef)
    return batch.features.matvec(ew) - es + batch.offsets


def make_value_and_grad(batch: GLMBatch, loss: PointwiseLoss,
                        norm: NormalizationContext | None = None
                        ) -> ValueAndGrad:
    """fun(w) -> (value, grad) over the batch in the transformed space."""
    norm = norm or NormalizationContext()

    def fun(w: torch.Tensor):
        z = margins(batch, w, norm)
        value = torch.sum(batch.weights * loss.loss(z, batch.labels))
        c = batch.weights * loss.dz(z, batch.labels)
        value, raw, total = _across_ranks(
            batch, value, batch.features.rmatvec(c), torch.sum(c))
        return value, norm.effective_gradient(raw, total)

    return fun


def make_hvp(batch: GLMBatch, loss: PointwiseLoss,
             norm: NormalizationContext | None = None
             ) -> HessianVectorProduct:
    """hvp(w, v) -> H(w) @ v, the Gauss-Newton Hessian of the loss."""
    norm = norm or NormalizationContext()

    def hvp(w: torch.Tensor, v: torch.Tensor):
        z = margins(batch, w, norm)
        ev, es_v = norm.effective_coefficients(v)
        zv = batch.features.matvec(ev) - es_v
        h = batch.weights * loss.dzz(z, batch.labels) * zv
        return norm.effective_gradient(*_across_ranks(
            batch, batch.features.rmatvec(h), torch.sum(h)))

    return hvp


def hessian_diagonal(batch: GLMBatch, loss: PointwiseLoss,
                     coef: torch.Tensor,
                     norm: NormalizationContext | None = None
                     ) -> torch.Tensor:
    """diag(H) in the transformed space:
    f^2 (sum c x^2 - 2 s sum c x + s^2 sum c), c = weight * dzz."""
    norm = norm or NormalizationContext()
    z = margins(batch, coef, norm)
    c = batch.weights * loss.dzz(z, batch.labels)
    if norm.is_identity:
        return _across_ranks(batch, batch.features.rmatvec_sq(c))[0]
    d_sq, d1, c_sum = _across_ranks(
        batch, batch.features.rmatvec_sq(c), batch.features.rmatvec(c),
        torch.sum(c))
    s = norm.shifts if norm.shifts is not None else torch.zeros_like(d_sq)
    f = norm.factors if norm.factors is not None else torch.ones_like(d_sq)
    return f * f * (d_sq - 2.0 * s * d1 + s * s * c_sum)


def hessian_matrix(batch: GLMBatch, loss: PointwiseLoss, coef: torch.Tensor,
                   norm: NormalizationContext | None = None
                   ) -> torch.Tensor:
    """The full [d, d] Hessian in the transformed space, for FULL
    variances (HessianMatrixAggregator): X^T diag(c) X on dense
    features, d mat-vec pairs on sparse ones; with normalization
    H = F (H_raw - s a^T - a s^T + (sum c) s s^T) F, a = X^T c."""
    norm = norm or NormalizationContext()
    z = margins(batch, coef, norm)
    c = batch.weights * loss.dzz(z, batch.labels)
    feats = batch.features
    if isinstance(feats, DenseFeatures):
        h_raw = feats.x.T @ (c[:, None] * feats.x)
    else:
        eye = torch.eye(batch.num_features, dtype=c.dtype, device=c.device)
        h_raw = torch.stack([feats.rmatvec(c * feats.matvec(e))
                             for e in eye]).T
    if norm.is_identity:
        return _across_ranks(batch, h_raw)[0]
    h_raw, a, c_sum = _across_ranks(batch, h_raw, feats.rmatvec(c),
                                    torch.sum(c))
    d = h_raw.shape[0]
    s = (norm.shifts if norm.shifts is not None
         else torch.zeros(d, dtype=c.dtype, device=c.device))
    f = (norm.factors if norm.factors is not None
         else torch.ones(d, dtype=c.dtype, device=c.device))
    h = (h_raw - torch.outer(s, a) - torch.outer(a, s)
         + c_sum * torch.outer(s, s))
    return f[:, None] * h * f[None, :]


def hessian_rows(batch: GLMBatch, loss: PointwiseLoss, coef: torch.Tensor,
                 norm: NormalizationContext | None = None) -> torch.Tensor:
    """This rank's row block ``H[lo:lo + d_local, :]`` of a
    column-sharded batch's (``parallel.mesh.FeatureShardedSparse``)
    Hessian, the rows of ``hessian_matrix`` it owns. The column route
    takes no normalization (the estimator keeps a normalized shard
    replicated)."""
    norm = norm or NormalizationContext()
    if not norm.is_identity:
        raise ValueError("a column-sharded Hessian takes no normalization")
    z = margins(batch, coef, norm)
    c = batch.weights * loss.dzz(z, batch.labels)
    return batch.features.hessian_rows(c)
