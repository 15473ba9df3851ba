"""RandomEffectCoordinate: batched per-entity GLM solves (port of
``photon_tpu/algorithm/random_effect.py``).

Each size bucket of entities is solved as one batch
(RandomEffectCoordinate.scala:243-292 runs one local solve per entity).
A well-posed squared-loss bucket (L2 > 0, no L1, no box) is solved
exactly from its normal equations, by conjugate gradients with one
refinement pass: from the ELL blocks through the segment-sum kernel (the
gram route, ``_solve_direct_gram``) where the planner's window bounds
allow, else from a dense slab (``_solve_direct_batched``). A wide ELL
bucket is densified for it by the same kernel (``densify_ell_blocks``).
For a well-posed logistic or Poisson bucket the bucket runs damped
Newton/IRLS (``_solve_newton_batched``) on a dense slab (a wide ELL
bucket densified by the segment-sum kernel first), with per-entity
convergence through the reference's cascade:

- the Newton-step route, taken when ``newton_kernel.kernel_supported``
  holds (f32; R * S <= 16384, or up to S = 128 slots any bucket whose
  slab fits in the kernel's shared memory): one ``newton_step`` per
  iteration, the CUDA kernel on the card;
- the plain route otherwise (f64, a bf16 slab, larger buckets): the same
  iteration as PyTorch tensor code with an S-step CG per entity
  (``_spd_solve_cg_sb``).

Under ``precision="bfloat16"`` (``ops/precision.py``) every slab is stored
bf16 and read bf16 with f32 accumulators; the solver state stays in the
labels' dtype.

Each iteration of either loop is a ``utils.device_loop`` loop: eagerly
it makes one host sync, to test whether any entity is still running
(``host_syncs`` counts them); in the fused fit's CUDA graph it is a
WHILE node and makes none.

Every other bucket (an L1 or elastic-net part, L2 = 0, box constraints,
the smoothed hinge, a prior at ``incremental_weight`` 0) takes the
per-entity quasi-Newton route, ``_solve_quasi_newton_batched``: the
configured L-BFGS, L-BFGS-B, OWL-QN or TRON over the whole bucket at
once (``optim/batched.py``, each entity's iterations and reason those of
its solo solve, as the reference's ``jax.vmap`` gives), on the
effective-coefficient objective with the masked L2 or the Gaussian
prior. An ELL bucket is densified for it (``segment_reduce.densify_ell``).

A well-posed logistic or Poisson ELL bucket that densify does not take
(float64, or more than 1,024 slots) takes the ``ell`` route,
``_solve_newton_ell``: the reference's per-entity Newton solve
(``_solve_one_entity_newton``, vmapped) batched over the bucket, each
entity's transformed design densified column by column (no float
atomics), the same damped steps with one-pass Armijo trials, each
direction by unrefined S-step CG, and each entity's variances from its
own design.

Coefficients are solved in the transformed (normalized) space and
reported in the original one; the per-entity intercept slot carries the
shift mass. SIMPLE and FULL variances come at the optimum on every
route but the gram route, which ``block_route`` refuses when they are
asked for: padded slots report 0 and valid slots with no curvature inf.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from photon_tpu_torch import optim
from photon_tpu_torch.algorithm.problems import (
    GLMOptimizationConfiguration,
    VarianceComputationType,
    cholesky_inverse_diagonal,
)
from photon_tpu_torch.data import random_effect as re_data
from photon_tpu_torch.data.random_effect import (
    DENSE_SUB_DIM_MAX,
    BlockPlan,
    RandomEffectDataset,
)
from photon_tpu_torch.models.game import RandomEffectModel
from photon_tpu_torch.ops import losses as losses_mod
from photon_tpu_torch.ops import newton_kernel as nk
from photon_tpu_torch.ops import precision as precision_mod
from photon_tpu_torch.ops import segment_reduce
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.optim import batched, owlqn, tron
from photon_tpu_torch.parallel.mesh import SITE_BUCKET_GATHER
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import device_loop

_NEWTON_LINE_SEARCH_HALVINGS = 15

# Host syncs of the Newton loops (one per iteration of either route).
host_syncs = 0
# Bucket solves that took the plain route.
plain_route_solves = 0
# Bucket solves on the per-entity quasi-Newton route.
quasi_newton_solves = 0
# Bucket solves by how the bucket's design reached its solver (see
# ``block_route``).
route_solves: dict = {}


class RandomEffectTrainingStats:
    """Per-entity convergence reasons and iteration counts
    (RandomEffectOptimizationTracker.scala:89), fetched from the device
    on first read only, so training never waits for them."""

    def __init__(self, reasons, iterations, keep_masks):
        self._device = (reasons, iterations, keep_masks)
        self._host = None
        self._thunk = None

    @classmethod
    def from_thunk(cls, thunk):
        """Stats whose (reasons, iterations) host arrays ``thunk()``
        returns on first read (the fused fit's packed diagnostics)."""
        stats = cls((), (), ())
        stats._thunk = thunk
        return stats

    def _materialize(self):
        if self._host is None and self._thunk is not None:
            self._host = self._thunk()
            self._thunk = None
        if self._host is None:
            reasons, iters, keeps = self._device
            keep = (np.concatenate(keeps) if keeps
                    else np.empty(0, dtype=bool))

            def pull(parts):
                if not parts:
                    return np.empty(0, dtype=np.int32)
                return torch.cat(parts).cpu().numpy()

            self._host = (pull(reasons)[keep], pull(iters)[keep])
            self._device = None
        return self._host

    @property
    def reasons(self) -> np.ndarray:
        return self._materialize()[0]

    @property
    def iterations(self) -> np.ndarray:
        return self._materialize()[1]

    @property
    def convergence_reason_counts(self) -> dict:
        counts = {}
        for code, cnt in zip(*np.unique(self.reasons, return_counts=True)):
            counts[optim.ConvergenceReason(int(code)).name] = int(cnt)
        return counts

    @property
    def iterations_mean(self) -> float:
        it = self.iterations
        return float(it.mean()) if it.size else 0.0

    @property
    def iterations_max(self) -> int:
        it = self.iterations
        return int(it.max()) if it.size else 0

    @property
    def num_entities(self) -> int:
        return int(self.iterations.size)


def _any_running(mask: torch.Tensor) -> bool:
    """The Newton loops' test, one counted host sync."""
    global host_syncs
    host_syncs += 1
    return bool(mask.any())


def _spd_solve_cg_sb(h: torch.Tensor, b: torch.Tensor, sub_dim: int,
                     active: torch.Tensor) -> torch.Tensor:
    """S-step CG on every entity's SPD system ``h x = b`` (h [B, S, S],
    b [B, S]). Converged entities (``active`` False) keep x frozen. The
    reference keeps H batch-minor for the TPU's tiling; the arithmetic is
    the same here in entity-major layout."""
    x = torch.zeros_like(b)
    r = b
    p = b
    rs = torch.sum(b * b, dim=-1)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for _ in range(sub_dim):
        hp = torch.einsum("bst,bt->bs", h, p)
        denom = torch.sum(p * hp, dim=-1)
        alpha = torch.where(active, rs / denom.clamp(min=1e-30), zero)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * hp
        rs_new = torch.sum(r * r, dim=-1)
        beta = rs_new / rs.clamp(min=1e-30)
        p = r + torch.where(active, beta, zero)[:, None] * p
        rs = rs_new
    return x


def _onehot_slots(slots: torch.Tensor, dim: int, dtype) -> torch.Tensor:
    """[B, dim] one-hot of each entity's slot; all zero where slot < 0."""
    return (torch.arange(dim, device=slots.device)[None, :]
            == slots[:, None]).to(dtype)


def _coef_to_transformed(w, factors, shifts, int_onehot):
    if shifts is not None:
        w = w + torch.sum(w * shifts, dim=-1, keepdim=True) * int_onehot
    if factors is not None:
        w = w / factors
    return w


def _coef_to_original(w_t, factors, shifts, int_onehot):
    w = w_t if factors is None else w_t * factors
    if shifts is not None:
        w = w - torch.sum(w * shifts, dim=-1, keepdim=True) * int_onehot
    return w


def _densify_ell_slots(x_indices: torch.Tensor, x_values: torch.Tensor,
                       sub_dim: int) -> torch.Tensor:
    """[..., k] slot-ELL to [..., S] dense by a one-hot contraction;
    duplicate slots sum (f32 accumulator for bf16 values, the result back
    in the storage dtype)."""
    onehot = (x_indices.long()[..., None]
              == torch.arange(sub_dim, device=x_indices.device)
              ).to(x_values.dtype)
    return precision_mod.acc_einsum(
        "...k,...ks->...s", x_values, onehot).to(x_values.dtype)


def _spd_solve_cg(h: torch.Tensor, b: torch.Tensor, sub_dim: int,
                  refine: bool = True) -> torch.Tensor:
    """Every entity's SPD system ``h x = b`` (h [B, S, S], b [B, S]) by
    S steps of CG, then, with ``refine``, one pass of iterative
    refinement ``x += cg(h, b - h x)``: S-step CG alone is not backward
    stable in f32 on an ill-conditioned h."""
    active = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
    x = _spd_solve_cg_sb(h, b, sub_dim, active)
    if not refine:
        return x
    res = b - torch.einsum("bst,bt->bs", h, x)
    return x + _spd_solve_cg_sb(h, res, sub_dim, active)


def _direct_result(w: torch.Tensor, variances: torch.Tensor):
    """(w, variances, iterations, reasons) of an exact solve: one
    iteration, converged."""
    bsz = w.shape[0]
    return (w, variances,
            torch.ones(bsz, dtype=torch.int32, device=w.device),
            torch.full((bsz,), int(optim.ConvergenceReason.GRADIENT_CONVERGED),
                       dtype=torch.int32, device=w.device))


def _entity_variances(x, curvature, factors, shifts, l2_diag, valid_mask,
                      variance_computation: VarianceComputationType,
                      x_sq=None):
    """Each entity's variances from its RAW design x [B, R, S] and
    curvature ``weights * d2l/dz2`` [B, R], through its projected
    normalization (the reference's ``variances_in_transformed_space``
    per entity): SIMPLE inverts f^2 (sum c x^2 - 2 s sum c x + s^2 sum
    c) + l2_diag, FULL takes the Cholesky inverse's diagonal of
    F (H_raw - s a^T - a s^T + (sum c) s s^T) F + diag(l2_diag). Slots
    with no curvature get inf, padded slots 0; original space. ``x_sq``
    replaces ``x * x`` in SIMPLE: an ELL bucket's squares taken entry by
    entry (the reference's ELL ``rmatvec_sq``)."""
    c = curvature
    cs = precision_mod.like_storage(c, x)
    normalized = factors is not None or shifts is not None
    sh = torch.zeros_like(l2_diag) if shifts is None else shifts
    fa = torch.ones_like(l2_diag) if factors is None else factors
    if variance_computation == VarianceComputationType.SIMPLE:
        diag = precision_mod.acc_einsum(
            "brs,br->bs", x * x if x_sq is None else x_sq, cs)
        if normalized:
            d1 = precision_mod.acc_einsum("brs,br->bs", x, cs)
            tot = torch.sum(c, dim=-1)[:, None]
            diag = fa * fa * (diag - 2.0 * sh * d1 + sh * sh * tot)
        diag = diag + l2_diag
        var_t = 1.0 / torch.where(diag == 0.0, torch.inf, diag)
    else:
        h = precision_mod.acc_einsum("brs,brt->bst", x * cs[:, :, None], x)
        if normalized:
            a = precision_mod.acc_einsum("brs,br->bs", x, cs)
            tot = torch.sum(c, dim=-1)[:, None, None]
            h = (h - sh[:, :, None] * a[:, None, :]
                 - a[:, :, None] * sh[:, None, :]
                 + tot * (sh[:, :, None] * sh[:, None, :]))
            h = fa[:, :, None] * h * fa[:, None, :]
        h = h + torch.diag_embed(l2_diag)
        dead = torch.diagonal(h, dim1=-2, dim2=-1) == 0.0
        h = h + torch.diag_embed(dead.to(h.dtype))
        var_t = torch.where(dead, torch.inf, cholesky_inverse_diagonal(h))
    f_sq = 1.0 if factors is None else factors * factors
    return torch.where(valid_mask > 0, var_t * f_sq,
                       torch.zeros_like(var_t))


def _batched_variances(x_t, labels, offsets, weights, w_t, l2_diag,
                       valid_mask, factors, loss,
                       variance_computation: VarianceComputationType):
    """Variances of a dense bucket whose design ``x_t`` is already
    transformed (the Newton route; reference :767-813): SIMPLE inverts
    the Hessian's diagonal, FULL solves for each basis vector by one
    refined S-step CG. Slots with no curvature get inf, padded slots
    0; original space. A bf16 design is read with f32 accumulators."""
    z = precision_mod.acc_einsum(
        "brs,bs->br", x_t, precision_mod.like_storage(w_t, x_t)) + offsets
    curv = weights * loss.dzz(z, labels)
    f_sq = 1.0 if factors is None else factors * factors
    if variance_computation == VarianceComputationType.SIMPLE:
        return f_sq * _entity_variances(x_t, curv, None, None, l2_diag,
                                        valid_mask, variance_computation)
    cs = precision_mod.like_storage(curv, x_t)
    h_diag = precision_mod.acc_einsum("brs,br->bs", x_t * x_t, cs) + l2_diag
    dead = h_diag == 0.0
    s = w_t.shape[-1]
    h = precision_mod.acc_einsum("brs,brt->bst", x_t * cs[:, :, None], x_t)
    h = h + torch.diag_embed(l2_diag + dead.to(h.dtype))
    active = torch.ones(w_t.shape[0], dtype=torch.bool, device=w_t.device)
    var_t = torch.zeros_like(w_t)
    for i in range(s):
        e = torch.zeros_like(w_t)
        e[:, i].fill_(1.0)
        sol = _spd_solve_cg_sb(h, e, s, active)
        res = e - torch.einsum("bst,bt->bs", h, sol)
        sol = sol + _spd_solve_cg_sb(h, res, s, active)
        var_t[:, i] = sol[:, i]
    var_t = torch.where(dead, torch.inf, var_t)
    return torch.where(valid_mask > 0, var_t * f_sq, torch.zeros_like(var_t))


def _prior_terms(prior, factors, shifts, int_onehot, valid_mask,
                 l2_weight: float, incremental_weight: float):
    """(m_t, l2_diag): an incremental prior's transformed means and its
    per-slot penalty (RandomEffectOptimizationProblem.scala:137-198)."""
    m_t = _coef_to_transformed(prior[0], factors, shifts, int_onehot)
    f_sq = 1.0 if factors is None else factors * factors
    inv_prior_var = optim.inverse_prior_variances(
        prior[1] / f_sq, l2_weight) * valid_mask
    return m_t, incremental_weight * inv_prior_var


def _solve_direct_batched(x_indices, x_values, labels, offsets, weights,
                          penalty_mask, valid_mask, factors, shifts,
                          intercept_slots, prior, *, sub_dim: int,
                          variance_computation: VarianceComputationType,
                          l2_weight: float, incremental_weight: float):
    """Exact squared-loss solve of a whole bucket: per entity the normal
    equations ``(X'^T W X' + diag(pen)) w = X'^T W (y - offset)`` (plus
    the prior), solved by CG with refinement. The reference's per-entity
    ``_solve_one_entity_direct`` written as one batch. An ELL bucket
    (``x_indices`` set, a shape densify's gates refuse) is densified
    whole by ``segment_reduce.densify_ell``."""
    dtype = labels.dtype
    if x_indices is None:
        x = x_values
    else:
        x = segment_reduce.densify_ell(x_indices, x_values, sub_dim)
    x_raw = x
    if shifts is not None:
        x = x - precision_mod.like_storage(shifts, x)[:, None, :]
    if factors is not None:
        x = x * precision_mod.like_storage(factors, x)[:, None, :]
    y_eff = (labels - offsets) * weights
    h = precision_mod.acc_einsum(
        "brs,brt->bst",
        x * precision_mod.like_storage(weights, x)[:, :, None], x)
    bvec = precision_mod.acc_einsum(
        "brs,br->bs", x, precision_mod.like_storage(y_eff, x))
    int_onehot = (None if shifts is None
                  else _onehot_slots(intercept_slots, sub_dim, dtype))
    if prior is not None:
        m_t, l2_diag = _prior_terms(prior, factors, shifts, int_onehot,
                                    valid_mask, l2_weight, incremental_weight)
        bvec = bvec + l2_diag * m_t
    else:
        l2_diag = l2_weight * penalty_mask
    h = h + torch.diag_embed(l2_diag + (1.0 - valid_mask))
    w_t = _spd_solve_cg(h, bvec, sub_dim) * valid_mask
    w = _coef_to_original(w_t, factors, shifts, int_onehot) * valid_mask
    if variance_computation == VarianceComputationType.NONE:
        return _direct_result(w, torch.zeros_like(w))
    # Squared loss: the curvature is the row weight.
    return _direct_result(w, _entity_variances(
        x_raw.to(dtype), weights, factors, shifts, l2_diag, valid_mask,
        variance_computation))


def _solve_direct_gram(block, offsets, factors_sub, prior, *, sub_dim: int,
                       l2_weight: float, incremental_weight: float,
                       gram_mults: tuple):
    """Exact squared-loss solve of a whole bucket straight from its ELL
    blocks: ``X^T W X`` ([B, S, S]) and ``X^T W (y - offset)`` ([B, S])
    are segment sums of the ELL entries (``ell_gram_blocks``,
    ``ell_segment_slots``, both through the segment-sum kernel), so no
    dense slab exists. Factors fold in after the reduce (H' = F H F,
    b' = F b); the route is taken only without shifts and variances."""
    dtype = block.labels.dtype
    s = sub_dim
    grad_mult, hess_mult = gram_mults
    gram = segment_reduce.ell_gram_blocks(
        block.x_indices, block.x_values, block.weights, s,
        multiplicity=hess_mult)
    y_eff = (block.labels - offsets) * block.weights
    bvec = segment_reduce.ell_segment_slots(
        block.x_indices, block.x_values, y_eff, s, multiplicity=grad_mult)
    if gram is None or bvec is None:
        raise RuntimeError("the gram route was chosen for a bucket its "
                           "reduces do not serve")
    h = gram.to(dtype)
    b_vec = bvec.to(dtype)
    if factors_sub is not None:
        h = h * factors_sub[:, :, None] * factors_sub[:, None, :]
        b_vec = b_vec * factors_sub
    valid_mask = block.valid_mask
    if prior is not None:
        m_t, l2_diag = _prior_terms(prior, factors_sub, None, None,
                                    valid_mask, l2_weight,
                                    incremental_weight)
        b_vec = b_vec + l2_diag * m_t
    else:
        l2_diag = l2_weight * block.penalty_mask
    # Padding slots get a unit diagonal so the system stays PD.
    h = h + torch.diag_embed(l2_diag + (1.0 - valid_mask))
    w_t = _spd_solve_cg(h, b_vec, s) * valid_mask
    w = _coef_to_original(w_t, factors_sub, None, None) * valid_mask
    return _direct_result(w, torch.zeros_like(w))


def _solve_newton_batched(x, labels, offsets, weights, penalty_mask,
                          valid_mask, factors, shifts, intercept_slots,
                          w0_orig, prior, *, sub_dim: int, task: TaskType,
                          opt_config: optim.OptimizerConfig,
                          variance_computation: VarianceComputationType,
                          l2_weight: float, incremental_weight: float,
                          per_entity: bool = False, x_sq=None):
    """Damped Newton/IRLS for a whole dense bucket x [B, R, S]. Returns
    (w [B, S] original space, variances, iterations [B], reasons [B]).
    Solver state is in the labels' dtype; a bf16 slab is read bf16 with
    f32 accumulators (reference :579-587, :690-717) and takes the plain
    route, as the Newton kernel takes f32 only. ``per_entity`` is the
    ``ell`` route's arithmetic (reference :815-969): never the kernel,
    each direction by ``_spd_solve_cg(refine=False)`` and each entity's
    variances from its own raw design (``_entity_variances``, with the
    entry-by-entry squares ``x_sq``)."""
    global plain_route_solves
    dtype = labels.dtype
    dev = labels.device
    b = x.shape[0]
    x_raw = x
    if shifts is not None:
        x = x - precision_mod.like_storage(shifts, x)[:, None, :]
    if factors is not None:
        x = x * precision_mod.like_storage(factors, x)[:, None, :]
    loss = losses_mod.get_loss(task)
    int_onehot = (None if shifts is None
                  else _onehot_slots(intercept_slots, sub_dim, dtype))
    if prior is not None:
        m_t, l2_diag = _prior_terms(prior, factors, shifts, int_onehot,
                                    valid_mask, l2_weight, incremental_weight)
    else:
        m_t = torch.zeros((b, sub_dim), dtype=dtype, device=dev)
        l2_diag = l2_weight * penalty_mask

    def margins(w):
        return precision_mod.acc_einsum(
            "brs,bs->br", x, precision_mod.like_storage(w, x))

    def objective(w):
        z = margins(w) + offsets
        f = torch.sum(weights * loss.loss(z, labels), dim=-1) + 0.5 * (
            torch.sum(l2_diag * (w - m_t) ** 2, dim=-1))
        g = precision_mod.acc_einsum(
            "brs,br->bs", x,
            precision_mod.like_storage(weights * loss.dz(z, labels), x))
        g = g + l2_diag * (w - m_t)
        return f, g * valid_mask

    # Per-entity absolute tolerances from the zero state.
    f0z, g0z = objective(torch.zeros((b, sub_dim), dtype=dtype, device=dev))
    tol = optim.Tolerances(
        loss_abs=f0z.abs() * opt_config.tolerance,
        gradient_abs=torch.sqrt(torch.sum(g0z * g0z, dim=-1))
        * opt_config.tolerance,
    )
    w = _coef_to_transformed(w0_orig, factors, shifts, int_onehot) * valid_mask
    f, g = objective(w)
    max_iters = opt_config.max_iterations
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    code = torch.zeros(b, dtype=torch.int32, device=dev)
    trials = _NEWTON_LINE_SEARCH_HALVINGS + 1
    r = x.shape[1]
    kernel_route = (not per_entity
                    and nk.kernel_supported(task, x.dtype, r, sub_dim))
    if kernel_route:
        x = x.contiguous()
        step_args = [t.contiguous() for t in (
            labels, weights, offsets, l2_diag.expand(b, sub_dim),
            m_t.expand(b, sub_dim), valid_mask)]
    else:
        if not per_entity:
            plain_route_solves += 1
        trial_ts = 0.5 ** torch.arange(trials, dtype=dtype, device=dev)
        eye = torch.eye(sub_dim, dtype=dtype, device=dev)[None]
        diag = (l2_diag[:, :, None] * eye
                + (1.0 - valid_mask)[:, :, None] * eye)

    c = SimpleNamespace(w=w, f=f, g=g, it=it, code=code)

    def body(active):
        w, f, g, it = c.w, c.f, c.g, c.it
        if kernel_route:
            y_, wt_, off_, l2_, mt_, vm_ = step_args
            w_n, f_n, g_n, improved = nk.newton_step(
                x, w, y_, wt_, off_, l2_, mt_, vm_, f, task=task,
                trials=trials)
            w_n = torch.where(active[:, None], w_n, w)
        else:
            z = margins(w) + offsets
            curvature = weights * loss.dzz(z, labels)
            h = precision_mod.acc_einsum(
                "brs,brt->bst",
                x * precision_mod.like_storage(curvature, x)[:, :, None], x)
            h = h + diag
            if per_entity:
                d = _spd_solve_cg(h, -g, sub_dim, refine=False) * valid_mask
            else:
                d = _spd_solve_cg_sb(h, -g, sub_dim, active) * valid_mask
            gd = torch.sum(g * d, dim=-1)
            bad = gd >= 0.0
            d = torch.where(bad[:, None], -g, d)
            gd = torch.where(bad, -torch.sum(g * g, dim=-1), gd)
            zd = margins(d)
            z_t = z[None] + trial_ts[:, None, None] * zd[None]
            w_tr = w[None] + trial_ts[:, None, None] * d[None]
            f_t = torch.sum(weights[None] * loss.loss(z_t, labels[None]),
                            dim=-1) + 0.5 * torch.sum(
                l2_diag[None] * (w_tr - m_t[None]) ** 2, dim=-1)
            armijo = f_t <= f[None] + 1e-4 * trial_ts[:, None] * gd[None]
            first = torch.argmax(armijo.to(torch.int8), dim=0)
            t = trial_ts[first]
            f_sel = torch.gather(f_t, 0, first[None])[0]
            improved = armijo.any(dim=0) & (f_sel < f)
            step_ok = active & improved
            w_n = torch.where(step_ok[:, None], w + t[:, None] * d, w)
            f_n, g_n = objective(w_n)
        f_n = torch.where(active, f_n, f)
        g_n = torch.where(active[:, None], g_n, g)
        it_n = torch.where(active, it + 1, it)
        code_n = optim.convergence_code(
            iteration=it_n, max_iterations=max_iters, loss_delta=f - f_n,
            gradient_norm=torch.sqrt(torch.sum(g_n * g_n, dim=-1)), tol=tol,
            not_improving=~improved)
        c.code = torch.where(active, code_n, c.code)
        c.w, c.f, c.g, c.it = w_n, f_n, g_n, it_n

    device_loop.while_loop(lambda: c.code == 0, body, (c,),
                           any_running=_any_running)
    w, it, code = c.w, c.it, c.code

    w_t = w * valid_mask
    if variance_computation == VarianceComputationType.NONE:
        variances = torch.zeros_like(w_t)
    elif per_entity:
        curvature = weights * loss.dzz(margins(w_t) + offsets, labels)
        variances = _entity_variances(
            x_raw, curvature, factors, shifts, l2_diag, valid_mask,
            variance_computation, x_sq=x_sq)
    else:
        variances = _batched_variances(
            x, labels, offsets, weights, w_t, l2_diag, valid_mask, factors,
            loss, variance_computation)
    w_orig = _coef_to_original(w_t, factors, shifts, int_onehot) * valid_mask
    return w_orig, variances, it, code


def _solve_newton_ell(x_indices, x_values, labels, offsets, weights,
                      penalty_mask, valid_mask, factors, shifts,
                      intercept_slots, w0_orig, prior, *, sub_dim: int,
                      task: TaskType, opt_config: optim.OptimizerConfig,
                      variance_computation: VarianceComputationType,
                      l2_weight: float, incremental_weight: float):
    """The ``ell`` route: the reference's per-entity Newton solve of an
    ELL bucket (``_solve_one_entity_newton`` under ``jax.vmap``) for the
    whole bucket at once. Each entity's design is densified in the
    values' dtype (``_materialize_transformed_design``'s ``.at[].add``,
    one scatter per ELL column, so duplicates sum in a fixed order);
    then the damped Newton loop of ``_solve_newton_batched`` with the
    per-entity arithmetic, a ``device_loop`` loop without host syncs
    inside a CUDA graph. SIMPLE variances square a duplicate slot's
    entries one by one, as the reference's ELL ``rmatvec_sq`` does."""
    x = segment_reduce.densify_ell_plain(x_indices, x_values, sub_dim)
    x_sq = None
    if variance_computation == VarianceComputationType.SIMPLE:
        x_sq = segment_reduce.densify_ell_plain(
            x_indices, x_values * x_values, sub_dim)
    return _solve_newton_batched(
        x, labels, offsets, weights, penalty_mask, valid_mask, factors,
        shifts, intercept_slots, w0_orig, prior, sub_dim=sub_dim, task=task,
        opt_config=opt_config, variance_computation=variance_computation,
        l2_weight=l2_weight, incremental_weight=incremental_weight,
        per_entity=True, x_sq=x_sq)


def _solve_quasi_newton_batched(x, labels, offsets, weights, penalty_mask,
                                valid_mask, factors, shifts, intercept_slots,
                                w0_orig, prior, *, sub_dim: int,
                                task: TaskType,
                                opt_config: optim.OptimizerConfig,
                                variance_computation: VarianceComputationType,
                                l1_weight, l2_weight,
                                incremental_weight,
                                use_owlqn: bool | None = None):
    """The configured quasi-Newton solver over a whole dense bucket, x
    [B, R, S] raw: the reference's ``_solve_one_entity`` (:970-1079)
    for every entity at once. The objective works on raw features
    through each entity's effective coefficients (margin x.(w f) -
    s.(w f) + offset); the masked L2 or the Gaussian prior is added,
    OWL-QN takes an L1 part, TRON gets the matching Hessian-vector
    product, and L-BFGS hands box constraints to L-BFGS-B. Returns
    (w [B, S] original space, variances, iterations [B], reasons [B])."""
    global quasi_newton_solves
    quasi_newton_solves += 1
    dtype = labels.dtype
    loss = losses_mod.get_loss(task)
    int_onehot = (None if shifts is None
                  else _onehot_slots(intercept_slots, sub_dim, dtype))

    def effective(w):
        ew = w if factors is None else w * factors
        es = (torch.zeros_like(ew[:, 0]) if shifts is None
              else torch.sum(shifts * ew, dim=-1))
        return ew, es

    def to_transformed_grad(raw, total):
        g = raw if shifts is None else raw - shifts * total[:, None]
        return g if factors is None else g * factors

    def margins(w):
        ew, es = effective(w)
        return torch.einsum("brs,bs->br", x, ew) - es[:, None] + offsets

    if prior is not None:
        m_t = _coef_to_transformed(prior[0], factors, shifts, int_onehot)
        f_sq = 1.0 if factors is None else factors * factors
        inv_prior_var = optim.inverse_prior_variances(
            prior[1] / f_sq, l2_weight) * valid_mask
        l2_diag = incremental_weight * inv_prior_var
    else:
        m_t = None
        l2_diag = l2_weight * penalty_mask

    def objective(w):
        z = margins(w)
        value = torch.sum(weights * loss.loss(z, labels), dim=-1)
        c = weights * loss.dz(z, labels)
        g = to_transformed_grad(torch.einsum("brs,br->bs", x, c),
                                torch.sum(c, dim=-1))
        if m_t is not None:
            dw = (w - m_t) * inv_prior_var
            return (value + 0.5 * incremental_weight * batched.dot(
                w - m_t, dw), g + incremental_weight * dw)
        wm = w * penalty_mask
        return (value + 0.5 * l2_weight * batched.dot(wm, wm),
                g + l2_weight * wm)

    def hvp(w, v):
        ev, es_v = effective(v)
        zv = torch.einsum("brs,bs->br", x, ev) - es_v[:, None]
        h = weights * loss.dzz(margins(w), labels) * zv
        hv = to_transformed_grad(torch.einsum("brs,br->bs", x, h),
                                 torch.sum(h, dim=-1))
        return hv + (incremental_weight * (v * inv_prior_var)
                     if m_t is not None else l2_weight * (v * penalty_mask))

    w0 = _coef_to_transformed(w0_orig, factors, shifts, int_onehot)
    if use_owlqn is None:
        use_owlqn = l1_weight != 0.0
    if use_owlqn:
        res = owlqn.owlqn(objective, w0, l1_weight, opt_config)
    elif opt_config.optimizer_type == optim.OptimizerType.TRON:
        res = tron.tron(objective, w0, opt_config, hvp=hvp)
    else:
        res = batched.lbfgs(objective, w0, opt_config)
    w_t = res.coefficients * valid_mask
    if variance_computation == VarianceComputationType.NONE:
        variances = torch.zeros_like(w_t)
    else:
        variances = _entity_variances(
            x, weights * loss.dzz(margins(w_t), labels), factors, shifts,
            l2_diag, valid_mask, variance_computation)
    w_orig = _coef_to_original(w_t, factors, shifts, int_onehot) * valid_mask
    return w_orig, variances, res.iterations, res.convergence_reason


def _scatter_results(w_all, v_all, codes, w, v, it, reason):
    """Pad one bucket's solutions to the table width and scatter them."""
    pad = w_all.shape[1] - w.shape[1]
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
        v = torch.nn.functional.pad(v, (0, pad))
    idx = codes.long()
    w_all[idx] = w
    if v_all is not None:
        v_all[idx] = v
    return w_all, v_all, it, reason


def block_route(block, sub_dim: int, *, direct: bool, newton: bool,
                gram_mults: tuple | None, shifts: bool,
                variances: bool) -> str:
    """How a bucket's design reaches its solver, as the reference
    chooses on a TPU:

    - ``dense``: the slab is subspace-dense already (lazy buckets);
    - ``one_hot``: a narrow ELL bucket densified by a one-hot product;
    - ``gram``: a direct solve straight from the ELL blocks;
    - ``densify``: a wide ELL bucket densified by the segment-sum kernel;
    - ``ell``: the bucket stays ELL (a shape or dtype densify does not
      take): a Newton bucket takes ``_solve_newton_ell``, the
      per-entity Newton solve; a quasi-Newton or direct one densifies
      in its solver (``segment_reduce.densify_ell``).
    """
    shape = None if block.x_indices is None else tuple(
        block.x_indices.shape)
    return route_of(shape, block.x_values.dtype, sub_dim, direct=direct,
                    newton=newton, gram_mults=gram_mults, shifts=shifts,
                    variances=variances)


def route_of(ell_shape: tuple | None, dtype, sub_dim: int, *, direct: bool,
             newton: bool, gram_mults: tuple | None, shifts: bool,
             variances: bool) -> str:
    """``block_route`` from a bucket's ELL shape ``[B, R, k]`` (None for
    a subspace-dense slab) and its slab dtype."""
    if ell_shape is None:
        return "dense"
    b, r, k = ell_shape
    if (sub_dim <= DENSE_SUB_DIM_MAX
            and b * r * k * sub_dim <= re_data.ONE_HOT_ELEMENT_BUDGET):
        return "one_hot"
    if (direct and gram_mults is not None and not shifts and not variances
            and segment_reduce.ell_gram_supported(
                b, r, k, sub_dim, grad_mult=gram_mults[0],
                hess_mult=gram_mults[1])):
        return "gram"
    if (direct or newton) and segment_reduce.densify_supported(
            b, r, k, sub_dim, dtype):
        return "densify"
    return "ell"


def _solve_block(block, residuals, factors_full, shifts_full, w0_full,
                 l1_weight: float, l2_weight: float,
                 incremental_weight: float, prior_full,
                 w_all, v_all, **kw):
    """One bucket's batched per-entity solve (``_solve_bucket``),
    scattered into the [E, Smax] tables."""
    codes, w, v, it, reason = _solve_bucket(
        block, residuals, factors_full, shifts_full, w0_full, l1_weight,
        l2_weight, incremental_weight, prior_full,
        num_entities=w_all.shape[0], **kw)
    return _scatter_results(w_all, v_all, codes, w, v, it, reason)


def _solve_bucket(block, residuals, factors_full, shifts_full, w0_full,
                  l1_weight: float, l2_weight: float,
                  incremental_weight: float, prior_full, *,
                  num_entities: int, sub_dim: int, task: TaskType,
                  opt_config: optim.OptimizerConfig,
                  variance_computation: VarianceComputationType,
                  direct: bool, newton: bool,
                  gram_mults: tuple | None = None,
                  use_owlqn: bool | None = None,
                  precision: str = "float32"):
    """One bucket's batched per-entity solve: ``(entity codes, w [B, S],
    variances [B, S], iterations [B], reasons [B])``. A lazy
    ``BlockPlan`` gathers its slab here; an ELL block takes the route
    ``block_route`` names. The fused fit passes the weights as 0-d
    tensors and ``use_owlqn``, the static L1 route. Under
    ``precision="bfloat16"`` the slab is stored bf16 while the solver
    state stays in the labels' dtype (reference :1129-1136); the
    quasi-Newton route reads it back in f32. Sentinel codes (a mesh's
    entity padding) read the last entity's initial and prior rows;
    their results are dropped on the way back."""
    if isinstance(block, BlockPlan):
        block = block.materialize(residuals)
        offsets = block.offsets
    else:
        offsets = block.offsets
        if residuals is not None:
            offsets = offsets + torch.where(
                block.weights > 0, residuals[block.row_ids.long()],
                torch.zeros((), dtype=offsets.dtype, device=offsets.device))
    if precision_mod.is_mixed(precision):
        block = dataclasses.replace(
            block, x_values=precision_mod.in_storage(block.x_values,
                                                     precision))
    dtype = block.labels.dtype
    route = block_route(
        block, sub_dim, direct=direct, newton=newton, gram_mults=gram_mults,
        shifts=shifts_full is not None,
        variances=variance_computation != VarianceComputationType.NONE)
    route_solves[route] = route_solves.get(route, 0) + 1
    if route == "one_hot":
        block = dataclasses.replace(block, x_indices=None,
                                    x_values=_densify_ell_slots(
                                        block.x_indices, block.x_values,
                                        sub_dim))
    elif route == "densify":
        block = dataclasses.replace(block, x_indices=None,
                                    x_values=segment_reduce.densify_ell_blocks(
                                        block.x_indices, block.x_values,
                                        sub_dim))
    if (block.x_values.dtype == torch.bfloat16 and not direct
            and not (newton and block.x_indices is None)):
        # The per-entity quasi-Newton route runs f32 end to end: the
        # stored slab is upcast once (reference :1194-1203).
        block = dataclasses.replace(block,
                                    x_values=block.x_values.to(dtype))
    s = sub_dim
    proj = block.proj
    safe = proj.clamp(min=0).long()
    factors_sub = shifts_sub = None
    if factors_full is not None:
        factors_sub = torch.where(proj >= 0, factors_full.to(dtype)[safe],
                                  torch.ones((), dtype=dtype,
                                             device=proj.device))
    if shifts_full is not None:
        shifts_sub = torch.where(proj >= 0, shifts_full.to(dtype)[safe],
                                 torch.zeros((), dtype=dtype,
                                             device=proj.device))
    take = block.entity_codes.long().clamp(0, num_entities - 1)
    prior = None
    if prior_full is not None:
        prior = (prior_full[0].to(dtype)[take][:, :s],
                 prior_full[1].to(dtype)[take][:, :s])
    if route == "gram":
        w, v, it, reason = _solve_direct_gram(
            block, offsets, factors_sub, prior, sub_dim=s,
            l2_weight=l2_weight, incremental_weight=incremental_weight,
            gram_mults=gram_mults)
    elif direct:
        w, v, it, reason = _solve_direct_batched(
            block.x_indices, block.x_values, block.labels, offsets,
            block.weights, block.penalty_mask, block.valid_mask, factors_sub,
            shifts_sub, block.intercept_slots, prior, sub_dim=s,
            variance_computation=variance_computation, l2_weight=l2_weight,
            incremental_weight=incremental_weight)
    elif newton and block.x_indices is not None:
        w0 = w0_full.to(dtype)[take][:, :s]
        w, v, it, reason = _solve_newton_ell(
            block.x_indices, block.x_values, block.labels, offsets,
            block.weights, block.penalty_mask, block.valid_mask, factors_sub,
            shifts_sub, block.intercept_slots, w0, prior, sub_dim=s,
            task=task, opt_config=opt_config,
            variance_computation=variance_computation, l2_weight=l2_weight,
            incremental_weight=incremental_weight)
    else:
        w0 = w0_full.to(dtype)[take][:, :s]
        solver = (_solve_newton_batched if newton
                  else _solve_quasi_newton_batched)
        extra = ({} if newton
                 else {"l1_weight": l1_weight, "use_owlqn": use_owlqn})
        x = (block.x_values if block.x_indices is None
             else segment_reduce.densify_ell(block.x_indices, block.x_values,
                                             s))
        w, v, it, reason = solver(
            x, block.labels, offsets, block.weights,
            block.penalty_mask, block.valid_mask, factors_sub, shifts_sub,
            block.intercept_slots, w0, prior, sub_dim=s, task=task,
            opt_config=opt_config, variance_computation=variance_computation,
            l2_weight=l2_weight, incremental_weight=incremental_weight,
            **extra)
    return block.entity_codes, w, v, it, reason


def _gather_buckets(ds: RandomEffectDataset, solved: list,
                    variances: bool) -> list:
    """Every rank's share of every bucket's results (``_solve_bucket``'s
    tuples on an entity-sharded dataset), gathered in ONE collective and
    concatenated in rank order: each bucket's results over its whole
    padded entity axis, beside the padded codes of the host mirror. The
    ranks' shares have one shape, so one flat buffer of the solution
    dtype carries them (iterations and reasons are small integers, exact
    in it)."""
    mesh = ds.mesh
    dtype = solved[0][1].dtype if solved else ds.dtype
    pieces, layout = [], []
    for _, w, v, it, reason in solved:
        parts = [w] + ([v] if variances else []) + [it, reason]
        layout.append([(tuple(p.shape), p.dtype) for p in parts])
        pieces += [p.reshape(-1).to(dtype) for p in parts]
    if not pieces:
        return []
    ranks = mesh.all_gather(torch.cat(pieces), site=SITE_BUCKET_GATHER)
    out = []
    at = 0
    for i, shapes in enumerate(layout):
        whole = []
        for shape, pdtype in shapes:
            size = int(np.prod(shape))
            whole.append(torch.cat([
                r[at:at + size].reshape(shape) for r in ranks]).to(pdtype))
            at += size
        w, *rest = whole
        v = rest[0] if variances else None
        it, reason = rest[-2:]
        codes = torch.from_numpy(np.asarray(ds.block_codes_np[i])).to(
            w.device)
        out.append((codes, w, v, it, reason))
    return out


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinate:
    """Per-entity coordinate over one random-effect type
    (RandomEffectCoordinate.scala:38). ``prior`` is an incremental
    training prior already laid out on this dataset."""

    dataset: RandomEffectDataset
    task: TaskType
    config: GLMOptimizationConfiguration
    normalization: NormalizationContext = dataclasses.field(
        default_factory=NormalizationContext)
    prior: RandomEffectModel | None = None
    precision: str = "float32"

    def _routes(self) -> tuple[bool, bool]:
        """(direct, newton) as the reference chooses them."""
        well_posed = (
            self.config.l1_weight == 0.0
            and self.config.l2_weight > 0.0
            and self.config.optimizer.box_constraints is None
            and (self.prior is None or self.config.incremental_weight > 0.0)
        )
        direct = well_posed and self.task == TaskType.LINEAR_REGRESSION
        newton = well_posed and self.task in (
            TaskType.LOGISTIC_REGRESSION, TaskType.POISSON_REGRESSION)
        return direct, newton

    def bucket_routes(self) -> tuple:
        """Each bucket's ``block_route``, from the shapes alone (a lazy
        bucket's ELL width by ``BlockPlan.ell_width``): what the fused
        fit's static key records."""
        ds = self.dataset
        direct, newton = self._routes()
        dtype = (torch.bfloat16 if precision_mod.is_mixed(self.precision)
                 else ds.dtype)
        out = []
        for i, b in enumerate(ds.blocks):
            if isinstance(b, BlockPlan):
                k = b.ell_width()
                bb, r = b.row_ids.shape
                shape = None if k is None else (bb, r, k)
            else:
                shape = (None if b.x_indices is None
                         else tuple(b.x_indices.shape))
            out.append(route_of(
                shape, dtype, b.proj.shape[-1], direct=direct, newton=newton,
                gram_mults=(ds.block_gram_mults[i]
                            if i < len(ds.block_gram_mults) else None),
                shifts=self.normalization.shifts is not None,
                variances=(self.config.variance_computation
                           != VarianceComputationType.NONE)))
        return tuple(out)

    def check_trainable(self) -> list:
        """The host checks a solve needs (numpy, never the card): shifts
        need every real entity's intercept slot, a prior its variances.
        Returns each bucket's real-entity mask."""
        ds = self.dataset
        real_masks = [ds.real_entity_mask(i) for i in range(len(ds.blocks))]
        if self.normalization.shifts is not None:
            for ints, real in zip(ds.block_intercepts_np, real_masks):
                if bool((np.asarray(ints)[real] < 0).any()):
                    raise ValueError(
                        "normalization with shifts requires every entity's "
                        "subspace to contain the intercept; build the "
                        "dataset with intercept_index set")
        if self.prior is not None and self.prior.variances is None:
            raise ValueError(
                "incremental training requires prior variances for every "
                "entity model (GameEstimator.scala:241-382)")
        return real_masks

    def train(self, residuals: torch.Tensor | None = None,
              initial_model: RandomEffectModel | None = None, *,
              seed: int = 0):
        ds = self.dataset
        dev, dtype = ds.device, ds.dtype
        shape = (ds.num_entities, ds.max_sub_dim)
        if residuals is None:
            residuals = torch.zeros(ds.num_rows, dtype=dtype, device=dev)
        w0_full = (initial_model.coefficients if initial_model is not None
                   else torch.zeros(shape, dtype=dtype, device=dev))
        w_all = torch.zeros(shape, dtype=dtype, device=dev)
        v_all = (None if self.config.variance_computation
                 == VarianceComputationType.NONE
                 else torch.zeros(shape, dtype=dtype, device=dev))
        real_masks = self.check_trainable()
        direct, newton = self._routes()
        solved = []
        for i, block in enumerate(ds.device_blocks()):
            gram_mults = (ds.block_gram_mults[i]
                          if i < len(ds.block_gram_mults) else None)
            solved.append(_solve_bucket(
                block, residuals, self.normalization.factors,
                self.normalization.shifts, w0_full, self.config.l1_weight,
                self.config.l2_weight,
                self.config.incremental_weight,
                None if self.prior is None
                else (self.prior.coefficients, self.prior.variances),
                num_entities=shape[0], sub_dim=block.sub_dim,
                task=self.task, opt_config=self.config.optimizer,
                variance_computation=self.config.variance_computation,
                direct=direct, newton=newton, gram_mults=gram_mults,
                precision=self.precision))
        if ds.mesh is not None:
            solved = _gather_buckets(ds, solved, v_all is not None)
            # Sentinel codes scatter into a spare last row, cut off.
            w_all = torch.zeros((shape[0] + 1, shape[1]), dtype=dtype,
                                device=dev)
            v_all = None if v_all is None else torch.zeros_like(w_all)
        reasons, iters = [], []
        for codes, w, v, it, reason in solved:
            w_all, v_all, it, reason = _scatter_results(
                w_all, v_all, codes, w, v, it, reason)
            reasons.append(reason)
            iters.append(it)
        if ds.mesh is not None:
            w_all = w_all[:shape[0]]
            v_all = None if v_all is None else v_all[:shape[0]]
        model = RandomEffectModel(
            coefficients=w_all,
            random_effect_type=ds.config.random_effect_type,
            feature_shard_id=ds.config.feature_shard_id,
            task=self.task,
            proj_all=ds.proj_all,
            variances=v_all,
            entity_keys=ds.entity_keys,
        )
        return model, RandomEffectTrainingStats(reasons, iters, real_masks)

    def score(self, model: RandomEffectModel) -> torch.Tensor:
        """Model contribution per canonical row (active and passive)."""
        return model.score_dataset(self.dataset)
