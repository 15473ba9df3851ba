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
For logistic or Poisson loss the bucket runs damped Newton/IRLS
(``_solve_newton_batched``) on a dense slab, with per-entity
convergence through the reference's cascade:

- the Newton-step route, taken when ``newton_kernel.kernel_supported``
  holds (f32, R * S <= 16384): one ``newton_step`` per iteration, the
  CUDA kernel on the card;
- the plain route otherwise (f64, larger buckets): the same iteration as
  PyTorch tensor code with an S-step CG per entity (``_spd_solve_cg_sb``).

Each iteration of either loop makes one host sync, to test whether any
entity is still running; ``host_syncs`` counts them.

Coefficients are solved in the transformed (normalized) space and
reported in the original one; the per-entity intercept slot carries the
shift mass. The vmapped quasi-Newton route (L1, smoothed hinge), the
per-entity Newton solve of an ELL bucket that densify does not take, and
coefficient variances are not ported (ROADMAP Queue A); they raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch import optim
from photon_tpu_torch.algorithm.problems import (
    GLMOptimizationConfiguration,
    VarianceComputationType,
)
from photon_tpu_torch.data.random_effect import (
    DENSE_SUB_DIM_MAX,
    ONE_HOT_ELEMENT_BUDGET,
    BlockPlan,
    RandomEffectDataset,
)
from photon_tpu_torch.models.game import RandomEffectModel
from photon_tpu_torch.ops import losses as losses_mod
from photon_tpu_torch.ops import newton_kernel as nk
from photon_tpu_torch.ops import precision as precision_mod
from photon_tpu_torch.ops import segment_reduce
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.types import TaskType

_NEWTON_LINE_SEARCH_HALVINGS = 15

# Host syncs of the Newton loops (one per iteration of either route).
host_syncs = 0
# Bucket solves that took the plain route.
plain_route_solves = 0
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

    def _materialize(self):
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


def _direct_result(w: torch.Tensor):
    """(w, variances, iterations, reasons) of an exact solve: one
    iteration, converged."""
    bsz = w.shape[0]
    return (w, torch.zeros_like(w),
            torch.ones(bsz, dtype=torch.int32, device=w.device),
            torch.full((bsz,), int(optim.ConvergenceReason.GRADIENT_CONVERGED),
                       dtype=torch.int32, device=w.device))


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
    if variance_computation != VarianceComputationType.NONE:
        raise optim.not_ported("random-effect coefficient variances")
    dtype = labels.dtype
    if x_indices is None:
        x = x_values
    else:
        x = segment_reduce.densify_ell(x_indices, x_values, sub_dim)
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
    return _direct_result(w)


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
    return _direct_result(w)


def _solve_newton_batched(x, labels, offsets, weights, penalty_mask,
                          valid_mask, factors, shifts, intercept_slots,
                          w0_orig, prior, *, sub_dim: int, task: TaskType,
                          opt_config: optim.OptimizerConfig,
                          variance_computation: VarianceComputationType,
                          l2_weight: float, incremental_weight: float):
    """Damped Newton/IRLS for a whole dense bucket x [B, R, S]. Returns
    (w [B, S] original space, variances, iterations [B], reasons [B])."""
    global host_syncs, plain_route_solves
    if variance_computation != VarianceComputationType.NONE:
        raise optim.not_ported("random-effect coefficient variances")
    dtype = labels.dtype
    dev = labels.device
    b = x.shape[0]
    if shifts is not None:
        x = x - shifts[:, None, :]
    if factors is not None:
        x = x * factors[:, None, :]
    loss = losses_mod.get_loss(task)
    int_onehot = (None if shifts is None
                  else _onehot_slots(intercept_slots, sub_dim, dtype))
    if prior is not None:
        m_t, l2_diag = _prior_terms(prior, factors, shifts, int_onehot,
                                    valid_mask, l2_weight, incremental_weight)
    else:
        m_t = torch.zeros((b, sub_dim), dtype=dtype, device=dev)
        l2_diag = l2_weight * penalty_mask

    def objective(w):
        z = torch.einsum("brs,bs->br", x, w) + offsets
        f = torch.sum(weights * loss.loss(z, labels), dim=-1) + 0.5 * (
            torch.sum(l2_diag * (w - m_t) ** 2, dim=-1))
        g = torch.einsum("brs,br->bs", x, weights * loss.dz(z, labels))
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
    kernel_route = nk.kernel_supported(task, x.dtype, r, sub_dim)
    if kernel_route:
        x = x.contiguous()
        step_args = [t.contiguous() for t in (
            labels, weights, offsets, l2_diag.expand(b, sub_dim),
            m_t.expand(b, sub_dim), valid_mask)]
    else:
        plain_route_solves += 1
        trial_ts = 0.5 ** torch.arange(trials, dtype=dtype, device=dev)
        eye = torch.eye(sub_dim, dtype=dtype, device=dev)[None]
        diag = (l2_diag[:, :, None] * eye
                + (1.0 - valid_mask)[:, :, None] * eye)

    while True:
        host_syncs += 1
        active = code == 0
        if not bool(active.any()):
            break
        if kernel_route:
            y_, wt_, off_, l2_, mt_, vm_ = step_args
            w_n, f_n, g_n, improved = nk.newton_step(
                x, w, y_, wt_, off_, l2_, mt_, vm_, f, task=task,
                trials=trials)
            w_n = torch.where(active[:, None], w_n, w)
        else:
            z = torch.einsum("brs,bs->br", x, w) + offsets
            curvature = weights * loss.dzz(z, labels)
            h = torch.einsum("brs,brt->bst", x * curvature[:, :, None], x)
            h = h + diag
            d = _spd_solve_cg_sb(h, -g, sub_dim, active) * valid_mask
            gd = torch.sum(g * d, dim=-1)
            bad = gd >= 0.0
            d = torch.where(bad[:, None], -g, d)
            gd = torch.where(bad, -torch.sum(g * g, dim=-1), gd)
            zd = torch.einsum("brs,bs->br", x, d)
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
        code = torch.where(active, code_n, code)
        w, f, g, it = w_n, f_n, g_n, it_n

    w_t = w * valid_mask
    w_orig = _coef_to_original(w_t, factors, shifts, int_onehot) * valid_mask
    return w_orig, torch.zeros_like(w_t), it, code


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
    - ``ell``: the bucket stays ELL (a shape densify does not take).
    """
    if block.x_indices is None:
        return "dense"
    if (sub_dim <= DENSE_SUB_DIM_MAX
            and block.x_indices.numel() * sub_dim <= ONE_HOT_ELEMENT_BUDGET):
        return "one_hot"
    if (direct and gram_mults is not None and not shifts and not variances
            and segment_reduce.ell_gram_supported(
                *block.x_indices.shape, sub_dim, grad_mult=gram_mults[0],
                hess_mult=gram_mults[1])):
        return "gram"
    if (direct or newton) and segment_reduce.densify_supported(
            *block.x_indices.shape, sub_dim, block.x_values.dtype):
        return "densify"
    return "ell"


def _solve_block(block, residuals, factors_full, shifts_full, w0_full,
                 l2_weight: float, incremental_weight: float, prior_full,
                 w_all, v_all, *, sub_dim: int, task: TaskType,
                 opt_config: optim.OptimizerConfig,
                 variance_computation: VarianceComputationType,
                 direct: bool, newton: bool,
                 gram_mults: tuple | None = None):
    """One bucket's batched per-entity solve, scattered into the
    [E, Smax] tables. A lazy ``BlockPlan`` gathers its slab here; an
    ELL block takes the route ``block_route`` names."""
    if isinstance(block, BlockPlan):
        block = block.materialize(residuals)
        offsets = block.offsets
    else:
        offsets = block.offsets
        if residuals is not None:
            offsets = offsets + torch.where(
                block.weights > 0, residuals[block.row_ids.long()],
                torch.zeros((), dtype=offsets.dtype, device=offsets.device))
    if not (direct or newton):
        raise optim.not_ported(
            "the per-entity quasi-Newton (L-BFGS/OWL-QN/TRON) random-effect "
            "solve")
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
    n_ent = w_all.shape[0]
    take = block.entity_codes.long().clamp(0, n_ent - 1)
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
    elif block.x_indices is None:
        w0 = w0_full.to(dtype)[take][:, :s]
        w, v, it, reason = _solve_newton_batched(
            block.x_values, block.labels, offsets, block.weights,
            block.penalty_mask, block.valid_mask, factors_sub, shifts_sub,
            block.intercept_slots, w0, prior, sub_dim=s, task=task,
            opt_config=opt_config, variance_computation=variance_computation,
            l2_weight=l2_weight, incremental_weight=incremental_weight)
    else:
        raise optim.not_ported("the per-entity Newton solve of an ELL bucket")
    return _scatter_results(w_all, v_all, block.entity_codes, w, v, it,
                            reason)


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

    def train(self, residuals: torch.Tensor | None = None,
              initial_model: RandomEffectModel | None = None, *,
              seed: int = 0):
        if precision_mod.is_mixed(self.precision):
            raise optim.not_ported("bf16 random-effect training")
        ds = self.dataset
        dev, dtype = ds.device, ds.dtype
        shape = (ds.num_entities, ds.max_sub_dim)
        if residuals is None:
            residuals = torch.zeros(ds.num_rows, dtype=dtype, device=dev)
        w0_full = (initial_model.coefficients if initial_model is not None
                   else torch.zeros(shape, dtype=dtype, device=dev))
        w_all = torch.zeros(shape, dtype=dtype, device=dev)
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
        direct, newton = self._routes()
        reasons, iters = [], []
        for i, block in enumerate(ds.device_blocks()):
            gram_mults = (ds.block_gram_mults[i]
                          if i < len(ds.block_gram_mults) else None)
            w_all, _, it, reason = _solve_block(
                block, residuals, self.normalization.factors,
                self.normalization.shifts, w0_full, self.config.l2_weight,
                self.config.incremental_weight,
                None if self.prior is None
                else (self.prior.coefficients, self.prior.variances),
                w_all, None, sub_dim=block.sub_dim, task=self.task,
                opt_config=self.config.optimizer,
                variance_computation=self.config.variance_computation,
                direct=direct, newton=newton, gram_mults=gram_mults)
            reasons.append(reason)
            iters.append(it)
        model = RandomEffectModel(
            coefficients=w_all,
            random_effect_type=ds.config.random_effect_type,
            feature_shard_id=ds.config.feature_shard_id,
            task=self.task,
            proj_all=ds.proj_all,
            variances=None,
            entity_keys=ds.entity_keys,
        )
        return model, RandomEffectTrainingStats(reasons, iters, real_masks)

    def score(self, model: RandomEffectModel) -> torch.Tensor:
        """Model contribution per canonical row (active and passive)."""
        return model.score_dataset(self.dataset)
