"""The port's TRON, OWL-QN and L-BFGS-B against the JAX package's, on
the CPU.

Each case builds a small GLM (d <= 16, a few hundred rows) from a numpy
seed, gives both packages the same float64 arrays, and runs the
reference's solver and the port's on the objective each package builds
(``ops/glm``). The port's solvers are batched; a single problem is a
batch of one, and a stack of problems is solved as one batch.

Tolerances, all in float64, where both sides make the same decisions
on values that differ only by the order of floating-point sums:
- iterations and convergence reasons equal;
- coefficients within 1e-10 (absolute; they are O(1));
- OWL-QN's exact zeros equal, coefficient for coefficient;
- objective values within 1e-12 relative.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu import optim as jax_optim
from photon_tpu.data import dataset as jax_ds
from photon_tpu.ops import glm as jax_glm
from photon_tpu.ops import losses as jax_losses
from photon_tpu_torch import optim
from photon_tpu_torch.data import dataset as pt_ds
from photon_tpu_torch.ops import glm as pt_glm
from photon_tpu_torch.ops import losses as pt_losses
from photon_tpu_torch.optim import batched

COEF_ATOL = 1e-10
LOSSES = ("logistic", "poisson", "squared")


def problem(loss: str, seed: int, n: int = 240, d: int = 12):
    """(x, y, offsets, weights) of a GLM with an intercept column."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[:, -1] = 1.0
    w = rng.normal(size=d) * 0.5
    z = x @ w
    if loss == "logistic":
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(float)
    elif loss == "poisson":
        y = rng.poisson(np.exp(0.5 * z)).astype(float)
    else:
        y = z + 0.3 * rng.normal(size=n)
    off = 0.1 * rng.normal(size=n)
    wt = rng.uniform(0.5, 1.5, size=n)
    return x, y, off, wt


def objectives(loss: str, arrays):
    """((fun, hvp) of the reference, (fun, hvp) of the port)."""
    x, y, off, wt = arrays
    jb = jax_ds.GLMBatch(jax_ds.DenseFeatures(jnp.asarray(x)),
                         jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt))
    pb = pt_ds.GLMBatch(pt_ds.DenseFeatures(torch.tensor(x)),
                        torch.tensor(y), torch.tensor(off), torch.tensor(wt))
    jl, pl = jax_losses.get_loss(loss), pt_losses.get_loss(loss)
    return ((jax_glm.make_value_and_grad(jb, jl), jax_glm.make_hvp(jb, jl)),
            (pt_glm.make_value_and_grad(pb, pl), pt_glm.make_hvp(pb, pl)))


def assert_result_matches(p, j, *, zeros: bool = False):
    pw = p.coefficients.numpy()
    jw = np.asarray(j.coefficients)
    assert int(p.iterations) == int(j.iterations)
    assert int(p.convergence_reason) == int(j.convergence_reason)
    np.testing.assert_allclose(pw, jw, rtol=0, atol=COEF_ATOL)
    assert float(p.value) == pytest.approx(float(j.value), rel=1e-12)
    if zeros:
        np.testing.assert_array_equal(pw == 0.0, jw == 0.0)


# (name, config kwargs, l1, l2, box)
CASES = {
    "tron": (dict(optimizer_type="TRON"), 0.0, 0.5, None),
    "tron_cg_cap": (dict(optimizer_type="TRON", max_cg_iterations=3), 0.0,
                    0.05, None),
    "owlqn_l1": ({}, 20.0, 0.0, None),
    "owlqn_elastic_net": ({}, 30.0, 1.0, None),
    "lbfgsb": ({}, 0.0, 0.1, (-0.15, 0.2)),
}


def configs(kw: dict, box):
    kw = dict(kw)
    kind = kw.pop("optimizer_type", "LBFGS")
    if kind == "TRON":
        return (jax_optim.OptimizerConfig.tron(**kw),
                optim.OptimizerConfig.tron(**kw))
    return (jax_optim.OptimizerConfig.lbfgs(box_constraints=box, **kw),
            optim.OptimizerConfig.lbfgs(box_constraints=box, **kw))


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_dispatch_matches_the_reference(loss, case):
    """``solve`` (the factory dispatch) in both packages: L2 folded in
    with the intercept left out, L1 to OWL-QN, TRON with an hvp, box
    constraints through L-BFGS to L-BFGS-B."""
    kw, l1, l2, box = CASES[case]
    arrays = problem(loss, seed=10 * LOSSES.index(loss)
                     + sorted(CASES).index(case))
    (jf, jh), (pf, ph) = objectives(loss, arrays)
    jcfg, pcfg = configs(kw, box)
    d = arrays[0].shape[1]
    j = jax_optim.solve(jf, jnp.zeros(d), jcfg, l1_weight=l1, l2_weight=l2,
                        intercept_index=d - 1, hvp=jh)
    p = optim.solve(pf, torch.zeros(d, dtype=torch.float64), pcfg,
                    l1_weight=l1, l2_weight=l2, intercept_index=d - 1,
                    hvp=ph)
    assert_result_matches(p, j, zeros=l1 > 0)
    np.testing.assert_allclose(p.loss_history.numpy(),
                               np.asarray(j.loss_history), rtol=1e-12)
    if l1 > 0:
        assert (p.coefficients == 0).any(), "the L1 case should zero some"
    if box is not None:
        assert float(p.coefficients.min()) >= box[0]
        assert float(p.coefficients.max()) <= box[1]
        assert ((p.coefficients == box[0]) | (p.coefficients == box[1])).any()


@pytest.mark.parametrize("loss", LOSSES)
def test_single_solvers_match_the_reference_from_a_warm_start(loss):
    """``tron_solve``, ``owlqn_solve`` and ``lbfgsb_solve`` called
    directly, from a nonzero start (tolerances still from the zero
    state), on the objective with L2 already composed."""
    arrays = problem(loss, seed=7)
    (jf, jh), (pf, ph) = objectives(loss, arrays)
    d = arrays[0].shape[1]
    w0 = np.random.default_rng(3).normal(size=d) * 0.1
    jf2, pf2 = jax_optim.with_l2(jf, 0.3), optim.with_l2(pf, 0.3)
    jh2, ph2 = jax_optim.with_l2_hvp(jh, 0.3), optim.with_l2_hvp(ph, 0.3)
    jw0, pw0 = jnp.asarray(w0), torch.tensor(w0)
    assert_result_matches(
        optim.tron_solve(pf2, ph2, pw0),
        jax_optim.tron_solve(jf2, jh2, jw0))
    assert_result_matches(
        optim.owlqn_solve(pf2, pw0, 1.5), jax_optim.owlqn_solve(jf2, jw0, 1.5),
        zeros=True)
    box = (-0.2, 0.25)
    assert_result_matches(
        optim.lbfgsb_solve(pf2, pw0, optim.OptimizerConfig(
            box_constraints=box)),
        jax_optim.lbfgsb_solve(jf2, jw0, jax_optim.OptimizerConfig(
            box_constraints=box)))


@pytest.mark.parametrize("solver", ["lbfgs", "owlqn", "tron", "lbfgsb"])
def test_a_batch_of_problems_solves_as_each_alone(solver):
    """A stack of 6 logistic problems of different difficulty through
    one batched call: each lane's iterations, reason and coefficients
    equal the reference's solo solve of that problem (the semantics of
    ``jax.vmap`` over the reference's loops)."""
    from photon_tpu_torch.optim import lbfgsb, owlqn, tron

    lanes = [problem("logistic", seed=40 + i, n=60 + 40 * i, d=8)
             for i in range(6)]
    refs, funs, hvps = [], [], []
    for i, arrays in enumerate(lanes):
        (jf, jh), (pf, ph) = objectives("logistic", arrays)
        l2 = 0.01 * (i + 1)
        jf, jh = jax_optim.with_l2(jf, l2), jax_optim.with_l2_hvp(jh, l2)
        funs.append(optim.with_l2(pf, l2))
        hvps.append(optim.with_l2_hvp(ph, l2))
        d = arrays[0].shape[1]
        if solver == "lbfgs":
            refs.append(jax_optim.lbfgs_solve(jf, jnp.zeros(d)))
        elif solver == "owlqn":
            refs.append(jax_optim.owlqn_solve(jf, jnp.zeros(d), 2.0))
        elif solver == "tron":
            refs.append(jax_optim.tron_solve(jf, jh, jnp.zeros(d)))
        else:
            refs.append(jax_optim.lbfgsb_solve(
                jf, jnp.zeros(d),
                jax_optim.OptimizerConfig(box_constraints=(-0.5, 0.5))))

    def fun(w):
        out = [f(w[i]) for i, f in enumerate(funs)]
        return (torch.stack([o[0] for o in out]),
                torch.stack([o[1] for o in out]))

    def hvp(w, v):
        return torch.stack([h(w[i], v[i]) for i, h in enumerate(hvps)])

    w0 = torch.zeros((len(lanes), 8), dtype=torch.float64)
    syncs = batched.host_syncs
    if solver == "lbfgs":
        res = batched.lbfgs(fun, w0)
    elif solver == "owlqn":
        res = owlqn.owlqn(fun, w0, 2.0, optim.OptimizerConfig())
    elif solver == "tron":
        res = tron.tron(fun, w0, optim.OptimizerConfig.tron(), hvp=hvp)
    else:
        res = lbfgsb.lbfgsb(fun, w0, optim.OptimizerConfig(
            box_constraints=(-0.5, 0.5)))
    assert batched.host_syncs > syncs
    iters = [int(r.iterations) for r in refs]
    assert len(set(iters)) > 1, "the lanes should stop at different steps"
    for i, j in enumerate(refs):
        p = optim.OptResult(res.coefficients[i], res.value[i],
                            res.gradient_norm[i], res.iterations[i],
                            res.convergence_reason[i], None)
        assert_result_matches(p, j, zeros=solver == "owlqn")


def test_tron_requires_an_hvp():
    arrays = problem("logistic", seed=1)
    _, (pf, _) = objectives("logistic", arrays)
    with pytest.raises(ValueError, match="Hessian-vector"):
        optim.solve(pf, torch.zeros(12, dtype=torch.float64),
                    optim.OptimizerConfig.tron())


def test_project_box_clips_as_the_reference():
    w = np.linspace(-2, 2, 9)
    box = (-0.5, np.linspace(0.0, 1.0, 9))
    got = optim.project_box(torch.tensor(w), (box[0],
                                              torch.tensor(box[1])))
    want = jax_optim.base.project_box(jnp.asarray(w),
                                      (box[0], jnp.asarray(box[1])))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert optim.project_box(torch.tensor(w), None) is not None
