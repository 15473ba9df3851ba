"""The port's training kernels and their plain versions against the JAX
package's.

The same numpy inputs, made from a seed, go through both packages. The
JAX side runs its Pallas Newton-step body in interpret mode (the TPU
kernel as written); on the CPU the port runs ``newton_step_plain``, the
CUDA kernel's plain PyTorch version.

Tolerances:
- losses: f64 to 1e-12 (the same formulas; the reference writes the
  logistic loss as ``softplus(z) - 1[y > 0.5] z``, the port as
  ``log1p(exp(-|z|)) + max(z, 0) - 1[y > 0.5] z``), f32 to 2 ulp-scale
  (rtol 1e-6, atol 1e-6);
- Newton steps: w and f rtol 1e-4 / atol 5e-5, g rtol 5e-4 /
  atol 2e-4, tighter on every count than the reference's own
  kernel-vs-XLA gate (2e-3/2e-4 for w and f, 5e-3/5e-4 for g,
  tests/test_newton_kernel.py). Both sides are f32 and differ only in
  the order of the sums in the Hessian, gradient and CG. ``improved``
  must agree. An entity whose objective moved by no more than f32
  round-off on both sides is near its optimum, where the order of the
  sums decides whether a step is taken and which trial passes; such
  entities are counted and left out (none on a first step);
- a whole ``RandomEffectCoordinate.train`` at solver tolerance 1e-4:
  in float64 (both packages on their batch-minor loops, the reference's
  kernel being f32-only) iteration counts and reasons exactly and
  coefficients to rtol 1e-9 / atol 1e-11; in f32 (the reference forced
  onto its Pallas kernel, the port on its kernel route) each side's
  coefficients within ``RE_FIT_ATOL`` = 2e-3 of the float64 solution,
  and its scores within that times the row's sum of |x|. An f32 solve
  stops where its objective F no longer resolves an improvement, and
  whether its last step is taken is decided by the rounding of the sums,
  whose order differs between the packages and between machines; the
  solve still ends within F - F* <= 4 u F of the optimum (u = 2**-24),
  so with curvature at least h a coefficient is at most
  sqrt(2 * 4 u F / h) from float64: F ~ 0.6 R and h ~ 0.2 R + l2 for R
  rows gives sqrt(24 u) ~ 1.2e-3, held at twice that, as ``chip_smoke.py``
  holds a trained fit's random effects. At the default tolerance 1e-7
  the two sides stop one iteration apart or for another reason on about
  a third of the entities even where no step is on that boundary.

The tests marked ``cuda`` hold the CUDA kernel against its plain version
and need a GPU; they skip on a machine without one. JAX is imported
where it is used, so those tests also run where JAX is not installed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_tpu_torch.ops import losses as pt_losses
from photon_tpu_torch.ops import newton_kernel as nk
from photon_tpu_torch.types import TaskType

TRIALS = nk.MAX_TRIALS
# An f32 coordinate against its float64 solution (module docstring).
RE_FIT_ATOL = 2e-3
TASK_NAMES = {"logistic": TaskType.LOGISTIC_REGRESSION,
              "poisson": TaskType.POISSON_REGRESSION}


def _jax_task(task: TaskType):
    from photon_tpu.types import TaskType as JaxTask

    return JaxTask[task.name]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _loss_inputs(family: str, rng):
    z = np.concatenate([rng.normal(size=200) * 4.0,
                        [-500.0, -40.0, -1e-3, 0.0, 1e-3, 29.0, 31.0, 40.0,
                         500.0]])
    if family == "poisson":
        y = rng.poisson(2.0, size=z.shape).astype(np.float64)
    elif family == "logistic":
        # {0, 1} and {-1, 1} labels alike: anything above 0.5 is positive.
        y = rng.choice([-1.0, 0.0, 1.0], size=z.shape)
    elif family == "squared":
        y = rng.normal(size=z.shape)
    else:
        y = rng.choice([0.0, 1.0], size=z.shape)
    return z, y


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("family",
                         ["logistic", "squared", "poisson", "smoothed_hinge"])
def test_losses_match_reference_elementwise(family, dtype, rng):
    import jax.numpy as jnp

    from photon_tpu.ops import losses as jax_losses

    z, y = _loss_inputs(family, rng)
    z, y = z.astype(dtype), y.astype(dtype)
    jl, pl = jax_losses.get_loss(family), pt_losses.get_loss(family)
    tol = (dict(rtol=1e-12, atol=1e-12) if dtype == "float64"
           else dict(rtol=1e-6, atol=1e-6))
    for part in ("loss", "dz", "dzz"):
        want = np.asarray(getattr(jl, part)(jnp.asarray(z), jnp.asarray(y)))
        got = getattr(pl, part)(torch.from_numpy(z),
                                torch.from_numpy(y)).numpy()
        assert got.dtype == np.dtype(dtype), part
        assert np.isfinite(got).all(), part
        np.testing.assert_allclose(got, want, err_msg=part, **tol)
    np.testing.assert_allclose(
        pl.mean(torch.from_numpy(z)).numpy(),
        np.asarray(jl.mean(jnp.asarray(z))), **tol)
    assert pt_losses.get_loss(TaskType.POISSON_REGRESSION).name == "poisson"


def test_unknown_loss_name_raises():
    with pytest.raises(ValueError, match="Unknown loss"):
        pt_losses.get_loss("hinge")


# ---------------------------------------------------------------------------
# one Newton step
# ---------------------------------------------------------------------------


def step_inputs(task: TaskType, b: int, r: int, s: int, seed: int,
                labels: str = "01"):
    """Port-layout f32 operands of one Newton step for ``b`` entities.

    Entity 0 is padding (all zeros, the reference's lane padding);
    entity 1 has its last slot masked off (``vm`` 0, zero column);
    entity 2 has rows that all carry weight 0 and sits at its prior
    mean, so its gradient is exactly 0: CG returns d = 0, g.d = 0 is not
    a descent, and the step takes the -g fallback (which does not move
    it); the rest are ordinary entities, some with padding rows
    (weight 0)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, r, s)).astype(np.float32)
    w = (rng.normal(size=(b, s)) * 0.1).astype(np.float32)
    if task == TaskType.POISSON_REGRESSION:
        y = rng.poisson(1.0, size=(b, r)).astype(np.float32)
        # Margins of order one at any width: far below the clamp at 30,
        # and a curvature e^z that keeps H well conditioned in f32.
        x *= 0.5 * min(1.0, np.sqrt(128.0 / s))
    elif labels == "pm1":
        y = np.where(rng.random((b, r)) > 0.5, 1.0, -1.0).astype(np.float32)
    else:
        y = (rng.random((b, r)) > 0.5).astype(np.float32)
    wt = (rng.random((b, r)) + 0.5).astype(np.float32)
    wt[3:, r - r // 4:] = 0.0  # padding rows
    off = (rng.normal(size=(b, r)) * 0.1).astype(np.float32)
    l2 = np.ones((b, s), np.float32)
    mt = (rng.normal(size=(b, s)) * 0.05).astype(np.float32)
    vm = np.ones((b, s), np.float32)
    for a in (x, w, y, wt, off, l2, mt, vm):
        a[0] = 0.0
    vm[1, -1] = 0.0
    x[1, :, -1] = 0.0
    wt[2] = 0.0
    mt[2] = w[2]
    loss = pt_losses.get_loss(task)
    z = torch.from_numpy(np.einsum("brs,bs->br", x, w) + off)
    f = ((wt * loss.loss(z, torch.from_numpy(y)).numpy()).sum(-1)
         + 0.5 * (l2 * (w - mt) ** 2).sum(-1)).astype(np.float32)
    return dict(x=x, w=w, y=y, wt=wt, off=off, l2=l2, mt=mt, vm=vm, f=f)


def pallas_step(ops: dict, task: TaskType):
    """The reference's Pallas body (interpret mode) on port-layout
    operands; returns (w [B, S], f [B], g [B, S], improved [B])."""
    import jax.numpy as jnp

    from photon_tpu.ops import newton_kernel as jax_nk

    b, r, s = ops["x"].shape
    bp = jax_nk.pad_lanes(b)

    def lanes(a):
        """[B, ...] -> [..., Bp] reversed, entities in lanes: x [S, R, Bp],
        the rest [S or R or 1, Bp]."""
        p = np.zeros((bp,) + a.shape[1:], np.float32)
        p[:b] = a
        return jnp.asarray(np.transpose(p, tuple(range(a.ndim))[::-1]))

    out = jax_nk.newton_step_lanes(
        lanes(ops["x"]), lanes(ops["w"]), lanes(ops["y"]), lanes(ops["wt"]),
        lanes(ops["off"]), lanes(ops["l2"]), lanes(ops["mt"]),
        lanes(ops["vm"]), lanes(ops["f"][:, None]),
        r=r, s=s, task=_jax_task(task), trials=TRIALS, interpret=True)
    w_k, f_k, g_k, imp_k = (np.asarray(o) for o in out)
    return w_k.T[:b], f_k[0, :b], g_k.T[:b], imp_k[0, :b] > 0


def port_step(ops: dict, task: TaskType, device="cpu", fn=None):
    fn = fn or nk.newton_step
    t = {k: torch.from_numpy(v).to(device) for k, v in ops.items()}
    out = fn(t["x"], t["w"], t["y"], t["wt"], t["off"], t["l2"], t["mt"],
             t["vm"], t["f"], task=task, trials=TRIALS)
    return tuple(o.cpu().numpy() for o in out)


def at_round_off(f_new, f_prev):
    """Entities whose step changed the objective by no more than f32
    round-off of its value: there, ``improved`` is decided by the order
    of the sums and either answer is right."""
    return np.abs(f_new - f_prev) <= 1e-6 * (np.abs(f_prev) + 1.0)


def assert_steps_close(got, want, f_prev):
    """One step from the same state on both sides. An entity whose
    objective moved only by round-off on both sides is near its optimum:
    the order of the sums decides whether a step is taken and which
    trial passes, so it is left out of the checks. Elsewhere
    ``improved`` must agree and the values must be close. Returns how
    many entities were left out."""
    w, f, g, imp = got
    imp = imp.astype(bool)
    tie = at_round_off(f, f_prev) & at_round_off(want[1], f_prev)
    np.testing.assert_array_equal(imp[~tie], want[3][~tie])
    keep = ~tie
    np.testing.assert_allclose(w[keep], want[0][keep], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(f[keep], want[1][keep], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(g[keep], want[2][keep], rtol=5e-4, atol=2e-4)
    return int(tie.sum())


@pytest.mark.parametrize("task,labels", [
    (TaskType.LOGISTIC_REGRESSION, "01"),
    (TaskType.LOGISTIC_REGRESSION, "pm1"),
    (TaskType.POISSON_REGRESSION, "counts"),
], ids=["logistic", "logistic-pm1", "poisson"])
def test_plain_step_matches_pallas_body(task, labels):
    ops = step_inputs(task, b=37, r=8, s=5, seed=3, labels=labels)
    before = nk.launches
    # Three steps of the solver's trajectory; each starts both sides
    # from the reference's iterate.
    for k in range(3):
        got = port_step(ops, task)
        want = pallas_step(ops, task)
        ties = assert_steps_close(got, want, ops["f"])
        if k == 0:
            assert ties == 2  # the two entities that cannot move
            # The padding entity and the zero-gradient entity never
            # move and never count as improved; the masked slot keeps a
            # zero gradient.
            for i in (0, 2):
                assert not got[3][i] and np.all(got[0][i] == ops["w"][i])
                assert np.all(got[2][i] == 0.0)
            assert got[2][1, -1] == 0.0
        ops = dict(ops, w=want[0], f=want[1])
    assert nk.launches == before  # the CPU path launches no kernel


def test_plain_step_matches_pallas_body_at_the_bench_bucket_shape():
    task = TaskType.LOGISTIC_REGRESSION
    ops = step_inputs(task, b=9, r=64, s=17, seed=5)
    ties = assert_steps_close(port_step(ops, task), pallas_step(ops, task),
                              ops["f"])
    assert ties == 2  # the padding and the zero-gradient entity


# (B, R, S) at the edges of the CUDA kernel's narrow design that the
# reference's Pallas body traces in a few seconds: S at and past a quad
# of slots (4, 5; 8, 9; 16), R past one row per lane (40) and past the
# first port's one-lane row sums (300).
PALLAS_EDGE_SHAPES = [(6, 8, 4), (6, 8, 5), (6, 40, 8), (6, 40, 9),
                      (5, 12, 16), (5, 300, 3)]


@pytest.mark.parametrize("shape", PALLAS_EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_step_matches_pallas_body_at_edge_shapes(shape):
    """The plain version against the reference's Pallas body, three
    steps of the trajectory, tolerances as ``assert_steps_close``."""
    task = TaskType.LOGISTIC_REGRESSION
    b, r, s = shape
    ops = step_inputs(task, b=b, r=r, s=s, seed=b + r + s)
    for k in range(3):
        got = port_step(ops, task)
        want = pallas_step(ops, task)
        ties = assert_steps_close(got, want, ops["f"])
        assert k > 0 or ties == 2  # the padding and zero-gradient entity
        ops = dict(ops, w=want[0], f=want[1])


def test_kernel_supported_is_the_reference_gate():
    lr, po = TaskType.LOGISTIC_REGRESSION, TaskType.POISSON_REGRESSION
    assert nk.kernel_supported(lr, torch.float32, 64, 17)
    assert nk.kernel_supported(po, torch.float32, 1024, 16)
    assert not nk.kernel_supported(lr, torch.float32, 1024, 17)
    assert not nk.kernel_supported(lr, torch.float64, 64, 17)
    assert not nk.kernel_supported(lr, torch.bfloat16, 64, 17)
    assert not nk.kernel_supported(TaskType.LINEAR_REGRESSION, torch.float32,
                                   64, 17)


def test_wrapper_launch_raises_without_nvcc_and_counts_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine can build the kernel")
    ops = step_inputs(TaskType.LOGISTIC_REGRESSION, b=4, r=8, s=3, seed=1)
    before = nk.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        port_step(ops, TaskType.LOGISTIC_REGRESSION, fn=nk._launch)
    assert nk.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "task", "trials"])
def test_wrapper_launch_checks_its_operands(bad):
    task = TaskType.LOGISTIC_REGRESSION
    ops = step_inputs(task, b=4, r=8, s=3, seed=1)
    kw = {"task": task, "trials": TRIALS}
    if bad == "shape":
        ops["w"] = ops["w"][:, :2].copy()
    elif bad == "dtype":
        ops["y"] = ops["y"].astype(np.float64)
    elif bad == "task":
        kw["task"] = TaskType.LINEAR_REGRESSION
    else:
        kw["trials"] = TRIALS + 1
    t = {k: torch.from_numpy(v) for k, v in ops.items()}
    with pytest.raises(ValueError):
        nk._launch(t["x"], t["w"], t["y"], t["wt"], t["off"], t["l2"],
                   t["mt"], t["vm"], t["f"], **kw)


# ---------------------------------------------------------------------------
# a whole random-effect coordinate
# ---------------------------------------------------------------------------


def _coordinate_data(task: str, seed: int = 9):
    rng = np.random.default_rng(seed)
    n, du, n_users = 1500, 4, 40
    xu = rng.normal(size=(n, du))
    xu[:, -1] = 1.0
    users = np.minimum(rng.zipf(1.5, size=n) - 1, n_users - 1)
    z = np.einsum("nd,nd->n", xu,
                  rng.normal(size=(n_users, du))[users] * 0.4)
    if task == "logistic":
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(float)
    else:
        y = rng.poisson(np.exp(0.5 * z)).astype(float)
    offsets = rng.normal(size=n) * 0.2
    return xu, users, y, offsets


@pytest.mark.parametrize("task", ["logistic", "poisson"])
def test_random_effect_train_f32_matches_reference_kernel_route(
        task, monkeypatch):
    import jax
    import jax.numpy as jnp

    from photon_tpu import optim as jax_optim
    from photon_tpu.algorithm import random_effect as jax_re_alg
    from photon_tpu.algorithm.problems import (
        GLMOptimizationConfiguration as JaxGLMConfig,
    )
    from photon_tpu.data import dataset as jax_dataset
    from photon_tpu.data import game_data as jax_game_data
    from photon_tpu.data import random_effect as jax_re
    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm import random_effect as pt_re_alg
    from photon_tpu_torch.algorithm.problems import (
        GLMOptimizationConfiguration,
    )
    from photon_tpu_torch.data import dataset as pt_dataset
    from photon_tpu_torch.data import game_data as pt_game_data
    from photon_tpu_torch.data import random_effect as pt_re

    xu, users, y, offsets = _coordinate_data(task)
    du = xu.shape[1]
    # Entities under 6 rows stay passive: with every label alike their
    # unpenalized intercept runs off to infinity, and where it stops is
    # round-off.
    cfg = dict(random_effect_type="userId", feature_shard_id="userShard",
               active_data_upper_bound=48, active_data_lower_bound=6,
               min_bucket_entities=3)
    jtask, ptask = _jax_task(TASK_NAMES[task]), TASK_NAMES[task]
    residuals = np.random.default_rng(1).normal(size=y.shape[0]) * 0.1

    def coordinates(jdtype, pdtype):
        # The f32 data rounded once, so that both precisions solve the
        # same problem.
        xr, yr, offr, resr = (np.asarray(a, np.float32).astype(np.float64)
                              for a in (xu, y, offsets, residuals))
        jdata = jax_game_data.make_game_dataset(
            yr, {"userShard": jax_dataset.DenseFeatures(xr)}, offsets=offr,
            id_tags={"userId": users}, dtype=jdtype)
        pdata = pt_game_data.make_game_dataset(
            yr, {"userShard": pt_dataset.DenseFeatures(xr)}, offsets=offr,
            id_tags={"userId": users}, dtype=pdtype, device="cpu")
        jds = jax_re.build_random_effect_dataset(
            jdata, jax_re.RandomEffectDataConfiguration(**cfg),
            intercept_index=du - 1)
        pds = pt_re.build_random_effect_dataset(
            pdata, pt_re.RandomEffectDataConfiguration(**cfg),
            intercept_index=du - 1)
        assert len(pds.blocks) >= 2
        jcoord = jax_re_alg.RandomEffectCoordinate(
            jds, jtask, JaxGLMConfig(
                regularization=jax_optim.RegularizationContext(
                    jax_optim.RegularizationType.L2),
                regularization_weight=0.7,
                optimizer=jax_optim.OptimizerConfig(tolerance=1e-4)))
        pcoord = pt_re_alg.RandomEffectCoordinate(
            pds, ptask, GLMOptimizationConfiguration(
                regularization=optim.RegularizationContext(
                    optim.RegularizationType.L2),
                regularization_weight=0.7,
                optimizer=optim.OptimizerConfig(tolerance=1e-4)))
        jmodel, jstats = jcoord.train(jnp.asarray(resr, jdtype))
        pmodel, pstats = pcoord.train(torch.tensor(resr, dtype=pdtype))
        return (jcoord, jmodel, jstats), (pcoord, pmodel, pstats)

    # float64: the same trajectory to the same coefficients.
    (_, jmodel64, jstats64), (pcoord64, pmodel64, pstats64) = coordinates(
        jnp.float64, torch.float64)
    w64 = pmodel64.coefficients.numpy()
    np.testing.assert_allclose(w64, np.asarray(jmodel64.coefficients),
                               rtol=1e-9, atol=1e-11)
    jreasons, jiters = jstats64._materialize()
    np.testing.assert_array_equal(pstats64.iterations, jiters)
    np.testing.assert_array_equal(pstats64.reasons, jreasons)
    assert pstats64.iterations.max() >= 2
    z64 = pcoord64.score(pmodel64).numpy()

    # f32 on the kernel routes. Only the reference reads the flag: it runs
    # its Pallas kernel (interpreted on the CPU). Its traces are cleared
    # so that no program compiled without the flag is reused.
    monkeypatch.setenv("PHOTON_NEWTON_KERNEL", "force")
    jax.clear_caches()
    plain_before = pt_re_alg.plain_route_solves
    (jcoord, jmodel, _), (pcoord, pmodel, pstats) = coordinates(
        jnp.float32, torch.float32)
    # Every bucket took the Newton-step route, as the reference's did.
    assert pt_re_alg.plain_route_solves == plain_before
    assert pstats.iterations.max() >= 2
    row_l1 = float(np.abs(np.asarray(xu, np.float32)).sum(axis=1).max())
    for what, w, z in (
            ("port", pmodel.coefficients.numpy(), pcoord.score(pmodel).numpy()),
            ("reference", np.asarray(jmodel.coefficients),
             np.asarray(jcoord.score(jmodel)))):
        np.testing.assert_allclose(w, w64, rtol=0, atol=RE_FIT_ATOL,
                                   err_msg=what)
        np.testing.assert_allclose(z, z64, rtol=0,
                                   atol=RE_FIT_ATOL * row_l1, err_msg=what)


# ---------------------------------------------------------------------------
# the CUDA kernel (needs a GPU)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# (B, R, S): tiny, the bench's user and movie buckets, the edges of the
# gate (one slot with the most rows; the widest one-warp subspace), and
# the wide design: a densified wide bucket, the narrowest wide S, and a
# subspace whose S vectors live in the global workspace. Then the edges
# of the designs: S at and past a quad (4, 5) and the register-H limit
# (31, 32, 33), the narrow limit (127, 128, 129), R above 256 with H in
# registers and in shared memory, the wide tile's limits (S 256 and 257,
# R 64 and 65, S > 256 with few rows), and buckets far larger than the
# warps (narrow) and blocks (wide) the card holds at once, so that each
# walks over many entities.
CUDA_SHAPES = [(5, 3, 2), (300, 64, 17), (200, 256, 9), (40, 1024, 9),
               (8, 16384, 1), (6, 128, 128), (40, 64, 193), (12, 127, 129),
               (4, 2, 6000),
               (7, 40, 4), (7, 40, 5), (33, 64, 31), (33, 64, 32),
               (33, 64, 33), (10, 128, 127), (20, 512, 32), (10, 300, 33),
               (16, 64, 256), (8, 63, 257), (8, 65, 200), (6, 16, 1000),
               (30_000, 64, 17), (2_000, 64, 173)]


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["logistic", "poisson"])
@pytest.mark.parametrize("shape", CUDA_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_matches_plain_version(cuda_device, shape, task):
    t = TASK_NAMES[task]
    b, r, s = shape
    ops = step_inputs(t, b=b, r=r, s=s, seed=b + r + s)
    before = nk.launches
    for k in range(3):
        got = port_step(ops, t, device=cuda_device)
        torch.cuda.synchronize()
        want = port_step(ops, t, device=cuda_device,
                         fn=nk.newton_step_plain)
        ties = assert_steps_close(got, want, ops["f"])
        # Stationary on the first step: the padding and zero-gradient
        # entities, and at S = 1 also entity 1, whose only slot is masked.
        assert k > 0 or ties == (3 if s == 1 else 2)
        ops = dict(ops, w=want[0], f=want[1])
    assert nk.launches == before + 3
    if s > nk.NARROW_SUB_DIM:
        assert nk.wide_launches >= 3
