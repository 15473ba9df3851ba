"""One damped Newton/IRLS step for a bucket of per-entity GLM problems.

``newton_step`` is the wrapper. On CUDA tensors it checks them and
launches the hand-written CUDA kernel ``csrc/newton_step.cu`` (or
raises); on CPU tensors it runs ``newton_step_plain``, the same step in
plain PyTorch. Nothing falls back from one to the other.

The CUDA kernel replaces the Pallas TPU kernel
``photon_tpu/ops/newton_kernel.py:newton_step_lanes``. It takes the
bucket as x [B, R, S] (entity-major, the port's natural layout); the TPU
kernel's 128-lane entity transpose is not carried over. Up to
``NARROW_SUB_DIM`` slots one warp per entity stages its slab in shared
memory and forms H there; it is bound by bytes: at the bench's user
bucket (~100,000 entities x 64 rows x 17 slots, f32) one step must read
the 435 MB slab once, ~0.16 ms at 3.35 TB/s. A wider bucket (a wide
materialized bucket densified for its solve) takes one block per entity
and a CG that applies H from the slab without forming it; it is bound
by operations.

``kernel_supported`` is the reference's gate: f32, logistic or Poisson
loss, R * S <= 16384.
"""

from __future__ import annotations

import ctypes

import torch

from photon_tpu_torch.ops import _build
from photon_tpu_torch.ops import losses as losses_mod
from photon_tpu_torch.types import TaskType

SOURCE = "photon_tpu_torch/csrc/newton_step.cu"
REPLACES = "photon_tpu/ops/newton_kernel.py:225"
MAX_RS = 16_384
NARROW_SUB_DIM = 128  # the widest S of the one-warp-per-entity design
MAX_TRIALS = 16
_TASK_CODE = {TaskType.LOGISTIC_REGRESSION: 0, TaskType.POISSON_REGRESSION: 1}

# Kernel launches made by ``newton_step`` (never by the plain version),
# and those of them on a bucket wider than NARROW_SUB_DIM.
launches = 0
wide_launches = 0

_launch_fn = None
_workspace_fn = None


def kernel_supported(task: TaskType, dtype: torch.dtype, r: int,
                     s: int) -> bool:
    """Whether a bucket takes the Newton-step route (kernel on CUDA,
    plain version on the CPU) rather than the batch-minor plain loop."""
    return dtype == torch.float32 and task in _TASK_CODE and r * s <= MAX_RS


def load() -> None:
    """Build (first time only) and bind the kernel library."""
    global _launch_fn, _workspace_fn
    if _launch_fn is not None:
        return
    lib = _build.library()
    fn = lib.photon_newton_step
    fn.argtypes = [ctypes.c_void_p] * 13 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    ws = lib.photon_newton_step_workspace_floats
    ws.argtypes = [ctypes.c_int, ctypes.c_int]
    ws.restype = ctypes.c_longlong
    _launch_fn, _workspace_fn = fn, ws


def _loss_terms(task: TaskType, z: torch.Tensor, y: torch.Tensor):
    """(loss, dz, dzz) as the TPU kernel's ``_loss_terms`` writes them;
    Poisson takes the clamped objective of ``ops/losses.py``."""
    if task == TaskType.LOGISTIC_REGRESSION:
        ind = (y > 0.5).to(z.dtype)
        p = 1.0 / (1.0 + torch.exp(-z))
        loss = torch.log1p(torch.exp(-z.abs())) + z.clamp(min=0.0) - z * ind
        return loss, p - ind, p * (1.0 - p)
    zc = z.clamp(max=losses_mod.POISSON_MAX_MARGIN)
    ez = torch.exp(zc)
    return ez - y * zc, ez - y, ez


def newton_step_plain(x, w, y, wt, off, l2, mt, vm, f, *, task: TaskType,
                      trials: int = MAX_TRIALS):
    """The kernel's step in plain PyTorch on [B, R, S]. Returns
    (w_new [B, S], f_new [B], g_new [B, S], improved [B] bool)."""
    s = x.shape[-1]
    z = torch.einsum("brs,bs->br", x, w) + off
    _, dz0, dzz0 = _loss_terms(task, z, y)
    h = torch.einsum("brs,brt->bst", x * (wt * dzz0)[:, :, None], x)
    h = h + torch.diag_embed(l2 + (1.0 - vm))
    g = (torch.einsum("brs,br->bs", x, wt * dz0) + l2 * (w - mt)) * vm

    xx = torch.zeros_like(g)
    rr = -g
    pp = rr
    rs = torch.sum(rr * rr, dim=-1)
    for _ in range(s):
        hp = torch.einsum("bst,bt->bs", h, pp)
        alpha = rs / torch.sum(pp * hp, dim=-1).clamp(min=1e-30)
        xx = xx + alpha[:, None] * pp
        rr = rr - alpha[:, None] * hp
        rs2 = torch.sum(rr * rr, dim=-1)
        pp = rr + (rs2 / rs.clamp(min=1e-30))[:, None] * pp
        rs = rs2
    d = xx * vm
    gd = torch.sum(g * d, dim=-1)
    bad = gd >= 0.0
    d = torch.where(bad[:, None], -g, d)
    gd = torch.where(bad, -torch.sum(g * g, dim=-1), gd)

    zd = torch.einsum("brs,bs->br", x, d)
    ts = 0.5 ** torch.arange(trials, dtype=x.dtype, device=x.device)
    loss_t, _, _ = _loss_terms(task, z[None] + ts[:, None, None] * zd[None],
                               y[None])
    w_t = w[None] + ts[:, None, None] * d[None]
    f_t = torch.sum(wt[None] * loss_t, dim=-1) + 0.5 * torch.sum(
        l2[None] * (w_t - mt[None]) ** 2, dim=-1)  # [T, B]
    armijo = f_t <= f[None] + 1e-4 * ts[:, None] * gd[None]
    any_ok = armijo.any(dim=0)
    first = torch.argmax(armijo.to(torch.int8), dim=0)
    t_sel = ts[first]
    f_sel = torch.gather(f_t, 0, first[None])[0]
    improved = any_ok & (f_sel < f)
    w_new = torch.where(improved[:, None], w + t_sel[:, None] * d, w)

    z2 = torch.einsum("brs,bs->br", x, w_new) + off
    loss2, dz2, _ = _loss_terms(task, z2, y)
    f_new = torch.sum(wt * loss2, dim=-1) + 0.5 * torch.sum(
        l2 * (w_new - mt) ** 2, dim=-1)
    g_new = (torch.einsum("brs,br->bs", x, wt * dz2)
             + l2 * (w_new - mt)) * vm
    return w_new, f_new, g_new, improved


def newton_step(x, w, y, wt, off, l2, mt, vm, f, *, task: TaskType,
                trials: int = MAX_TRIALS):
    """One Newton step: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return newton_step_plain(x, w, y, wt, off, l2, mt, vm, f, task=task,
                                 trials=trials)
    if x.device.type != "cuda":
        raise ValueError(f"newton_step: unsupported device {x.device}")
    return _launch(x, w, y, wt, off, l2, mt, vm, f, task=task, trials=trials)


def _launch(x, w, y, wt, off, l2, mt, vm, f, *, task, trials):
    global launches, wide_launches
    if task not in _TASK_CODE:
        raise ValueError(f"the Newton kernel takes logistic or Poisson loss, "
                         f"not {task}")
    if x.dim() != 3:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected [B, R, S]")
    b, r, s = (int(v) for v in x.shape)
    if b < 1 or r * s > MAX_RS:
        raise ValueError(f"the Newton kernel takes 1 <= B and R * S <= "
                         f"{MAX_RS}; got [{b}, {r}, {s}]")
    if not 1 <= trials <= MAX_TRIALS:
        raise ValueError(f"trials must be in [1, {MAX_TRIALS}], got {trials}")
    dev = x.device
    for name, t, shape in (
        ("x", x, (b, r, s)), ("w", w, (b, s)), ("y", y, (b, r)),
        ("wt", wt, (b, r)), ("off", off, (b, r)), ("l2", l2, (b, s)),
        ("mt", mt, (b, s)), ("vm", vm, (b, s)), ("f", f, (b,)),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    load()
    w_out = torch.empty((b, s), dtype=torch.float32, device=dev)
    g_out = torch.empty((b, s), dtype=torch.float32, device=dev)
    f_out = torch.empty(b, dtype=torch.float32, device=dev)
    imp = torch.empty(b, dtype=torch.bool, device=dev)
    # A wide bucket whose S vectors do not fit in shared memory keeps
    # them in global memory.
    ws_floats = int(_workspace_fn(r, s))
    ws = (torch.empty(b * ws_floats, dtype=torch.float32, device=dev)
          if ws_floats else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launch_fn(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), wt.data_ptr(),
        off.data_ptr(), l2.data_ptr(), mt.data_ptr(), vm.data_ptr(),
        f.data_ptr(), w_out.data_ptr(), f_out.data_ptr(), g_out.data_ptr(),
        imp.data_ptr(), b, r, s, _TASK_CODE[task], trials,
        None if ws is None else ws.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"newton_step launch failed with CUDA error {rc}")
    launches += 1
    if s > NARROW_SUB_DIM:
        wide_launches += 1
    return w_out, f_out, g_out, imp
