"""Fused serve score: one kernel launch scores a whole padded rung.

``fused_score`` is the wrapper. On CUDA tensors it checks them and
launches the hand-written CUDA kernel ``csrc/serve_score.cu`` (or
raises); on CPU tensors it runs ``fused_score_reference``, the same
function in plain PyTorch. Nothing falls back from one to the other.

The CUDA kernel replaces the Pallas TPU kernel
``photon_tpu/ops/serve_kernel.py:fused_score``. At rung 512 on the
serving model (d = 64 fixed features, 17 + 9 random slots) a launch
reads about 0.3 MB, ~0.1 us at 3.35 TB/s, so what bounds it is latency:
a row's chain of dependent loads (code, then projector and weight, then
feature). The kernel puts every independent load of a row in flight
together, one lane per (coordinate, slot) pair, so a row waits on three
memory round trips whatever its number of coordinates; one launch
scores a rung for all coordinates together, with no intermediate in
device memory.

Operands follow ``ScorePrograms``: ``feats`` holds one leaf per feature
shard in shard order (dense: [rung, d] f32; ELL: ([rung, k] int32,
[rung, k] f32)); ``fe_ws`` the fixed coordinates' [d] weights, ``re_ws``
and ``re_projs`` the random coordinates' [E, S] tables and int32
projectors (-1 pad), ``codes`` one [rung] int32 entity-code vector per
random coordinate (-1 cold). ``fe_feat``/``re_feat`` name each
coordinate's shard. Tables are all f32 or all bf16; the result is
[rung] f32.
"""

from __future__ import annotations

import ctypes

import torch

from photon_tpu_torch.models.game import _score_raw_dense, _score_raw_sparse
from photon_tpu_torch.ops import _build
from photon_tpu_torch.ops import precision as precision_mod

MAX_COORDS = 8
SOURCE = "photon_tpu_torch/csrc/serve_score.cu"

# Kernel launches made by ``fused_score`` (never by the plain version).
launches = 0


class _Coord(ctypes.Structure):
    """Mirror of ``Coord`` in csrc/serve_score.cu."""

    _fields_ = [
        ("w", ctypes.c_void_p),
        ("proj", ctypes.c_void_p),
        ("codes", ctypes.c_void_p),
        ("x", ctypes.c_void_p),
        ("idx", ctypes.c_void_p),
        ("d", ctypes.c_longlong),
        ("k", ctypes.c_longlong),
        ("s", ctypes.c_longlong),
        ("e", ctypes.c_longlong),
    ]


class _Params(ctypes.Structure):
    """Mirror of ``ServeParams`` in csrc/serve_score.cu."""

    _fields_ = [
        ("c", _Coord * MAX_COORDS),
        ("pair_base", ctypes.c_longlong * MAX_COORDS),
        ("n_coords", ctypes.c_longlong),
        ("n_fixed", ctypes.c_longlong),
        ("n_pairs", ctypes.c_longlong),
        ("rung", ctypes.c_longlong),
        ("out", ctypes.c_void_p),
    ]


_launch_fn = None


def load() -> None:
    """Build (first time only) and bind the kernel library."""
    global _launch_fn
    if _launch_fn is not None:
        return
    lib = _build.library()
    size = lib.photon_serve_params_size
    size.argtypes = []
    size.restype = ctypes.c_longlong
    if size() != ctypes.sizeof(_Params):
        raise RuntimeError(
            f"ServeParams is {size()} bytes in {SOURCE} but "
            f"{ctypes.sizeof(_Params)} in its ctypes mirror"
        )
    fn = lib.photon_serve_score
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _launch_fn = fn


def _first_leaf(feats, spec_kinds) -> torch.Tensor:
    if not feats:
        raise ValueError("fused_score needs at least one feature shard")
    return feats[0] if spec_kinds[0] == "dense" else feats[0][0]


def _fixed_dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return precision_mod.acc_sum(x.to(w.dtype) * w, dim=-1).float()


def _fixed_sparse(
    w: torch.Tensor, idx: torch.Tensor, val: torch.Tensor
) -> torch.Tensor:
    d = w.shape[0]
    inside = (idx >= 0) & (idx < d)
    g = w[idx.long().clamp(0, max(d - 1, 0))]
    g = torch.where(inside, g, torch.zeros_like(g))
    return precision_mod.acc_sum(val.to(w.dtype) * g, dim=-1).float()


def fused_score_reference(
    fe_ws, re_ws, re_projs, feats, codes, *, spec_kinds, fe_feat, re_feat
) -> torch.Tensor:
    """The fused score in plain PyTorch, one coordinate at a time, with
    the kernel's rounding: [rung] f32."""
    total = None
    for w, fi in zip(fe_ws, fe_feat):
        if spec_kinds[fi] == "dense":
            z = _fixed_dense(w, feats[fi])
        else:
            z = _fixed_sparse(w, *feats[fi])
        total = z if total is None else total + z
    for w, proj, fi, c in zip(re_ws, re_projs, re_feat, codes):
        if spec_kinds[fi] == "dense":
            z = _score_raw_dense(w, c, feats[fi], proj)
        else:
            idx, val = feats[fi]
            z = _score_raw_sparse(w, c, idx, val, proj)
        total = z if total is None else total + z
    if total is None:
        raise ValueError("fused_score needs at least one coordinate")
    return total


def fused_score(
    fe_ws, re_ws, re_projs, feats, codes, *, spec_kinds, fe_feat, re_feat
) -> torch.Tensor:
    """Score one padded rung: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    dev = _first_leaf(feats, spec_kinds).device
    if dev.type == "cpu":
        return fused_score_reference(
            fe_ws, re_ws, re_projs, feats, codes,
            spec_kinds=spec_kinds, fe_feat=fe_feat, re_feat=re_feat,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_score: unsupported device {dev}")
    return _launch(
        fe_ws, re_ws, re_projs, feats, codes,
        spec_kinds=spec_kinds, fe_feat=fe_feat, re_feat=re_feat,
    )


def _check(t: torch.Tensor, what: str, dev, dtypes, ndim: int) -> None:
    if t.device != dev:
        raise ValueError(f"{what} is on {t.device}, expected {dev}")
    if t.dtype not in dtypes:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


def _launch(
    fe_ws, re_ws, re_projs, feats, codes, *, spec_kinds, fe_feat, re_feat
) -> torch.Tensor:
    global launches
    n_coords = len(fe_ws) + len(re_ws)
    if not 1 <= n_coords <= MAX_COORDS:
        raise ValueError(
            f"the serve kernel takes 1..{MAX_COORDS} coordinates, got "
            f"{n_coords}")
    if len(re_projs) != len(re_ws) or len(codes) != len(re_ws):
        raise ValueError("one projector and one code vector per random "
                         "coordinate")
    leaf = _first_leaf(feats, spec_kinds)
    dev = leaf.device
    rung = int(leaf.shape[0])
    wdtype = (fe_ws or re_ws)[0].dtype
    if wdtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tables must be float32 or bfloat16, not {wdtype}")
    f32, i32 = (torch.float32,), (torch.int32,)

    shard_ptrs = []
    for si, kind in enumerate(spec_kinds):
        if kind == "dense":
            x = feats[si]
            _check(x, f"dense shard {si}", dev, f32, 2)
            if x.shape[0] != rung:
                raise ValueError(f"dense shard {si} has {x.shape[0]} rows, "
                                 f"expected {rung}")
            shard_ptrs.append((x.data_ptr(), None, int(x.shape[1]), 0))
        else:
            idx, val = feats[si]
            _check(idx, f"ELL ids of shard {si}", dev, i32, 2)
            _check(val, f"ELL values of shard {si}", dev, f32, 2)
            if idx.shape != val.shape or idx.shape[0] != rung:
                raise ValueError(f"ELL shard {si}: ids {tuple(idx.shape)} "
                                 f"and values {tuple(val.shape)} must both "
                                 f"be [{rung}, k]")
            shard_ptrs.append(
                (val.data_ptr(), idx.data_ptr(), None, int(idx.shape[1]))
            )

    params = _Params()
    params.n_coords = n_coords
    params.n_fixed = len(fe_ws)
    params.rung = rung
    ci = 0
    for w, fi in zip(fe_ws, fe_feat):
        _check(w, f"fixed weights {ci}", dev, (wdtype,), 1)
        x_ptr, idx_ptr, width, k = shard_ptrs[fi]
        d = int(w.shape[0])
        if width is not None and width != d:
            raise ValueError(f"fixed weights {ci} have {d} entries but "
                             f"shard {fi} is {width} wide")
        c = params.c[ci]
        c.w, c.x, c.idx, c.d, c.k = w.data_ptr(), x_ptr, idx_ptr, d, k
        ci += 1
    for ri, (w, proj, fi, code) in enumerate(
        zip(re_ws, re_projs, re_feat, codes)
    ):
        _check(w, f"random table {ri}", dev, (wdtype,), 2)
        _check(proj, f"projector {ri}", dev, i32, 2)
        _check(code, f"codes {ri}", dev, i32, 1)
        if proj.shape != w.shape or w.shape[0] < 1:
            raise ValueError(f"random table {ri} {tuple(w.shape)} and its "
                             f"projector {tuple(proj.shape)} must be one "
                             "non-empty [E, S] shape")
        if code.shape[0] != rung:
            raise ValueError(f"codes {ri} have {code.shape[0]} rows, "
                             f"expected {rung}")
        x_ptr, idx_ptr, width, k = shard_ptrs[fi]
        c = params.c[ci]
        c.w, c.proj, c.codes = w.data_ptr(), proj.data_ptr(), code.data_ptr()
        c.x, c.idx, c.k = x_ptr, idx_ptr, k
        c.d = 0 if width is None else width
        c.e, c.s = int(w.shape[0]), int(w.shape[1])
        params.pair_base[ri] = params.n_pairs
        params.n_pairs += c.s
        ci += 1
    for ri in range(len(re_ws), MAX_COORDS):
        params.pair_base[ri] = params.n_pairs  # no pair reaches it

    load()
    out = torch.empty(rung, dtype=torch.float32, device=dev)
    params.out = out.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launch_fn(
        ctypes.byref(params), int(wdtype == torch.bfloat16), stream
    )
    if rc != 0:
        raise RuntimeError(f"serve_score launch failed with CUDA error {rc}")
    launches += 1
    return out
