"""Segment sums over sorted ids, and the four reduces built on them
(port of ``photon_tpu/ops/segment_reduce.py``).

``segment_sum`` is the kernel's wrapper. On CUDA tensors it checks them
and launches the hand-written CUDA kernel ``csrc/segment_sum.cu`` (or
raises); on CPU tensors it runs ``sorted_segment_sum_plain``, the same
sum in plain PyTorch. Nothing falls back from one to the other.

The CUDA kernel replaces the Pallas TPU kernel
``photon_tpu/ops/segment_reduce.py:_windowed_sum``: an f32 sum per
segment over sorted int32 ids, ids at or past ``num_segments`` dropped,
values f32 or bf16. The TPU kernel is a windowed one-hot contraction on
its matrix unit; the CUDA kernel tiles the output: each resident block
owns a run of output tiles, finds where its first tile's input starts by
one search, sums each tile's runs cooperatively in a fixed order (no
atomics, bit-identical from run to run) and writes every output of the
tile once, zeros included. It is bound by bytes: each id and value read
once, each output written once.

The ELL wrappers keep the reference's gates: ``multiplicity`` and the
``_MAX_K_TILES`` coverage tests, the gram route's pair budget and
densify's ``sub_dim > _OUT_TILE`` test choose between routes (gram,
densify, per-entity ELL), so the port takes the route the reference
takes on a TPU, on the CPU and on the card alike. ``kernel_supported``
keeps the reference's dtype and int32-size rules and drops its backend
rule. The run reduction itself needs no coverage window, so
``sorted_segment_sum`` launches it on CUDA tensors for any
``multiplicity``, and ``densify_ell`` densifies the buckets the route
gates leave on ELL through it too.

``PHOTON_SEGMENT_KERNEL=off`` turns the kernel off: ``kernel_supported``
is then False, so the ELL wrappers' gates send every bucket to the
routes without a reduce, as the reference's XLA fallback does, and the
sums that remain (``segment_sum`` and the wrappers over it) run the
plain version on CUDA tensors too. Any other value keeps the kernel on
CUDA tensors; the CPU always runs the plain version.

The sorts in front of the reduces are plain PyTorch, as the reference's
``argsort`` is XLA outside its Pallas call.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from photon_tpu_torch.ops import _build
from photon_tpu_torch.utils import device_loop

SOURCE = "photon_tpu_torch/csrc/segment_sum.cu"
REPLACES = "photon_tpu/ops/segment_reduce.py:230"

LANES = 128
_OUT_TILE = 8 * LANES  # segments per output window of the TPU kernel
_IN_TILE = 8 * LANES  # elements per streamed input tile of the TPU kernel
# Coverage bound: a reduce whose window needs more input tiles than this
# takes another route (the reference compiles no larger grid).
_MAX_K_TILES = 64
# Pair-product cap of the gram route: past it the [B, R, k, k] products
# and their sort outweigh what skipping the dense slab saves.
GRAM_ELEMENT_BUDGET = 1 << 26
_VALUE_KIND = {torch.float32: 0, torch.bfloat16: 1}

# Program contract (``--semantic``): values and ids are operands; only the
# reduce's shape keys a new program. No sync, no float64: the kernel runs
# inside the fused fit's sweep and inside score programs.
PROGRAM_AUDIT = dict(
    name="segment-reduce-kernel",
    entry="ops.segment_reduce.sorted_segment_sum",
    builder="build_segment_reduce",
    max_programs=1,
    recompiles_on=("reduce_shape",),
    hot_loop=True,
)

# Kernel launches made by ``segment_sum`` (never by the plain version),
# in all and by call site, and each site's last launch's (values, value
# bytes, segments): what ``site_cost`` counts.
launches = 0
launches_by_site: dict = {}
shapes_by_site: dict = {}

_launch_fn = None


def reset_counts() -> None:
    """Zero ``launches`` and ``launches_by_site`` (and forget
    ``shapes_by_site``)."""
    global launches
    launches = 0
    launches_by_site.clear()
    shapes_by_site.clear()


def site_cost(site: str) -> dict | None:
    """``costmodel.segment_sum_cost`` of the last launch at ``site``
    (None if none launched there): the cost ledger's census count."""
    shape = shapes_by_site.get(site)
    if shape is None:
        return None
    from photon_tpu_torch.analysis import costmodel

    return costmodel.segment_sum_cost(*shape)


def kernel_supported(num_values: int, num_segments: int, dtype) -> bool:
    """Whether the kernel route serves this reduce: f32 or bf16 values,
    at least one value and one segment, both counts below 2**31 (the
    ids are int32), and ``PHOTON_SEGMENT_KERNEL`` not ``off``."""
    if _build.kernel_off("PHOTON_SEGMENT_KERNEL"):
        return False
    return (dtype in _VALUE_KIND
            and 1 <= int(num_values) < 2**31
            and 1 <= int(num_segments) < 2**31)


def _k_for(per_window_elements: int) -> int:
    """Input tiles the TPU kernel visits to cover a window of this many
    elements."""
    return -(-int(per_window_elements) // _IN_TILE) + 1


def window_counts_np(ids: np.ndarray, num_segments: int) -> np.ndarray:
    """HOST: element counts per ``_OUT_TILE``-segment window of flat
    segment ids (the planner's gram-route bookkeeping)."""
    return np.bincount(
        ids // _OUT_TILE, minlength=-(-int(num_segments) // _OUT_TILE))


def window_bound_from_counts(max_count) -> int:
    """A max per-window element count in the ``multiplicity`` currency:
    elements per window over ``_OUT_TILE``, rounded up, at least 1."""
    return max(-(-int(max_count) // _OUT_TILE), 1)


def ell_gram_supported(b: int, r: int, k: int, sub_dim: int, *,
                       grad_mult: int, hess_mult: int) -> bool:
    """Whether the gram route (``ell_gram_blocks`` and
    ``ell_segment_slots``) serves a [B, R, k] ELL bucket of width
    ``sub_dim``, given the planner's window bounds."""
    s = int(sub_dim)
    m_pair = b * r * k * k
    if m_pair > GRAM_ELEMENT_BUDGET:
        return False
    if _k_for(_OUT_TILE * max(int(grad_mult), 1)) > _MAX_K_TILES:
        return False
    if _k_for(_OUT_TILE * max(int(hess_mult), 1)) > _MAX_K_TILES:
        return False
    # Products are formed in f32 whatever the storage dtype.
    return (kernel_supported(m_pair, b * s * s, torch.float32)
            and kernel_supported(b * r * k, b * s, torch.float32))


def densify_supported(b: int, r: int, k: int, sub_dim: int, dtype) -> bool:
    """Whether ``densify_ell_blocks`` serves a [B, R, k] ELL bucket of
    width ``sub_dim``: the reference's window tests (at most
    ``_OUT_TILE`` slots, a covering window of at most ``_MAX_K_TILES``
    tiles) and the kernel's dtype and size rules."""
    s = int(sub_dim)
    if s > _OUT_TILE:
        return False
    rows_per_window = _OUT_TILE // s + 3
    return (_k_for(rows_per_window * k) <= _MAX_K_TILES
            and kernel_supported(b * r * k, b * r * s, dtype))


def load() -> None:
    """Build (first time only) and bind the kernel library."""
    global _launch_fn
    if _launch_fn is not None:
        return
    fn = _build.library().photon_segment_sum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _launch_fn = fn


def sorted_segment_sum_plain(values: torch.Tensor, ids: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: [num_segments] sums, ids
    outside [0, num_segments) dropped; f32 for f32 and bf16 values, f64
    for f64 values (which only CPU tensors take)."""
    n = int(num_segments)
    acc = torch.promote_types(values.dtype, torch.float32)
    idx = ids.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    out = torch.zeros(n + 1, dtype=acc, device=values.device)
    out.index_add_(0, idx, values.to(acc))
    return out[:n]


def segment_sum(values: torch.Tensor, ids: torch.Tensor, num_segments: int,
                *, site: str = "segment_reduce") -> torch.Tensor:
    """Segment sum over sorted int32 ids: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors (and for CUDA tensors
    when ``PHOTON_SEGMENT_KERNEL=off``). An empty reduce is
    ``num_segments`` zeros, with nothing to launch."""
    if (values.device.type == "cpu"
            or _build.kernel_off("PHOTON_SEGMENT_KERNEL")):
        return sorted_segment_sum_plain(values, ids, num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {values.device}")
    if values.shape[0] == 0:
        return torch.zeros(int(num_segments), dtype=torch.float32,
                           device=values.device)
    return _launch(values, ids, int(num_segments), site)


def _launch(values, ids, n: int, site: str) -> torch.Tensor:
    global launches
    if values.dim() != 1 or ids.dim() != 1:
        raise ValueError(f"values {tuple(values.shape)} and ids "
                         f"{tuple(ids.shape)} must be 1-D")
    m = int(values.shape[0])
    if int(ids.shape[0]) != m:
        raise ValueError(f"{m} values but {int(ids.shape[0])} ids")
    if values.dtype not in _VALUE_KIND:
        raise ValueError(f"values have dtype {values.dtype}, expected "
                         "float32 or bfloat16")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids have dtype {ids.dtype}, expected int32")
    if ids.device != values.device:
        raise ValueError(f"ids are on {ids.device}, values on "
                         f"{values.device}")
    if not (values.is_contiguous() and ids.is_contiguous()):
        raise ValueError("values and ids must be contiguous")
    if not (1 <= m < 2**31 and 1 <= n < 2**31):
        raise ValueError(f"the segment-sum kernel takes 1 <= m, n < 2**31; "
                         f"got m={m}, n={n}")
    load()
    out = torch.empty(n, dtype=torch.float32, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    rc = _launch_fn(values.data_ptr(), _VALUE_KIND[values.dtype],
                    ids.data_ptr(), m, n, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum launch failed with CUDA error {rc}")
    device_loop.note_launch("segment_sum", values.device,
                            f"m={m} n={n} {values.dtype} site={site}")
    launches += 1
    launches_by_site[site] = launches_by_site.get(site, 0) + 1
    shapes_by_site[site] = (m, values.element_size(), n)
    return out


def sorted_segment_sum(values: torch.Tensor, ids: torch.Tensor,
                       num_segments: int, *, multiplicity: int = 1,
                       site: str = "segment_reduce") -> torch.Tensor:
    """Segment sum over SORTED int32 ids; ids at or past
    ``num_segments`` drop. ``multiplicity`` is the reference's coverage
    key (elements per output window); the run reduction needs no window,
    so it chooses nothing here: CUDA tensors launch the kernel whatever
    it is (and raise for values it does not take), CPU tensors run the
    plain version."""
    del multiplicity
    return segment_sum(values.contiguous(), ids.to(torch.int32).contiguous(),
                       int(num_segments), site=site)


def _sorted(ids: torch.Tensor, vals: torch.Tensor):
    """(vals, ids) in ascending stable order of ids."""
    ids_s, order = torch.sort(ids, stable=True)
    return vals[order], ids_s


def row_operands(n: int, row_ids: torch.Tensor, zb: torch.Tensor,
                 valid: torch.Tensor):
    """(values, ids) that ``scatter_add_rows`` reduces: the valid slots'
    scores at their rows, sorted by row; invalid ones at the drop id."""
    ids = torch.where(valid, row_ids.to(torch.int32),
                      torch.full_like(row_ids, n, dtype=torch.int32))
    return _sorted(ids.reshape(-1), zb.reshape(-1))


def scatter_add_rows(z: torch.Tensor, row_ids: torch.Tensor,
                     zb: torch.Tensor, valid: torch.Tensor, *,
                     site: str = "segment_reduce/score") -> torch.Tensor:
    """``z`` plus ``zb`` added at ``row_ids`` where ``valid`` (the bucket
    scorer's scatter), as a sort and one reduce. Valid row ids are
    distinct within a bucket, so multiplicity is 1."""
    n = z.shape[0]
    vals, ids = row_operands(n, row_ids, zb, valid)
    out = sorted_segment_sum(vals, ids, n, multiplicity=1, site=site)
    return z + out.to(z.dtype)


def slot_operands(x_indices: torch.Tensor, x_values: torch.Tensor,
                  row_weights: torch.Tensor, sub_dim: int):
    """(values, ids, n) that ``ell_segment_slots`` reduces: f32 products
    ``row_weights[b, r] * v[b, r, j]`` at segment ``b S + idx[b, r, j]``,
    zero products at the drop id ``n = B S``, sorted stably by id."""
    b = x_indices.shape[0]
    s = int(sub_dim)
    n = b * s
    vals = (x_values.to(torch.float32)
            * row_weights.to(torch.float32)[:, :, None]).reshape(-1)
    ent = torch.arange(b, dtype=torch.int64, device=x_indices.device) * s
    ids = (x_indices.long() + ent[:, None, None]).reshape(-1)
    ids = torch.where(vals != 0.0, ids, torch.full_like(ids, n))
    return (*_sorted(ids.to(torch.int32), vals), n)


def ell_segment_slots(x_indices: torch.Tensor, x_values: torch.Tensor,
                      row_weights: torch.Tensor, sub_dim: int, *,
                      multiplicity: int,
                      site: str = "segment_reduce/slots"):
    """Per-entity weighted slot totals from the ELL layout,
    ``out[b, s] = sum over (r, j) with idx[b, r, j] == s of
    row_weights[b, r] * v[b, r, j]`` ([B, S] f32): the ``X^T W y`` half
    of the normal equations with no dense slab. None when the kernel
    route does not serve this shape."""
    b, r, k = x_indices.shape
    s = int(sub_dim)
    if (not kernel_supported(b * r * k, b * s, torch.float32)
            or _k_for(_OUT_TILE * max(int(multiplicity), 1)) > _MAX_K_TILES):
        return None
    vals, ids, n = slot_operands(x_indices, x_values, row_weights, s)
    flat = sorted_segment_sum(vals, ids, n, multiplicity=multiplicity,
                              site=site)
    return flat.reshape(b, s)


def gram_operands(x_indices: torch.Tensor, x_values: torch.Tensor,
                  weights: torch.Tensor, sub_dim: int):
    """(values, ids, n) that ``ell_gram_blocks`` reduces: every f32 pair
    product ``w[b, r] v[b, r, j] v[b, r, l]`` at segment
    ``b S^2 + idx_j S + idx_l``, zero products at the drop id
    ``n = B S^2``, sorted stably by id."""
    b = x_indices.shape[0]
    s = int(sub_dim)
    n = b * s * s
    xf = x_values.to(torch.float32)
    vals = (weights.to(torch.float32)[:, :, None, None]
            * xf[:, :, :, None] * xf[:, :, None, :]).reshape(-1)
    idx = x_indices.long()
    ent = torch.arange(b, dtype=torch.int64, device=idx.device) * (s * s)
    ids = (ent[:, None, None, None] + idx[:, :, :, None] * s
           + idx[:, :, None, :]).reshape(-1)
    ids = torch.where(vals != 0.0, ids, torch.full_like(ids, n))
    return (*_sorted(ids.to(torch.int32), vals), n)


def ell_gram_blocks(x_indices: torch.Tensor, x_values: torch.Tensor,
                    weights: torch.Tensor, sub_dim: int, *,
                    multiplicity: int, site: str = "segment_reduce/gram"):
    """Per-entity weighted gram matrices ``X^T diag(w) X`` ([B, S, S]
    f32) from the ELL layout, by one sorted reduce over the bucket's
    pair products. None when the route does not serve this shape (the
    pair budget included)."""
    b, r, k = x_indices.shape
    s = int(sub_dim)
    m = b * r * k * k
    if (m > GRAM_ELEMENT_BUDGET
            or not kernel_supported(m, b * s * s, torch.float32)
            or _k_for(_OUT_TILE * max(int(multiplicity), 1)) > _MAX_K_TILES):
        return None
    vals, ids, n = gram_operands(x_indices, x_values, weights, s)
    flat = sorted_segment_sum(vals, ids, n, multiplicity=multiplicity,
                              site=site)
    return flat.reshape(b, s, s)


def densify_operands(x_indices: torch.Tensor, x_values: torch.Tensor,
                     sub_dim: int):
    """(values, ids, n) that ``densify_ell_blocks`` reduces: each row's k
    slots sorted stably, so the flat ``row * S + slot`` ids are sorted
    across the bucket; ``n = B R S``."""
    b, r, k = x_indices.shape
    s = int(sub_dim)
    rows = b * r
    idx, order = torch.sort(x_indices.reshape(rows, k).long(), dim=1,
                            stable=True)
    vals = torch.gather(x_values.reshape(rows, k), 1, order)
    row_base = torch.arange(rows, dtype=torch.int64,
                            device=idx.device)[:, None] * s
    ids = (idx + row_base).reshape(-1).to(torch.int32)
    return vals.reshape(-1).contiguous(), ids, rows * s


def densify_ell_blocks(x_indices: torch.Tensor, x_values: torch.Tensor,
                       sub_dim: int, *,
                       site: str = "segment_reduce/densify"):
    """[B, R, k] slot-ELL to [B, R, S] dense, duplicate slots summed, by
    one reduce over the whole bucket. None when the reference's kernel
    would not serve this shape; the caller then keeps the ELL layout."""
    if not densify_supported(*x_indices.shape, sub_dim, x_values.dtype):
        return None
    return _densify_by_reduce(x_indices, x_values, sub_dim, site)


def _densify_by_reduce(x_indices, x_values, sub_dim: int, site: str):
    b, r, _ = x_indices.shape
    vals, ids, n = densify_operands(x_indices, x_values, sub_dim)
    flat = segment_sum(vals, ids, n, site=site)
    return flat.reshape(b, r, int(sub_dim)).to(x_values.dtype)


def densify_ell_plain(x_indices: torch.Tensor, x_values: torch.Tensor,
                      sub_dim: int) -> torch.Tensor:
    """[B, R, k] slot-ELL to [B, R, S] dense by a scatter-add in the
    values' dtype, as the reference densifies an ELL bucket per entity
    in its direct solve. One scatter per ELL column: within one no two
    entries meet, so a duplicate slot sums in column order on any
    device, with no float atomics racing."""
    b, r, k = x_indices.shape
    x = torch.zeros((b, r, int(sub_dim)), dtype=x_values.dtype,
                    device=x_values.device)
    idx = x_indices.long()
    for j in range(k):
        x.scatter_add_(2, idx[:, :, j:j + 1], x_values[:, :, j:j + 1])
    return x


def densify_ell(x_indices: torch.Tensor, x_values: torch.Tensor,
                sub_dim: int, *,
                site: str = "segment_reduce/densify_ell") -> torch.Tensor:
    """[B, R, k] slot-ELL to [B, R, S] dense for a bucket the route gates
    leave on ELL: on CUDA tensors through the kernel, which takes any
    width (and raises for values it does not take); on CPU tensors, or
    with ``PHOTON_SEGMENT_KERNEL=off``, by ``densify_ell_plain``."""
    if (x_values.device.type == "cpu"
            or _build.kernel_off("PHOTON_SEGMENT_KERNEL")):
        return densify_ell_plain(x_indices, x_values, sub_dim)
    return _densify_by_reduce(x_indices, x_values, sub_dim, site)
