"""Mixed-precision policy (port of ``photon_tpu/ops/precision.py``).

``"bfloat16"`` stores large reused operands (the serving coefficient
tables) in bf16; every sum across a row axis reads bf16, accumulates in
f32 and returns f32. ``"float32"`` is the default. The port never turns
TF32 on: a float32 product stays a full float32 product.
"""

from __future__ import annotations

import torch

FLOAT32 = "float32"
BFLOAT16 = "bfloat16"

_ALIASES = {
    "float32": FLOAT32,
    "f32": FLOAT32,
    "fp32": FLOAT32,
    "bfloat16": BFLOAT16,
    "bf16": BFLOAT16,
    "mixed_bf16": BFLOAT16,
}


def resolve(name: str | None) -> str:
    """Normalize a precision name; the default is the f32 path."""
    if name is None:
        return FLOAT32
    key = str(name).lower()
    if key not in _ALIASES:
        raise ValueError(
            f"unknown precision {name!r}: expected one of "
            f"{sorted(set(_ALIASES))}")
    return _ALIASES[key]


def is_mixed(name: str | None) -> bool:
    return resolve(name) == BFLOAT16


def storage_dtype(name: str | None) -> torch.dtype:
    return torch.bfloat16 if is_mixed(name) else torch.float32


def in_storage(x: torch.Tensor, name: str | None) -> torch.Tensor:
    """Cast a float tensor to the policy's storage dtype (non-float
    tensors are returned as they are)."""
    if x.is_floating_point():
        return x.to(storage_dtype(name))
    return x


def acc_einsum(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """einsum whose accumulator is f32 whenever an operand is bf16 (the
    operands are read as f32; the result is f32). On f32 or f64 operands
    it is the plain ``torch.einsum``."""
    if any(o.dtype == torch.bfloat16 for o in ops):
        ops = tuple(o.float() for o in ops)
    return torch.einsum(spec, *ops)


def acc_sum(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Sum with an f32 accumulator whenever the operand is bf16."""
    dtype = torch.float32 if x.dtype == torch.bfloat16 else None
    if dim is None:
        return torch.sum(x, dtype=dtype)
    return torch.sum(x, dim=dim, keepdim=keepdim, dtype=dtype)


def like_storage(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Cast ``x`` to bf16 when ``ref`` is a bf16-stored operand."""
    if ref.dtype == torch.bfloat16:
        return x.to(torch.bfloat16)
    return x
