"""The card's peaks and the kernels' work counts: what a roofline bound
is made of (port of the peaks and ``roofline`` of
``photon_tpu/analysis/costmodel.py``).

The JAX package prices a program from XLA's cost analysis of its
lowering, at a TPU's peaks. The port has nothing to lower: a program's
cost is its kernel's own count of the bytes it must move (each input
read once, each output written once) and the operations it does, and
the peaks are an NVIDIA H100 SXM's (NVIDIA's data sheet, dense rates,
at the 700 W power limit). ``chip_smoke.py`` prints its bounds from
these counts and the cost ledger (``obs/ledger.py``) prices its rows by
them, so the two read one count.

A cost is ``{"flops", "hbm_bytes"}`` (plus ``"transcendentals"`` where
a kernel's special functions can bound it).

``collective_transfer`` prices an ordered census of collectives (the
mesh's ``CollectiveStats.census``) in bytes, and at the card's link
peak where one is given.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

H100_SXM = "h100_sxm"

CHIP_PEAKS = {
    H100_SXM: {
        # f32 outside the tensor cores: the unit the port's kernels
        # compute on.
        "flops_per_sec": 67e12,
        "hbm_bytes_per_sec": 3.35e12,
        "bf16_tensor_flops_per_sec": 989e12,
        # Special-function units: 16 results a clock per SM (CUDA C++
        # Programming Guide, arithmetic instruction throughput, compute
        # capability 9.0) x 132 SMs x 1.98 GHz boost clock.
        "transcendentals_per_sec": 16 * 132 * 1.98e9,
        # NVLink (fourth generation, 18 links): 900 GB/s, NVIDIA's H100
        # SXM data sheet at the 700 W power limit. Ranks that share one
        # card (the gloo route) move their operands through host memory
        # instead, which this figure does not bound.
        "link_bytes_per_sec": 900e9,
    },
}

# Bytes of an element of each dtype a census names.
_DTYPE_BYTES = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2, "int64": 8,
    "int32": 4, "int16": 2, "int8": 1, "uint8": 1, "bool": 1,
    "complex64": 8, "complex128": 16,
}
DEFAULT_CHIP = H100_SXM


def roofline(cost: Mapping[str, float],
             chip: str = DEFAULT_CHIP) -> dict[str, Any]:
    """Roofline classification of one program's cost: ``min_seconds``
    is the least time one launch could take at the chip's peaks, and
    ``bound`` names the resource that sets it (``flops`` or ``hbm``)."""
    peaks = CHIP_PEAKS[chip]
    flops = float(cost.get("flops", 0.0))
    bytes_ = float(cost.get("hbm_bytes", 0.0))
    t_flops = flops / peaks["flops_per_sec"]
    t_hbm = bytes_ / peaks["hbm_bytes_per_sec"]
    return {
        "chip": chip,
        "arithmetic_intensity": (flops / bytes_) if bytes_ else None,
        "min_seconds_flops": t_flops,
        "min_seconds_hbm": t_hbm,
        "min_seconds": max(t_flops, t_hbm),
        "bound": "flops" if t_flops >= t_hbm else "hbm",
    }


def serve_score_cost(ops: Mapping, precision: str, *,
                     rows_read=None, rows_known=None) -> dict[str, float]:
    """One launch of the fused serve kernel (``ops/serve_kernel.py``)
    on ``fused_score``'s operands: the features read once, each fixed
    table once, each code vector once, the table rows the known codes
    name once per distinct entity (weights and projector), the f32
    output written once; a multiply-add per feature of each row's fixed
    dot and per slot of each known row's random dot.

    ``rows_read[i]`` and ``rows_known[i]`` are random coordinate i's
    distinct rows read and its rows with a known code; by default they
    are counted from the operands' codes (this batch's data). The cost
    ledger passes the padded rung's count, every row known and
    distinct, the most one launch of the rung can need. Only shapes
    are read unless the codes are counted."""
    wbytes = 2 if precision == "bfloat16" else 4
    rung = int(ops["codes"][0].shape[0]) if ops["codes"] else int(
        _rows(ops["feats"][0]))
    nbytes = 4.0 * rung
    flops = 0.0
    kinds, feats = ops["spec_kinds"], ops["feats"]
    for si, kind in enumerate(kinds):
        nbytes += (feats[si].numel() * 4 if kind == "dense"
                   else feats[si][0].numel() * 8)
    for w, fi in zip(ops["fe_ws"], ops["fe_feat"]):
        nbytes += w.numel() * wbytes
        width = (feats[fi].shape[1] if kinds[fi] == "dense"
                 else feats[fi][0].shape[1])
        flops += 2.0 * rung * width
    for i, (w, code, fi) in enumerate(
            zip(ops["re_ws"], ops["codes"], ops["re_feat"])):
        s = int(w.shape[1])
        if rows_read is None or rows_known is None:
            known = code[(code >= 0) & (code < w.shape[0])]
            n_read, n_known = int(known.unique().numel()), int(known.numel())
        else:
            n_read, n_known = int(rows_read[i]), int(rows_known[i])
        nbytes += code.numel() * 4
        nbytes += n_read * s * (wbytes + 4)
        per_slot = 2.0 if kinds[fi] == "dense" else 2.0 * (
            feats[fi][0].shape[1] + 1)
        flops += per_slot * n_known * s
    return {"flops": flops, "hbm_bytes": nbytes}


def _rows(leaf) -> int:
    return (leaf.shape[0] if hasattr(leaf, "shape") else leaf[0].shape[0])


def newton_step_cost(shape, trials: int = 16) -> dict[str, float]:
    """One Newton step (``ops/newton_kernel.py``) on a [B, R, S] bucket.
    Bytes: the slab, each [B, R] and [B, S] operand and output, f read
    and written and the improved byte, each once. f32 operations:
    margins, gradient, the S CG steps (the cheaper of a formed H and H
    applied from the slab), trial margins and losses, the refresh.
    Transcendentals: the exp and log1p of every row in every trial,
    plus those of the margins and the refresh."""
    b, r, s = shape
    nbytes = 4.0 * b * (r * s + 3 * r + 4 * s + 2 * s + 2) + b
    cg = min(r * s * (s + 1) + r * s + s * (2 * s * s + 10 * s),
             s * (4 * r * s + r + 12 * s))
    per_entity = (
        2 * r * s                      # margins
        + cg                           # H (formed or not) and the CG
        + 2 * r * s + 4 * s            # gradient + penalty
        + 2 * r * s                    # trial margins x d
        + trials * (r * 12 + 4 * s)    # trial losses + penalties
        + 4 * r * s + 12 * r           # refresh: margins, gradient, loss
    )
    return {"flops": float(b) * per_entity, "hbm_bytes": nbytes,
            "transcendentals": float(b) * r * (2 * trials + 6)}


def segment_sum_cost(n_values: int, value_bytes: int,
                     n_segments: int) -> dict[str, float]:
    """One sorted segment sum (``ops/segment_reduce.py``): each value
    and its int32 id read once, each f32 output written once; the adds
    are never the bound."""
    return {"flops": float(n_values),
            "hbm_bytes": float(n_values * (4 + value_bytes)
                               + n_segments * 4)}


def census_bytes(step: Mapping) -> float:
    """Bytes one rank contributes to one collective of a census: its
    ``bytes`` where recorded, else its operand ``shape`` times the
    size of its ``dtype`` (unknown dtypes at 1 byte: an undercount,
    never a silent zero)."""
    if step.get("bytes") is not None:
        return float(step["bytes"])
    size = 1
    for d in step.get("shape") or ():
        size *= int(d)
    return float(size * _DTYPE_BYTES.get(str(step.get("dtype")), 1))


def collective_transfer(sequence: Iterable[Mapping],
                        chip: str = DEFAULT_CHIP) -> dict[str, Any]:
    """Price an ordered collective census as bytes over the link
    (reference ``costmodel.py:186-208``). ``sequence`` is census records
    (``{"op", "site", "dtype", "shape", "bytes"}``). Returns per-op
    bytes, the total, and the link-bandwidth lower bound: what an
    undeclared collective adds to every fit."""
    ops: list[dict[str, Any]] = []
    total = 0.0
    for step in sequence:
        b = census_bytes(step)
        total += b
        ops.append({"op": step.get("op", "?"), "site": step.get("site"),
                    "bytes": b})
    peak = CHIP_PEAKS[chip].get("link_bytes_per_sec")
    return {
        "chip": chip,
        "ops": ops,
        "total_bytes": total,
        "min_seconds_link": (total / peak) if peak else None,
    }
