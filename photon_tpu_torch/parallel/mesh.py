"""The data- and entity-parallel mesh as a ``torch.distributed`` process
group (port of ``photon_tpu/parallel/mesh.py``).

The reference places arrays on a one-axis ``jax.sharding.Mesh`` named
``data`` and XLA inserts the collectives. Here the mesh is SPMD in
PyTorch's own form: one process per device, every process running the
same program on the same data. A ``Mesh`` is this process's place in the
group (its rank, the group's size, its device); what the reference's
shardings say, each rank does for its share:

- a fixed-effect batch is padded to a multiple of the ranks with
  weight-0 rows and each rank holds its contiguous share of the rows
  (``shard_batch``); the objective's row sums cross the ranks
  (``ops/glm.py``);
- each random-effect bucket's entity axis is padded to a multiple of
  the ranks with inert entities and each rank keeps its contiguous
  range (``shard_random_effect_dataset``); the raw leaves the plans
  gather from stay whole on every rank, as the reference replicates
  them;
- coefficients, residual scores and validation scores are replicated:
  a rank scores its share of the rows and the shares are gathered.

**Every cross-rank sum is an ``all_gather`` followed by a sum in rank
order** (``Mesh.sum``), never the backend's ``all_reduce``, whose
reduction order is the backend's own. Every rank then holds the same
bits, so every host branch (line searches, convergence, model
selection, checkpoints) goes the same way on every rank and no two
ranks can issue different collective sequences; and a fit repeats bit
for bit across runs.

``init_from_env`` starts the group from the variables ``torchrun``
exports. The backend is NCCL when each rank has a card of its own, and
gloo when ranks share a card (NCCL refuses two ranks on one device) or
run on the CPU. Gloo reads host memory: a CUDA tensor it gathers goes
through a pinned host buffer and back (``Mesh.all_gather``); the compute
stays on the card.

``PARTITION_RULES`` keeps the reference's record of what each placement
does, leaf name by leaf name (``match_partition_rules``).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import re
import sys
import time

import numpy as np
import torch

from photon_tpu_torch import device as device_mod
from photon_tpu_torch.data.dataset import (
    DenseFeatures,
    GLMBatch,
    SparseFeatures,
    pad_batch,  # noqa: F401 - the reference's mesh module exports it
    pad_rows,
)

logger = logging.getLogger(__name__)

DATA_AXIS = "data"

# Seconds a collective waits for the other ranks before it fails; a rank
# that died leaves the others a failed collective, not a hang.
DEFAULT_TIMEOUT_SECONDS = 600.0
TIMEOUT_ENV = "PHOTON_DIST_TIMEOUT_SECONDS"


class PartitionSpec(tuple):
    """The reference's ``jax.sharding.PartitionSpec``, as a record: the
    mesh axis of each leaf dimension (None: not sharded). It prints as
    the reference's does."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        inner = ", ".join(repr(a) for a in self)
        return f"PartitionSpec({inner}{',' if len(self) == 1 else ''})"

    __str__ = __repr__


P = PartitionSpec

# The regex partition rules of every leaf the mesh places, first match
# wins (a copy of the reference's). Leaf names are slash-joined paths:
# "fe/<field>" for the fixed-effect batch, "re/block<i>/<field>" for
# random-effect plan arrays, "re/raw*"/"re/score_*" for the shared
# scoring tables, "coef/*" for coefficient vectors.
PARTITION_RULES = (
    # Fixed-effect batch leaves: rows sharded over the data axis
    # (shard_batch pads to the rank count first).
    (r"^fe/(features|labels|offsets|weights|uids)$", P(DATA_AXIS)),
    # Random-effect plan arrays: entity axis sharded; the per-entity
    # solves are independent (shard_random_effect_dataset).
    (
        r"^re/block\d+/(entity_codes|row_ids|row_counts|proj"
        r"|intercept_slots)$",
        P(DATA_AXIS),
    ),
    # Shared raw leaves: replicated; plans gather arbitrary rows.
    (r"^re/raw(/|$)", P()),
    # Residual-scorer tables: per-row work, a share of rows a rank.
    (r"^re/score_(codes|indices|values)$", P(DATA_AXIS)),
    # Coefficients: replicated.
    (r"^coef(/|$)", P()),
)


def match_partition_rules(rules, leaves: dict):
    """Map named leaves to PartitionSpecs by first-match regex rules.

    ``leaves`` maps slash-joined path names to arrays (anything with
    ``ndim``). Scalars take ``P()`` without consuming a rule; an array
    leaf no rule matches raises. Returns ``(specs, matches)`` where
    ``matches[name]`` lists every matching rule index."""
    specs: dict = {}
    matches: dict = {}
    for name, leaf in leaves.items():
        hit = [i for i, (pat, _) in enumerate(rules) if re.search(pat, name)]
        matches[name] = hit
        if int(getattr(leaf, "ndim", 0)) == 0:
            specs[name] = P()
        elif hit:
            specs[name] = rules[hit[0]][1]
        else:
            raise ValueError(f"no partition rule matches leaf {name!r}")
    return specs, matches


@dataclasses.dataclass
class CollectiveStats:
    """The collectives a mesh issued: how many, their host seconds and
    the bytes each rank contributed."""

    count: int = 0
    seconds: float = 0.0
    bytes: int = 0

    def snapshot(self) -> dict:
        return {"count": self.count, "seconds": self.seconds,
                "bytes": self.bytes}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in a one-axis mesh of ``size`` ranks: its
    ``rank``, its ``device``, the group's ``backend`` and the
    ``torch.distributed`` ``group`` (None: the default group). A mesh of
    one rank issues no collective."""

    rank: int
    size: int
    device: torch.device
    backend: str = "gloo"
    group: object = None
    axis_name: str = DATA_AXIS
    stats: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats)

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    def local_rows(self, n: int) -> tuple[int, int, int]:
        """``(lo, hi, per)``: this rank holds rows ``lo:hi`` of ``n``,
        padded to ``per = ceil(n / size)`` rows."""
        per = -(-n // self.size)
        lo = min(self.rank * per, n)
        return lo, min(lo + per, n), per

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (same shape on every rank), in rank
        order."""
        if self.size == 1:
            return [t]
        import torch.distributed as dist

        t0 = time.perf_counter()
        src = t.contiguous()
        staged = self.backend == "gloo" and src.device.type == "cuda"
        if staged:
            # Gloo's collectives read host memory: copy out through a
            # pinned host buffer (this waits for the card) and bring the
            # gathered copies back. Only the operands travel.
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src)
            src = host
        parts = [torch.empty(src.shape, dtype=src.dtype,
                             pin_memory=staged, device=src.device)
                 for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        if staged:
            parts = [p.to(t.device, non_blocking=True) for p in parts]
        self.stats.count += 1
        self.stats.bytes += src.numel() * src.element_size()
        self.stats.seconds += time.perf_counter() - t0
        return parts

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, the same bits on every rank:
        gathered, then added in rank order."""
        parts = self.all_gather(t)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def sum_parts(self, *ts: torch.Tensor) -> tuple:
        """``sum`` of several tensors of one dtype in one collective."""
        if self.size == 1:
            return ts
        flat = self.sum(torch.cat([t.reshape(-1) for t in ts]))
        out, at = [], 0
        for t in ts:
            out.append(flat[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return tuple(out)

    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The whole ``[n, ...]`` from every rank's ``[per, ...]`` share
        of rows (``local_rows``), cut back to ``n`` rows."""
        if self.size == 1:
            return local[:n]
        return torch.cat(self.all_gather(local))[:n]

    def barrier(self) -> None:
        if self.size == 1:
            return
        import torch.distributed as dist

        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def _group_world() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(group=None, *, device=None) -> Mesh:
    """The mesh of every rank of ``group`` (default: the default
    process group), this process on ``device`` (default ``cuda``)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is up: launch with "
            "torchrun (or set RANK, WORLD_SIZE and MASTER_ADDR/PORT) and "
            "call parallel.mesh.init_from_env")
    return Mesh(rank=dist.get_rank(group), size=dist.get_world_size(group),
                device=device_mod.resolve(device),
                backend=str(dist.get_backend(group)), group=group)


def resolve_mesh(setting, device=None) -> Mesh | None:
    """Shared mesh-setting resolution for the estimator and the CLIs.

    ``"auto"`` -> every rank of the process group (None without a group
    or with one rank), ``"off"``/``"none"``/``"1"``/``None``/``False``/
    ``1`` -> None, an int or digit string -> that many ranks, a ``Mesh``
    -> itself. Unrecognized strings raise: a typo like ``"fof"`` must
    not silently mean "auto". One process runs on each device, so a
    count below the group's size (a sub-mesh) would leave ranks with
    nothing to do and raises, as a count above it does."""
    m = setting
    if isinstance(m, str):
        key = m.strip().lower()
        if key == "auto":
            return make_mesh(device=device) if _group_world() > 1 else None
        if key in ("off", "none", "1"):
            return None
        if key.isdigit():
            m = int(key)
        else:
            raise ValueError(f"unknown mesh setting {setting!r}")
    if isinstance(m, bool):
        return (make_mesh(device=device) if (m and _group_world() > 1)
                else None)
    if isinstance(m, int):
        if m < 1:
            raise ValueError(f"mesh setting must be >= 1 device, got {m}")
        world = _group_world()
        if m > world:
            raise ValueError(
                f"mesh setting requests {m} devices but only {world} are "
                "visible")
        if m == 1:
            return None
        if m < world:
            raise ValueError(
                f"mesh setting requests {m} of the process group's {world} "
                "ranks: a sub-mesh is not supported with one process per "
                "device (the other ranks would have nothing to run); "
                f"launch {m} processes instead")
        return make_mesh(device=device)
    if m is None or isinstance(m, Mesh):
        return m
    raise TypeError(f"unknown mesh setting {setting!r}")


def init_from_env(device=None) -> Mesh | None:
    """Start the default process group from the variables ``torchrun``
    exports (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and return
    the mesh of its ranks, or None for a single process. An existing
    group is reused. On ``cuda`` this rank's device is
    ``cuda:{LOCAL_RANK mod device_count}`` (``device.resolve``); the
    backend is NCCL when each local rank has a card of its own, else
    gloo, which the CPU uses too. The choice is logged and printed to
    standard error. Collectives time out after
    ``PHOTON_DIST_TIMEOUT_SECONDS`` (default 600)."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world <= 1:
        return None
    if dist.is_initialized():
        return make_mesh(device=device)
    missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT")
               if not os.environ.get(k)]
    if missing:
        raise ValueError(
            f"WORLD_SIZE={world} but {', '.join(missing)} not set: launch "
            "with torchrun, or export RANK, WORLD_SIZE, MASTER_ADDR and "
            "MASTER_PORT for every process")
    dev = device_mod.resolve(device)
    rank = int(os.environ["RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world) or world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        shared = local_world > torch.cuda.device_count()
        backend = "gloo" if shared else "nccl"
        why = ("ranks share a card: NCCL refuses two ranks on one device"
               if shared else "one card a rank")
    else:
        backend, why = "gloo", "CPU ranks"
    timeout = float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_SECONDS))
    msg = (f"torch.distributed: rank {rank}/{world} on {dev}, backend "
           f"{backend} ({why}), timeout {timeout:g} s")
    logger.info(msg)
    print(msg, file=sys.stderr, flush=True)
    dist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    return make_mesh(device=dev)


def shutdown() -> None:
    """Tear the default process group down, if one is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def maybe_row_shard(mesh: Mesh | None, *leaves):
    """Each ``[n, ...]`` leaf's share of rows on this rank
    (``Mesh.local_rows``: padded with zero rows to ``ceil(n / size)``);
    the leaves unchanged without a mesh. The shares of every rank, in
    rank order, are the leaves padded to a multiple of the ranks."""
    if mesh is None:
        return leaves
    lo, hi, per = mesh.local_rows(int(leaves[0].shape[0]))
    out = []
    for leaf in leaves:
        part = leaf[lo:hi]
        if hi - lo < per:
            part = torch.cat([part, part.new_zeros(
                (per - (hi - lo),) + tuple(leaf.shape[1:]))])
        out.append(part)
    return tuple(out)


def shard_features(feats, mesh: Mesh):
    """This rank's share of the rows of Dense or ELL features
    (``maybe_row_shard``); ``DualEllFeatures`` are refused, as
    ``pad_batch`` refuses them."""
    if isinstance(feats, DenseFeatures):
        return DenseFeatures(*maybe_row_shard(mesh, feats.x))
    if isinstance(feats, SparseFeatures):
        return SparseFeatures(
            *maybe_row_shard(mesh, feats.indices, feats.values), feats.d)
    return pad_rows(feats, feats.num_rows)  # raises: not row-aligned


def shard_batch(batch: GLMBatch, mesh: Mesh) -> GLMBatch:
    """This rank's share of the rows of ``batch`` padded to a multiple
    of the ranks (``pad_batch``'s weight-0 rows: inert in every sum),
    carrying the mesh and the batch's logical row count. The rank's
    share is cut before the padding, so only the last rank copies."""
    n = batch.num_samples
    labels, offsets, weights = maybe_row_shard(
        mesh, batch.labels, batch.offsets, batch.weights)
    return GLMBatch(shard_features(batch.features, mesh), labels, offsets,
                    weights, mesh=mesh, logical_rows=n)


def shard_random_effect_dataset(ds, mesh: Mesh):
    """Shard a RandomEffectDataset's entity axis over the mesh (ep).

    Each size bucket's entity axis is padded to a multiple of the ranks
    with inert entities (no rows, an empty subspace, entity code
    ``num_entities``, whose results the scatter back into the
    coefficient matrix drops) and this rank keeps its contiguous range
    of every bucket. The per-entity solves are independent
    (RandomEffectCoordinate.scala:243-292 runs them executor-local), so
    each rank solves its own entities with no collective until the
    coefficient rows are gathered (``RandomEffectCoordinate.train``).
    A lazy bucket's plan arrays are cut; the raw leaves it gathers
    from stay whole on every rank (the reference replicates them). A
    materialized bucket's slabs are cut the same way. The host mirrors
    of the codes and intercept slots cover every rank's entities,
    padded, so every rank reads the same convergence record."""
    from photon_tpu_torch.data.random_effect import (
        _PLAN_FIELDS,
        BlockPlan,
        EntityBlocks,
    )

    fills = {"entity_codes": ds.num_entities, "proj": -1,
             "intercept_slots": -1}

    def cut(name, leaf, pad):
        if leaf is None:  # subspace-dense EntityBlocks: x_indices None
            return None
        b = int(leaf.shape[0])
        per = (b + pad) // mesh.size
        lo = min(mesh.rank * per, b)
        part = leaf[lo:min(lo + per, b)]
        short = per - int(part.shape[0])
        if short:
            part = torch.cat([part, torch.full(
                (short,) + tuple(leaf.shape[1:]), fills.get(name, 0),
                dtype=leaf.dtype, device=leaf.device)])
        return part

    blocks, codes_np, ints_np = [], [], []
    for i, b in enumerate(ds.device_plans()):
        pad = (-b.num_entities) % mesh.size
        codes_np.append(np.pad(np.asarray(ds.block_codes_np[i]), (0, pad),
                               constant_values=ds.num_entities))
        ints_np.append(np.pad(np.asarray(ds.block_intercepts_np[i]),
                              (0, pad), constant_values=-1))
        names = (_PLAN_FIELDS if isinstance(b, BlockPlan)
                 else [f.name for f in dataclasses.fields(EntityBlocks)])
        blocks.append(dataclasses.replace(b, **{
            name: cut(name, getattr(b, name), pad) for name in names}))
    return dataclasses.replace(
        ds, blocks=tuple(blocks), block_codes_np=tuple(codes_np),
        block_intercepts_np=tuple(ints_np), mesh=mesh)
