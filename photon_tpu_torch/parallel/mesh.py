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
  a rank scores its share of the rows and the shares are gathered;
- or, for a fixed effect too wide to replicate (``feature_sharding:
  column``), the FEATURE axis is sharded instead: each rank holds the
  ELL entries of its own feature range and the matching slice of the
  coefficients and of the optimizer's state, while the rows stay whole
  on every rank (``FeatureShardedSparse``, ``shard_features_by_column``).

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

Every collective names its call site. ``CollectiveStats`` keeps, beside
the totals, the seconds and bytes of each site and the ordered census of
every collective this rank issued (op, site, dtype, operand shape,
bytes); ``SPMD_AUDIT`` declares the sites the port issues from, and the
SPMD tier (``python -m photon_tpu_torch.analysis --spmd``) holds the
ranks' censuses against each other and against that declaration.
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
    _sorted_transpose,
    pad_batch,  # noqa: F401 - the reference's mesh module exports it
    pad_rows,
)

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Call sites of the port's collectives, each an ordered all_gather
# (``Mesh.sum`` / ``sum_parts`` / ``gather_rows``) or a barrier.
SITE_ROW_SUMS = "glm.row_sums"  # a row-sharded objective's partial sums
SITE_BUCKET_GATHER = "random_effect.bucket_gather"  # entity shares
SITE_ROW_GATHER = "score.row_gather"  # the scorers' row shares
SITE_COLUMN_MARGINS = "column.margins"  # a column shard's partial margins
SITE_INNER_PRODUCTS = "column.inner_products"  # the optimizer's sums
SITE_COEFFICIENT_GATHER = "column.coefficient_gather"  # slices -> whole
SITE_CHECKPOINT_BARRIER = "estimator.checkpoint_barrier"

# SPMD contract (audited by ``python -m photon_tpu_torch.analysis
# --spmd``; machinery in analysis/spmd.py). The port has no jaxpr or
# HLO: the builder runs ``hosts`` gloo ranks on the CPU through a GLMix
# fit with a row-sharded fixed effect and a random effect, then a
# column-sharded fixed-effect fit, and every rank's ordered census of
# collectives must equal rank 0's position by position, each site one
# declared here; every leaf the mesh places is covered by exactly one
# PARTITION_RULES entry.
SPMD_AUDIT = dict(
    name="mesh-spmd",
    entry="parallel.mesh.shard_batch / shard_random_effect_dataset / "
    "shard_features_by_column + GameEstimator(mesh='auto').fit",
    builder="build_mesh_spmd",
    hosts=2,
    ordered_collectives=(
        SITE_ROW_SUMS,
        SITE_BUCKET_GATHER,
        SITE_ROW_GATHER,
        SITE_COLUMN_MARGINS,
        SITE_INNER_PRODUCTS,
        SITE_COEFFICIENT_GATHER,
        SITE_CHECKPOINT_BARRIER,
    ),
    partition_rules="PARTITION_RULES",
)

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
    the bytes each rank contributed, in total and by call site
    (``by_site``), and the ordered ``census`` of every one: ``{"op",
    "site", "dtype", "shape", "bytes"}``."""

    count: int = 0
    seconds: float = 0.0
    bytes: int = 0
    by_site: dict = dataclasses.field(default_factory=dict)
    census: list = dataclasses.field(default_factory=list)

    def record(self, op: str, site: str, t: torch.Tensor | None,
               seconds: float) -> None:
        nbytes = 0 if t is None else t.numel() * t.element_size()
        self.count += 1
        self.bytes += nbytes
        self.seconds += seconds
        row = self.by_site.setdefault(
            site, {"count": 0, "seconds": 0.0, "bytes": 0})
        row["count"] += 1
        row["seconds"] += seconds
        row["bytes"] += nbytes
        self.census.append({
            "op": op, "site": site,
            "dtype": None if t is None else str(t.dtype).replace(
                "torch.", ""),
            "shape": [] if t is None else list(t.shape),
            "bytes": nbytes})

    def snapshot(self) -> dict:
        return {"count": self.count, "seconds": self.seconds,
                "bytes": self.bytes,
                "by_site": {k: dict(v) for k, v in self.by_site.items()},
                "census_length": len(self.census)}


def site_delta(before: dict, after: dict) -> dict:
    """Per-site ``{"count", "seconds", "bytes"}`` issued between two
    ``CollectiveStats.snapshot()``s."""
    out = {}
    for site, row in after["by_site"].items():
        was = before["by_site"].get(site, {})
        d = {k: row[k] - was.get(k, 0) for k in row}
        if d["count"]:
            out[site] = d
    return out


def _caller_site(depth: int) -> str:
    """``module:function`` of the frame ``depth`` levels up: the site
    of a collective issued without one (an undeclared site)."""
    f = sys._getframe(depth + 1)
    return f"{f.f_globals.get('__name__', '?')}:{f.f_code.co_name}"


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

    def all_gather(self, t: torch.Tensor, *, site: str | None = None
                   ) -> list:
        """Every rank's ``t`` (same shape on every rank), in rank
        order, recorded at ``site`` (default: the caller's
        ``module:function``, which no contract declares)."""
        if self.size == 1:
            return [t]
        site = site or _caller_site(1)
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
        self.stats.record("all_gather", site, src, time.perf_counter() - t0)
        return parts

    def sum(self, t: torch.Tensor, *, site: str | None = None
            ) -> torch.Tensor:
        """The sum of every rank's ``t``, the same bits on every rank:
        gathered, then added in rank order."""
        parts = self.all_gather(t, site=site or _caller_site(1))
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def sum_parts(self, *ts: torch.Tensor, site: str | None = None
                  ) -> tuple:
        """``sum`` of several tensors of one dtype in one collective."""
        if self.size == 1:
            return ts
        flat = self.sum(torch.cat([t.reshape(-1) for t in ts]),
                        site=site or _caller_site(1))
        out, at = [], 0
        for t in ts:
            out.append(flat[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return tuple(out)

    def gather_rows(self, local: torch.Tensor, n: int, *,
                    site: str = SITE_ROW_GATHER) -> torch.Tensor:
        """The whole ``[n, ...]`` from every rank's ``[per, ...]`` share
        of rows (``local_rows``), cut back to ``n`` rows."""
        if self.size == 1:
            return local[:n]
        return torch.cat(self.all_gather(local, site=site))[:n]

    def barrier(self, *, site: str | None = None) -> None:
        if self.size == 1:
            return
        import torch.distributed as dist

        site = site or _caller_site(1)
        t0 = time.perf_counter()
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)
        self.stats.record("barrier", site, None, time.perf_counter() - t0)


def _group_world() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


# The CollectiveStats of each process group (None: the default group),
# shared by every Mesh made of it: one ordered census a process.
_GROUP_STATS: dict = {}


def group_stats(group=None) -> CollectiveStats:
    """The collectives this process issued on ``group``'s meshes (every
    ``make_mesh`` of it shares them); they stay readable after
    ``shutdown``, and ``init_from_env`` starts a new default group's
    afresh."""
    return _GROUP_STATS.setdefault(group, CollectiveStats())


def make_mesh(group=None, *, device=None) -> Mesh:
    """The mesh of every rank of ``group`` (default: the default
    process group), this process on ``device`` (default ``cuda``); its
    ``stats`` are the group's (``group_stats``)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is up: launch with "
            "torchrun (or set RANK, WORLD_SIZE and MASTER_ADDR/PORT) and "
            "call parallel.mesh.init_from_env")
    return Mesh(rank=dist.get_rank(group), size=dist.get_world_size(group),
                device=device_mod.resolve(device),
                backend=str(dist.get_backend(group)), group=group,
                stats=group_stats(group))


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
    _GROUP_STATS.pop(None, None)  # a new default group: a new census
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
            part = torch.cat([part, torch.full(  # photon: ignore[spmd-host-divergence] -- inert entities fill every rank's share to the same per
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


@dataclasses.dataclass(frozen=True, eq=False)
class FeatureShardedSparse:
    """ELL features sharded over the FEATURE axis (tensor-parallel GLM;
    the reference's ``FeatureShardedSparse``, ``parallel/mesh.py:
    367-385``).

    For a ``d`` too large to replicate comfortably, this rank owns the
    contiguous feature range ``[lo, lo + d_local)`` of the padded ``d``
    and holds only the ELL entries whose feature falls in it, with
    LOCAL ids (``local``: a ``SparseFeatures`` of ``d_local`` features,
    its entries compacted left per row). Rows, labels, offsets and
    weights stay whole on every rank. The coefficient vector, and with
    it every vector of the optimizer's state, is sharded the same way:
    the solve runs on this rank's ``[d_local]`` slice.

    - ``matvec``: this rank's partial margins summed over the ranks, one
      collective (``Mesh.sum`` at ``column.margins``);
    - ``rmatvec`` / ``rmatvec_sq``: local, no collective: each feature
      belongs to one rank. They reduce through the local slab's sorted
      transpose at the ``fixed_effect`` site, as ``SparseFeatures``'
      do (the segment-sum kernel on the card), where the reference
      scatters with ``.at[idx].add``.

    ``d`` is padded up to a multiple of the ranks; the padded
    coefficients receive no data gradient (L2 pins them at zero).
    ``logical_d`` is the caller's true feature count."""

    local: SparseFeatures  # [n, k_loc], local ids, d = d_local
    d: int  # padded to a multiple of the ranks
    logical_d: int
    mesh: Mesh
    lo: int  # this rank's first feature

    @property
    def d_local(self) -> int:
        return self.d // self.mesh.size

    @property
    def num_features(self) -> int:
        """The length of this rank's coefficient slice: every vector of
        the solve on this rank has it."""
        return self.d_local

    @property
    def num_rows(self) -> int:
        return self.local.num_rows

    @property
    def local_indices(self) -> torch.Tensor:
        return self.local.indices

    @property
    def local_values(self) -> torch.Tensor:
        return self.local.values

    def local_slice(self, w: torch.Tensor) -> torch.Tensor:
        """This rank's ``[d_local]`` slice of a whole vector (``[d]``, or
        ``[logical_d]`` as trained models are trimmed: re-padded with
        zeros first)."""
        if w.shape[0] < self.d:
            w = torch.cat([w, w.new_zeros(self.d - w.shape[0])])
        return w[self.lo:self.lo + self.d_local]

    def local_index(self, i: int | None) -> int | None:
        """Feature ``i``'s local index if this rank owns it, else None
        (the intercept's L2 exemption applies on its owner only)."""
        if i is None or not self.lo <= i < self.lo + self.d_local:
            return None
        return i - self.lo

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        """``X @ w`` over every rank's features. ``w`` is this rank's
        slice, or a whole vector (a trained model, ``[logical_d]`` or
        ``[d]``), whose slice is taken."""
        if w.shape[0] != self.d_local:
            w = self.local_slice(w)
        return self.mesh.sum(self.local.matvec(w), site=SITE_COLUMN_MARGINS)

    def rmatvec(self, g: torch.Tensor) -> torch.Tensor:
        return self.local.rmatvec(g)

    def rmatvec_sq(self, g: torch.Tensor) -> torch.Tensor:
        return self.local.rmatvec_sq(g)

    def gather(self, *slices: torch.Tensor) -> tuple:
        """The whole ``[d]`` vectors from every rank's slices of them, in
        one collective (``column.coefficient_gather``): the same bits on
        every rank."""
        parts = self.mesh.all_gather(torch.cat(slices),
                                     site=SITE_COEFFICIENT_GATHER)
        k = self.d_local
        return tuple(torch.cat([p[i * k:(i + 1) * k] for p in parts])
                     for i in range(len(slices)))


def shard_features_by_column(indices: np.ndarray, values: np.ndarray,
                             num_features: int, mesh: Mesh, *,
                             dtype: torch.dtype | None = None,
                             device=None) -> FeatureShardedSparse:
    """This rank's column shard of a host ELL slab ``[n, k]`` of global
    ids: the entries of its feature range ``[rank * d_local, (rank + 1)
    * d_local)`` with local ids, compacted left per row (reference
    :465-476), ``k_loc`` wide (this rank's longest row), on ``device``
    (default: the mesh's). Only this rank's range is built, and no
    collective is issued. The transpose plan holds this rank's entries
    alone, in the slab's row order: the pad slots a compacted row leaves
    (id 0, value 0) add nothing, and as one segment of up to ``n * k_loc``
    values they would be the segment sum's longest run."""
    if num_features < mesh.size:
        raise ValueError(
            f"column sharding needs at least one feature a rank: "
            f"{num_features} features over {mesh.size} ranks")
    indices = np.asarray(indices)
    values = np.asarray(values)
    d_pad = -(-num_features // mesh.size) * mesh.size
    d_local = d_pad // mesh.size
    lo = mesh.rank * d_local
    sel = (values != 0.0) & (indices // d_local == mesh.rank)
    k_loc = max(int(sel.sum(axis=1).max(initial=0)), 1)
    order = np.argsort(~sel, axis=1, kind="stable")[:, :k_loc]
    li = np.take_along_axis(np.where(sel, indices - lo, 0), order, axis=1)
    lv = np.take_along_axis(np.where(sel, values, 0.0), order, axis=1)
    dev = mesh.device if device is None else device_mod.resolve(device)
    if dtype is None:
        dtype = torch.from_numpy(values[:0]).dtype
    local = SparseFeatures(
        torch.from_numpy(np.ascontiguousarray(li, dtype=np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(lv)).to(dev, dtype),
        d_local)
    rows, slots = np.nonzero(sel)  # row-major: the slab's order
    object.__setattr__(local, "_plan", _sorted_transpose(
        torch.from_numpy(rows.astype(np.int64)).to(dev),
        torch.from_numpy((indices[rows, slots] - lo).astype(np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(values[rows, slots])).to(
            dev, dtype),
        int(indices.shape[0]), d_local))
    return FeatureShardedSparse(local=local, d=d_pad,
                                logical_d=num_features, mesh=mesh, lo=lo)
