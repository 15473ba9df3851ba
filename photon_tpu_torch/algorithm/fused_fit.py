"""Whole-fit fused coordinate descent: one CUDA-graph replay a GAME fit
(port of ``photon_tpu/algorithm/fused_fit.py``).

The unfused ``CoordinateDescent`` issues every bucket solve, scorer and
residual update from the host, and its solvers ask the card after every
iteration whether a lane still runs (a host sync each time). Here the
whole block-coordinate-descent fit, the fixed effect's L-BFGS solves, the
batched per-entity Newton, direct and quasi-Newton solves, the scoring
and the ``total - old + new`` residual algebra (CoordinateDescent.scala
:442,583), is one function, ``_fit_fn``, whose every loop is a
``utils.device_loop`` loop. On the card it is captured once into a CUDA
graph per static structure and per warm-start twin (cold and warm, as
the reference's ``max_programs=3`` counts the slab materialization, the
cold fit and the warm fit), and every later fit copies its operands
(warm-start tables, priors, the regularization weights as 0-d tensors,
locked scores) into the graph's static inputs and replays it: no host
sync between the dispatch and the read of the result, each solver loop a
conditional node. On the CPU the same function runs eagerly.

Semantics match the reference's fused fit, and the unfused loop's:
``_solve_block`` / ``run_impl`` are the primitives the unfused loop
calls, the fixed effect's L-BFGS runs as
``batched.single(batched.lbfgs, ...)`` (every branch a ``torch.where``)
in place of the host-branching ``lbfgs_solve``, and the weights stay
tensors so a configuration grid replays one graph with new lambdas.

Eligibility (``fuse_eligible``) is the reference's, reason for reason:
no listeners, no down-sampling, no fixed-effect box constraints, lazy
random-effect datasets. The estimator also keeps validation,
checkpoints, resume and the non-finite guard on the unfused loop. A
capture or replay that fails raises: nothing falls back to an eager run.

Under ``precision="bfloat16"`` (``ops/precision.py``) the slabs are
materialized in bf16 and each coordinate's score carry is stored in
bf16; a fresh score is rounded through bf16 before it enters the f32
total (``_quantize_score``), so ``total - old`` leaves no residue.

The warm capture (the reference's ahead-of-time compile during ingest):
``GameEstimator.prepare`` captures the graph of a skeleton generation
(``data.random_effect.skeleton_random_effect_dataset``: zero plan
tensors at the predicted shapes) on the ingest pipeline's compile pool
(``warm``; ``prepare`` waits for it at its end) and hands the future to
the generation's program. Its first ``run`` takes the artifact
(``_consume_aot``) and adopts the graph when the static key and every
operand's shape and dtype match, copying the generation's slabs, plan
and score maps into the graph's inputs once (``_adopt``); otherwise it
drops the graph and captures as before. On the CPU the warm stage
builds only the static key, and the first run stays the build of its
structure (not attributed). The reference's ``trace``,
``lower`` and ``lower_materialize`` are XLA entry points; they have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from photon_tpu_torch.algorithm.coordinate import FixedEffectCoordinate
from photon_tpu_torch.algorithm.coordinate_descent import (
    CoordinateDescentResult,
    CoordinateUpdateRecord,
    register_kernel_census,
)
from photon_tpu_torch.algorithm.problems import (
    VarianceComputationType,
    run_impl,
)
from photon_tpu_torch.algorithm.random_effect import (
    RandomEffectCoordinate,
    RandomEffectTrainingStats,
    _solve_block,
)
from photon_tpu_torch.data.random_effect import EntityBlocks
from photon_tpu_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    bucket_score_parts,
    bucket_slab,
    passive_raw_scores,
    score_raw_features,
)
from photon_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_tpu_torch.utils import device_loop

# Program contract (``python -m photon_tpu_torch.analysis --semantic``,
# machinery in analysis/program.py): a generation is the materialize and
# one CUDA graph per static structure and warm-start twin (cold and warm
# fit); a lambda sweep replays them with new weights, while an optimizer
# swap, an iteration-count change or a precision switch is a new
# structure by design. Nothing inside a captured fit syncs, and nothing
# in it is float64.
PROGRAM_AUDIT = dict(
    name="fused-fit",
    entry="algorithm.fused_fit.FusedFit (_mat_fn + the captured _fit_fn)",
    builder="build_fused_fit",
    max_programs=3,
    stable_under=("lambda_grid",),
    recompiles_on=("optimizer_swap", "iteration_count", "precision"),
    hot_loop=True,
)

# The cost ledger's names for the fit's two programs.
FIT_PROGRAM = "fused_fit"
MATERIALIZE_PROGRAM = "materialize"

# Replays of a captured fit, over the process.
replays = 0


class _PackedDiags:
    """All per-update diagnostic arrays of one fused fit, packed into ONE
    int32 device buffer; pulled to the host lazily, once, on the first
    diagnostic read."""

    def __init__(self, flat: torch.Tensor, shapes: list[tuple]):
        self._flat = flat
        self._shapes = shapes
        self._arrays: list[np.ndarray] | None = None

    def get(self, index: int) -> np.ndarray:
        if self._arrays is None:
            flat = self._flat.cpu().numpy()
            self._arrays = []
            o = 0
            for shape in self._shapes:
                size = int(np.prod(shape))
                self._arrays.append(flat[o:o + size].reshape(shape))
                o += size
            self._flat = None
        return self._arrays[index]


class FusedFixedEffectStats:
    """Per-update fixed-effect diagnostics from the fused fit: the
    ``OptResult`` attributes the reporting layer reads, pulled lazily
    through the packed diagnostics."""

    def __init__(self, packed: _PackedDiags, it_index: int, rs_index: int,
                 iteration: int):
        self._packed = packed
        self._it_index = it_index
        self._rs_index = rs_index
        self._iteration = iteration

    @property
    def iterations(self) -> int:
        return int(self._packed.get(self._it_index)[self._iteration])

    @property
    def convergence_reason(self) -> int:
        return int(self._packed.get(self._rs_index)[self._iteration])


def fuse_ineligibility_reasons(coords: dict, *, mesh=None,
                               emitter=None) -> list[str]:
    """Every reason this coordinate structure cannot ride the fused fit
    (the reference's words); an empty list means eligible."""
    reasons: list[str] = []
    if mesh is not None:
        reasons.append(
            "mesh execution: fusing would fold every coordinate's "
            "collectives into one program with no host serialization "
            "point between them — the unfused path serializes "
            "collective-bearing dispatches on CPU meshes "
            "(coordinate_descent._serialize_on_cpu_mesh) and keeps "
            "per-bucket programs independently shardable")
    if emitter is not None:
        reasons.append(
            "listeners: per-update events need a host boundary after "
            "each coordinate update; the fused program has none until "
            "the whole fit completes")
    for cid, coord in coords.items():
        inner = getattr(coord, "inner", coord)
        if isinstance(inner, FixedEffectCoordinate):
            rate = inner.config.down_sampling_rate
            if 0.0 < rate < 1.0:
                reasons.append(
                    f"coordinate {cid!r}: down-sampling reseeds per "
                    "iteration on host")
            if inner.config.optimizer.box_constraints is not None:
                reasons.append(
                    f"coordinate {cid!r}: box constraints run the "
                    "untraced solver path (constraint arrays would bake "
                    "in as trace constants)")
            rows = inner.batch.logical_rows
            if rows is not None and inner.batch.num_samples != rows:
                reasons.append(
                    f"coordinate {cid!r}: padded mesh batch "
                    "(num_samples != logical_rows) stays unfused")
            if getattr(inner.batch.features, "logical_d", None) is not None:
                reasons.append(
                    f"coordinate {cid!r}: column-sharded features solve "
                    "on the mesh path")
        elif isinstance(inner, RandomEffectCoordinate):
            if not inner.dataset.is_lazy:
                reasons.append(
                    f"coordinate {cid!r}: materialized score tables ride "
                    "the legacy scoring path")
        else:
            reasons.append(
                f"coordinate {cid!r}: unknown coordinate type "
                f"{type(inner).__name__}")
    return reasons


def fuse_eligible(coords: dict) -> bool:
    """True when every coordinate can ride the fused fit."""
    return not fuse_ineligibility_reasons(coords)


def _re_statics(coord: RandomEffectCoordinate) -> dict:
    """Static solver routing for one random-effect coordinate
    (``RandomEffectCoordinate._routes``), with each bucket's route
    (``RandomEffectCoordinate.bucket_routes``: a lazy bucket past the
    one-hot budget replays the densify kernel, then the Newton kernel
    or the batch-minor loop; a float64 one the ``ell`` route)."""
    cfg = coord.config
    direct, newton = coord._routes()
    return dict(
        routes=coord.bucket_routes(),
        task=coord.task,
        opt_config=cfg.optimizer,
        use_owlqn=cfg.l1_weight != 0.0,
        variance_computation=cfg.variance_computation,
        direct=direct,
        newton=newton,
    )


def fused_static_key(coords: dict, seq: list, num_iterations: int,
                     locked: set, precision: str = "float32") -> tuple:
    """Hashable descriptor of everything baked into a captured fit.
    Initial models are not part of it: warm-start tables are always
    operands (zeros when absent)."""
    from photon_tpu_torch.ops import precision as precision_mod

    parts: list = [
        tuple(seq), num_iterations, tuple(sorted(locked)),
        precision_mod.resolve(precision),
    ]
    for cid in seq:
        inner = getattr(coords[cid], "inner", coords[cid])
        if isinstance(inner, FixedEffectCoordinate):
            cfg = inner.config
            parts.append((
                cid, "fixed", inner.problem.task, cfg.optimizer,
                cfg.l1_weight != 0.0, cfg.variance_computation,
                inner.problem.intercept_index,
                inner.problem.prior is not None,
                inner.problem.normalization.factors is not None,
                inner.problem.normalization.shifts is not None,
                inner.batch.num_samples, inner.batch.num_features,
            ))
        else:
            ds = inner.dataset
            st = _re_statics(inner)
            parts.append((
                cid, "random", st["task"], st["opt_config"],
                st["use_owlqn"], st["variance_computation"], st["direct"],
                st["newton"], inner.prior is not None,
                inner.normalization.factors is not None,
                inner.normalization.shifts is not None,
                ds.num_entities, ds.max_sub_dim,
                tuple((tuple(b.row_ids.shape), tuple(b.proj.shape))
                      for b in ds.blocks),
                st["routes"],
            ))
    return tuple(parts)


def _nbytes(blocks) -> int:
    return sum(t.numel() * t.element_size() for b in blocks
               for t in (getattr(b, f.name) for f in dataclasses.fields(b))
               if isinstance(t, torch.Tensor))


class _Captured:
    """One captured fit: the graph, its static inputs and outputs, and
    what the capture recorded."""

    def __init__(self, graph, ops, out, *, seconds: float,
                 instantiate_seconds: float | None, nodes: int | None,
                 conditional_nodes: int, newton: dict, segment: dict):
        self.graph = graph
        self.ops = ops
        self.out = out
        # The materialized slabs the graph reads: set for a warm capture,
        # whose own skeleton slabs the generation's replace at adoption.
        self.ebs_all = None
        # Whether a warm capture's graph was adopted by a generation.
        self.adopted = False
        self.seconds = seconds
        self.instantiate_seconds = instantiate_seconds
        self.nodes = nodes
        self.conditional_nodes = conditional_nodes
        # Kernel launches the capture recorded, by Newton bucket shape
        # and by segment-sum site (one a body, whatever its trip count).
        self.newton = newton
        self.segment = segment
        self.replays = 0


# Operand keys whose tensors change from fit to fit: copied into the
# graph's static inputs before every replay. Every other operand (the
# batches, normalization, score maps, raw shards) is fixed for the
# generation and read in place.
_VARIABLE = ("w0", "l1", "l2", "iw", "prior", "z")


def _leaves(value) -> list:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _leaves(v)]
    return []


def _all_tensors(value) -> list:
    """Every tensor inside ``value``: dicts (in order), sequences and
    dataclasses (their fields) walked."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        return [t for v in value.values() for t in _all_tensors(v)]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _all_tensors(v)]
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return [t for f in dataclasses.fields(value)
                for t in _all_tensors(getattr(value, f.name))]
    return []


def _fixed_operands(ops) -> tuple:
    """The operands read in place (every key but ``_VARIABLE``'s)."""
    return tuple({k: v for k, v in op.items() if k not in _VARIABLE}
                 for op in ops)


class FusedFit:
    """One estimator generation's whole-fit program. ``run`` assembles
    the operands from the current coordinates, so later configurations
    of a grid (same structure, new lambdas) replay the same graph."""

    def __init__(self, coords: dict, update_sequence: list,
                 num_iterations: int, locked_coordinates: set | None = None,
                 mat_share: dict | None = None,
                 precision: str = "float32"):
        from photon_tpu_torch.ops import precision as precision_mod

        self.seq = list(update_sequence)
        self.num_iterations = num_iterations
        self.locked = set(locked_coordinates or ())
        self.precision = precision_mod.resolve(precision)
        self.kinds: dict[str, str] = {}
        self._re_meta: dict[str, dict] = {}
        for cid in self.seq:
            inner = getattr(coords[cid], "inner", coords[cid])
            if cid in self.locked:
                self.kinds[cid] = "locked"
            elif isinstance(inner, FixedEffectCoordinate):
                self.kinds[cid] = "fixed"
            else:
                self.kinds[cid] = "random"
                ds = inner.dataset
                keep = np.zeros(ds.num_entities, bool)
                for codes in ds.block_codes_np:
                    keep[codes[codes < ds.num_entities]] = True
                _, passive = ds.covered_row_partition()
                self._re_meta[cid] = {
                    "keep": keep,
                    "passive": passive if passive.size else None,
                    "n_blocks": len(ds.blocks),
                }
        self._norms = [
            getattr(coords[cid], "inner", coords[cid]).problem.normalization
            if self.kinds[cid] == "fixed" else None
            for cid in self.seq]
        self._mat_cache: dict | None = None
        self._mat_shared = mat_share
        self._zeros_cache: dict = {}
        self._graphs: dict = {}
        # The warm capture's future (``GameEstimator._attach_aot``) and,
        # once consumed, the artifact this program adopted.
        self._aot_future = None
        self._aot: dict | None = None
        # Static structures already run eagerly (the CPU's counterpart
        # of a captured graph, for the attribution window).
        self._seen: set = set()
        self.static_key = None  # set by the estimator cache
        self.device = None

    # ------------------------------------------------------------------
    # operand assembly (per run; cheap)
    # ------------------------------------------------------------------

    def _mat_fn(self, coords) -> dict:
        """Every random-effect bucket's slab on the device, once a
        dataset generation (eager, outside any graph): the dataset's
        cached blocks, a bucket past its slab budget gathered here, each
        slab cast to the storage precision (reference :532-541), plus
        the scoring plan and projector table. A sparse fixed effect's
        transpose plan is built here too, so no cache fills inside a
        capture."""
        from photon_tpu_torch.ops import precision as precision_mod

        mixed = precision_mod.is_mixed(self.precision)
        out = {}
        for cid in self.seq:
            inner = getattr(coords[cid], "inner", coords[cid])
            kind = self.kinds[cid]
            if kind == "fixed":
                plan = getattr(inner.batch.features, "transpose_plan", None)
                if plan is not None:
                    plan()
                continue
            if kind != "random":
                continue
            ds = inner.dataset
            ebs = tuple(
                b if isinstance(b, EntityBlocks) else b.materialize(None)
                for b in ds.device_blocks())
            if mixed:
                ebs = tuple(dataclasses.replace(
                    eb, x_values=precision_mod.in_storage(
                        eb.x_values, self.precision)) for eb in ebs)
            out[cid] = {
                "ebs": ebs,
                "codes": tuple(eb.entity_codes for eb in ebs),
                "proj_dev": ds.proj_device(),
                "score_inv": ds.score_inv_device(),
            }
        return out

    def _zeros(self, shape, dtype, device) -> torch.Tensor:
        key = (shape, dtype, str(device))
        z = self._zeros_cache.get(key)
        if z is None:
            z = self._zeros_cache[key] = torch.zeros(shape, dtype=dtype,
                                                     device=device)
        return z

    @staticmethod
    def _weights(cfg, dtype, device) -> dict:
        """The regularization weights as 0-d tensors: a graph replays
        them from its inputs, so a lambda grid never bakes one in. Made
        by a fill on the device, not a copy from the host (which would
        wait for the card)."""
        return {k: torch.full((), v, dtype=dtype, device=device) for k, v in (
            ("l1", cfg.l1_weight), ("l2", cfg.l2_weight),
            ("iw", cfg.incremental_weight))}

    def _operands(self, coords, initial_models) -> tuple:
        ops = []
        for cid in self.seq:
            coord = coords[cid]
            kind = self.kinds[cid]
            if kind == "locked":
                if not initial_models or cid not in initial_models:
                    raise KeyError(
                        f"locked coordinate {cid!r} requires a model "
                        "in initial_models "
                        "(partialRetrainLockedCoordinates)")
                ops.append({"z": coord.score(initial_models[cid])})
                continue
            inner = getattr(coord, "inner", coord)
            cfg = inner.config
            if kind == "fixed":
                batch = inner.batch
                dtype, dev = batch.labels.dtype, batch.labels.device
                d = batch.num_features
                init = None
                if initial_models and cid in initial_models:
                    m = initial_models[cid]
                    glm = m.model if hasattr(m, "model") else m
                    means = glm.coefficients.means.to(dtype)
                    if means.shape[0] < d:
                        means = torch.nn.functional.pad(
                            means, (0, d - means.shape[0]))
                    init = means
                prior = None
                if inner.problem.prior is not None:
                    p = inner.problem.prior
                    if p.variances is None:
                        raise ValueError(
                            "incremental training requires prior variances "
                            "(GameEstimator.scala:241-382 invariants)")
                    prior = (p.means.to(dtype), p.variances.to(dtype))
                ops.append({
                    "batch": batch,
                    "w0": init if init is not None
                    else self._zeros((d,), dtype, dev),
                    **self._weights(cfg, dtype, dev),
                    "prior": prior,
                })
            else:
                ds = inner.dataset
                dtype, dev = ds.dtype, ds.device
                inner.check_trainable()
                w0 = None
                if initial_models and cid in initial_models:
                    w0 = initial_models[cid].coefficients.to(dtype)
                prior = None
                if inner.prior is not None:
                    prior = (inner.prior.coefficients.to(dtype),
                             inner.prior.variances.to(dtype))
                pas = (ds.passive_rows_device()
                       if self._re_meta[cid]["passive"] is not None
                       else None)
                ops.append({
                    "w0": w0 if w0 is not None else self._zeros(
                        (ds.num_entities, ds.max_sub_dim), dtype, dev),
                    **self._weights(cfg, dtype, dev),
                    "prior": prior,
                    "factors": inner.normalization.factors,
                    "shifts": inner.normalization.shifts,
                    "score_codes": ds.score_codes,
                    "raw": ds.raw,
                    "passive": pas,
                })
        return tuple(ops)

    def _statics(self, coords, initial_models) -> tuple:
        st = []
        for cid in self.seq:
            kind = self.kinds[cid]
            has_init = bool(initial_models and cid in initial_models)
            if kind == "locked":
                st.append(("locked",))
                continue
            inner = getattr(coords[cid], "inner", coords[cid])
            if kind == "fixed":
                cfg = inner.config
                st.append((
                    "fixed", inner.problem.task, cfg.optimizer,
                    cfg.l1_weight != 0.0, inner.problem.intercept_index,
                    cfg.variance_computation, has_init,
                ))
            else:
                s = _re_statics(inner)
                st.append((
                    "random", s["task"], s["opt_config"], s["use_owlqn"],
                    s["variance_computation"], s["direct"], s["newton"],
                    has_init,
                ))
        return tuple(st)

    # ------------------------------------------------------------------
    # the fit
    # ------------------------------------------------------------------

    def _re_score(self, w, op, mat):
        """Model contribution per canonical row (active and passive):
        the bucket slabs' scores and the passive rows' raw-feature
        scores concatenated, put in row order by one gather (the unfused
        ``_score_via_buckets``; an ELL bucket scores from its slots and
        values)."""
        n = op["score_codes"].shape[0]
        proj_dev = mat["proj_dev"]
        if mat["score_inv"] is None:
            return score_raw_features(w, op["score_codes"], op["raw"],
                                      proj_dev)
        parts = bucket_score_parts(
            w, tuple(bucket_slab(eb) for eb in mat["ebs"]), mat["codes"])
        if op["passive"] is not None:
            parts.append(passive_raw_scores(
                w, op["passive"], op["score_codes"], op["raw"], proj_dev))
        if not parts:
            return torch.zeros(n, dtype=w.dtype, device=w.device)
        return torch.cat(parts)[mat["score_inv"]].to(w.dtype)

    @staticmethod
    def _fe_score(means, batch):
        return Coefficients(means=means).compute_score(batch.features)

    def _store_score(self, z):
        """A score carry's storage: bf16 under mixed precision (the carry
        is re-read every sweep), ``z`` itself on the f32 path."""
        if self.precision == "bfloat16":
            return z.to(torch.bfloat16)
        return z

    def _quantize_score(self, z):
        """Round a fresh score through the storage dtype before it enters
        the total, so the f32 total is the exact sum of the stored
        carries and ``total - old`` leaves no quantization residue
        (bf16(f32(bf16(z))) == bf16(z)); ``z`` itself on the f32 path."""
        if self.precision == "bfloat16":
            return z.to(torch.bfloat16).to(torch.float32)
        return z

    @staticmethod
    def _read_score(zs, dtype):
        """A stored carry back in the total's dtype."""
        return zs if zs.dtype == dtype else zs.to(dtype)

    def _fit_fn(self, ops, ebs_all, statics):
        num_iters = self.num_iterations
        conv_index = {
            i: j for j, i in enumerate(
                i for i, st in enumerate(statics) if st[0] != "locked")}
        states: list = []
        scores: list = []
        diags: list = []
        total = None
        for i, (op, st) in enumerate(zip(ops, statics)):
            kind = st[0]
            if kind == "locked":
                states.append(())
                z = op["z"]
                diags.append(())
            elif kind == "fixed":
                means = op["w0"]
                variances = (None if st[5] == VarianceComputationType.NONE
                             else torch.zeros_like(means))
                states.append((means, variances))
                z = (self._fe_score(means, op["batch"]) if st[-1]
                     else torch.zeros(op["batch"].num_samples,
                                      dtype=means.dtype,
                                      device=means.device))
                diags.append((
                    torch.zeros(num_iters, dtype=torch.int32,
                                device=means.device),
                    torch.zeros(num_iters, dtype=torch.int32,
                                device=means.device)))
            else:
                w_all = op["w0"]
                e = w_all.shape[0]
                v_all = (None if st[4] == VarianceComputationType.NONE
                         else torch.zeros_like(w_all))
                states.append((w_all, v_all))
                z = (self._re_score(w_all, op, ebs_all[self.seq[i]])
                     if st[-1]
                     else torch.zeros(op["score_codes"].shape[0],
                                      dtype=w_all.dtype,
                                      device=w_all.device))
                diags.append((
                    torch.zeros((num_iters, e), dtype=torch.int32,
                                device=w_all.device),
                    torch.zeros((num_iters, e), dtype=torch.int32,
                                device=w_all.device)))
            z = self._quantize_score(z)
            total = z if total is None else total + z
            scores.append(self._store_score(z))
        conv = torch.zeros((num_iters, len(conv_index), 5),
                           dtype=total.dtype, device=total.device)
        for it in range(num_iters):
            for i, (op, st) in enumerate(zip(ops, statics)):
                kind = st[0]
                if kind == "locked":
                    continue
                z_old = self._read_score(scores[i], total.dtype)
                residual = total - z_old
                if kind == "fixed":
                    _, task, opt_config, use_owlqn, intercept_index, \
                        var_comp = st[:6]
                    batch = op["batch"]
                    prev_means = states[i][0]
                    means, variances, result = run_impl(
                        batch.with_offsets(batch.offsets + residual),
                        prev_means, op["l1"], op["l2"], self._norms[i],
                        op["prior"], op["iw"], task=task,
                        opt_config=opt_config,
                        intercept_index=intercept_index,
                        variance_computation=var_comp,
                        use_owlqn=use_owlqn, device_loops=True)
                    states[i] = (means, variances)
                    z = self._fe_score(means, batch)
                    diags[i][0][it] = result.iterations
                    diags[i][1][it] = result.convergence_reason
                    conv_loss = result.value
                    conv_gnorm = result.gradient_norm
                    conv_wd = torch.sum((means - prev_means) ** 2)
                    conv_wn = torch.sum(means ** 2)
                else:
                    _, task, opt_config, use_owlqn, var_comp, direct, \
                        newton = st[:7]
                    w_prev, v_prev = states[i]
                    w_all = torch.zeros_like(w_prev)
                    v_all = (None if v_prev is None
                             else torch.zeros_like(v_prev))
                    e = w_prev.shape[0]
                    its_e = torch.zeros(e + 1, dtype=torch.int32,
                                        device=w_prev.device)
                    rs_e = torch.zeros(e + 1, dtype=torch.int32,
                                       device=w_prev.device)
                    mat = ebs_all[self.seq[i]]
                    for eb in mat["ebs"]:
                        w_all, v_all, its, rs = _solve_block(
                            eb, residual, op["factors"], op["shifts"],
                            w_prev, op["l1"], op["l2"], op["iw"],
                            op["prior"], w_all, v_all, sub_dim=eb.sub_dim,
                            task=task, opt_config=opt_config,
                            variance_computation=var_comp, direct=direct,
                            newton=newton, use_owlqn=use_owlqn,
                            precision=self.precision)
                        # Codes past the table (padding) land in a dump
                        # slot that is cut off below.
                        idx = eb.entity_codes.long().clamp(max=e)
                        its_e[idx] = its.to(torch.int32)
                        rs_e[idx] = rs.to(torch.int32)
                    states[i] = (w_all, v_all)
                    z = self._re_score(w_all, op, mat)
                    diags[i][0][it] = its_e[:e]
                    diags[i][1][it] = rs_e[:e]
                    conv_loss = torch.zeros((), dtype=total.dtype,
                                            device=total.device)
                    conv_gnorm = conv_loss
                    conv_wd = torch.sum((w_all - w_prev) ** 2)
                    conv_wn = torch.sum(w_all ** 2)
                z = self._quantize_score(z)
                conv[it, conv_index[i]] = torch.stack([
                    conv_loss.to(total.dtype),
                    conv_gnorm.to(total.dtype),
                    torch.sum((z - z_old) ** 2).to(total.dtype),
                    conv_wd.to(total.dtype),
                    conv_wn.to(total.dtype),
                ])
                total = total - z_old + z
                scores[i] = self._store_score(z)
        flat_parts = [d.reshape(-1) for pair in diags for d in pair]
        packed = (torch.cat(flat_parts) if flat_parts
                  else torch.zeros(0, dtype=torch.int32,
                                   device=total.device))
        return tuple(states), tuple(scores), total, packed, conv

    # ------------------------------------------------------------------
    # the graph
    # ------------------------------------------------------------------

    @staticmethod
    def _owned(ops) -> tuple:
        """The capture's operands: this run's, with the variable ones
        cloned (the graph reads them in place on every replay)."""
        return tuple({k: (_clone_tree(v) if k in _VARIABLE else v)
                      for k, v in op.items()} for op in ops)

    def _capture(self, ops, ebs_all, statics) -> _Captured:
        """Capture ``_fit_fn`` on these operands (which become the
        graph's static inputs). One eager pass runs first, on a side
        stream, so every lazy state (cuBLAS and solver workspaces,
        kernel libraries) is set up outside the graph; its results are
        dropped."""
        from photon_tpu_torch.ops import newton_kernel, segment_reduce

        dev = self.device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._fit_fn(ops, ebs_all, statics)
        torch.cuda.current_stream(dev).wait_stream(side)
        # The stream, not the device: another thread may be capturing.
        side.synchronize()
        newton0 = dict(newton_kernel.launches_by_shape)
        segment0 = dict(segment_reduce.launches_by_site)
        graph = device_loop.new_graph()
        t0 = time.perf_counter()
        with device_loop.capture(graph, dev) as cap:
            out = self._fit_fn(ops, ebs_all, statics)
        seconds = time.perf_counter() - t0
        inst = None
        if hasattr(graph, "instantiate"):
            try:
                t1 = time.perf_counter()
                graph.instantiate()
                inst = time.perf_counter() - t1
            except RuntimeError:
                inst = None
        return _Captured(
            graph, ops, out, seconds=seconds, instantiate_seconds=inst,
            nodes=device_loop.graph_nodes(cap),
            conditional_nodes=cap.conditional_nodes,
            newton={k: v - newton0.get(k, 0)
                    for k, v in newton_kernel.launches_by_shape.items()
                    if v > newton0.get(k, 0)},
            segment={k: v - segment0.get(k, 0)
                     for k, v in segment_reduce.launches_by_site.items()
                     if v > segment0.get(k, 0)})

    @staticmethod
    def _load_inputs(cap: _Captured, ops) -> None:
        """Copy this run's variable operands into the graph's inputs."""
        for dst, src in zip(cap.ops, ops):
            for key in _VARIABLE:
                if key not in dst:
                    continue
                a, b = _leaves(dst[key]), _leaves(src[key])
                if len(a) != len(b):
                    raise RuntimeError(
                        f"fused fit: operand {key!r} changed structure "
                        "since its capture")
                for t_dst, t_src in zip(a, b):
                    if t_dst is not t_src:
                        t_dst.copy_(t_src)

    def captured(self, statics=None) -> _Captured | None:
        """The captured graph of ``statics`` (the latest one without)."""
        if statics is None:
            return next(reversed(self._graphs.values()), None)
        return self._graphs.get(statics)

    def _execute(self, ops, ebs_all, statics):
        """The fit's outputs: on the card a replay of the statics' graph
        (captured on first use), cloned so the next replay cannot
        overwrite them; on the CPU the eager fit. Returns (outputs,
        whether this call captured)."""
        global replays
        if self.device.type != "cuda":
            # The first run of a static structure stands for its build:
            # its window is not attributed, as a capture's is not.
            fresh = statics not in self._seen
            self._seen.add(statics)
            return self._fit_fn(ops, ebs_all, statics), fresh
        cap = self._graphs.get(statics)
        fresh = cap is None
        if fresh:
            cap = self._graphs[statics] = self._capture(
                self._owned(ops), ebs_all, statics)
        else:
            self._load_inputs(cap, ops)
        cap.graph.replay()
        cap.replays += 1
        replays += 1
        return _clone_tree(cap.out), fresh

    # ------------------------------------------------------------------
    # the warm capture
    # ------------------------------------------------------------------

    def warm(self, coords, device) -> dict:
        """The warm stage's build on a skeleton generation's coordinates:
        the statics and, on the card, the graph captured on the
        skeleton's operands (``_capture``'s eager pass first: on zero
        plan tensors every bucket has zero weights, so each solver
        stops at its first test). On the CPU nothing is captured and no
        operand is assembled."""
        statics = self._statics(coords, None)
        if torch.device(device).type != "cuda":
            return {"statics": statics, "captured": None}
        ops = self._operands(coords, None)
        self.device = _device_of(ops)
        ebs_all = self._mat_fn(coords)
        cap = self._capture(self._owned(ops), ebs_all, statics)
        cap.ebs_all = ebs_all
        return {"statics": statics, "captured": cap}

    def _consume_aot(self) -> dict | None:
        """The warm stage's artifact (waited for inside ``compile_wait``
        if a caller cut its prepare short), or None when there is none
        or it belongs to another static structure (then it is dropped
        here, on the calling thread, outside any capture)."""
        fut = self._aot_future
        if fut is None:
            return None
        from photon_tpu_torch.data.pipeline import PIPELINE_STATS

        self._aot_future = None
        with PIPELINE_STATS.stage("compile_wait"):
            art = fut.result()
        if art is None or art["key"] != self.static_key:
            return None
        return art

    def _adopt(self, art: dict, coords, ops, ebs_all, statics) -> dict:
        """Take the warm artifact for ``statics`` when it fits; returns
        the materialized slabs the generation keeps.

        On the card the graph is adopted when every operand it reads in
        place (``_fixed_operands``, the slabs, plan and score maps) has
        this generation's shape, dtype and device: each is copied into
        the graph's own buffer once, the dataset caches that held the
        same blocks take the graph's, and the generation's copies are
        freed. Otherwise the artifact is dropped and the first run
        captures. On the CPU there is no graph: the artifact is only
        recorded as taken."""
        if art["statics"] != statics:
            return ebs_all
        cap = art["captured"]
        if cap is None:
            self._aot = art
            return ebs_all
        dst = _all_tensors((_fixed_operands(cap.ops), cap.ebs_all))
        src = _all_tensors((_fixed_operands(ops), ebs_all))
        if len(dst) != len(src) or any(
                a.shape != b.shape or a.dtype != b.dtype
                or a.device != b.device for a, b in zip(dst, src)):
            return ebs_all
        for a, b in zip(dst, src):
            if a.data_ptr() != b.data_ptr():
                a.copy_(b)
        warm_ebs = cap.ebs_all
        for cid, mat in ebs_all.items():
            ds = getattr(coords[cid], "inner", coords[cid]).dataset
            cached = ds.__dict__.get("_device_blocks")
            if cached:
                object.__setattr__(ds, "_device_blocks", tuple(
                    w if c is g else c for c, g, w in zip(
                        cached, mat["ebs"], warm_ebs[cid]["ebs"])))
            if ds.__dict__.get("_score_inv") is mat["score_inv"]:
                object.__setattr__(ds, "_score_inv",
                                   warm_ebs[cid]["score_inv"])
        cap.adopted = True
        self._graphs[statics] = cap
        self._aot = art
        return warm_ebs

    def slab_nbytes(self) -> int:
        """Device bytes of this generation's materialized design slabs
        (``x_values``; half the f32 bytes under bf16), 0 before the
        first run."""
        share = self._mat_shared
        ebs_all = (share.get("ebs") if share is not None
                   else self._mat_cache)
        if not ebs_all:
            return 0
        return sum(eb.x_values.numel() * eb.x_values.element_size()
                   for mat in ebs_all.values() for eb in mat["ebs"])

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------

    def _attribute_seconds(self, total_seconds: float, ops,
                           packed: _PackedDiags, diag_index
                           ) -> dict | None:
        """Per-(iteration, coordinate) attribution of the fit's measured
        wall, proportional to each block's analytic work from the
        measured solver iteration counts (the reference's formula).
        Shares sum to the measurement; None when nothing is
        attributable."""
        weights: dict = {}
        for i, cid in enumerate(self.seq):
            kind = self.kinds[cid]
            if kind == "locked":
                continue
            it_idx, _ = diag_index[cid]
            iters = packed.get(it_idx)
            if kind == "fixed":
                n = ops[i]["batch"].num_samples
                d = ops[i]["batch"].num_features
                for it in range(self.num_iterations):
                    weights[(it, cid)] = (
                        (4.0 * max(float(iters[it]), 1.0) + 2.0) * n * d)
            else:
                n_re = int(ops[i]["score_codes"].shape[0])
                _, s = ops[i]["w0"].shape
                keep = self._re_meta[cid]["keep"]
                kept = int(keep.sum())
                for it in range(self.num_iterations):
                    its_it = iters[it][keep] if kept else iters[it]
                    mean_it = max(
                        float(np.mean(its_it)) if its_it.size else 1.0, 1.0)
                    weights[(it, cid)] = (
                        mean_it * (6.0 * s + 2.0 * s * s) * n_re
                        + max(kept, 1) * s ** 3 / 3.0
                        + 2.0 * n_re * s)
        total_w = sum(weights.values())
        if total_w <= 0.0:
            return None
        scale = float(total_seconds) / total_w
        return {k: v * scale for k, v in weights.items()}

    def _ledger_record(self, sp, mat_window, t_fit0, rec_seconds,
                       ebs_all, cap) -> None:
        """Cost-ledger accounting of one measured fit: the two programs
        (measured-only: no static count covers a loop of solver
        iterations), the census rows of every Newton bucket shape and
        segment-sum site the graph launches, the materialize and fit
        windows (per-coordinate parts when the window was pure), the
        slabs' resident bytes and the rest as ``unattributed``."""
        from photon_tpu_torch.obs import ledger

        ledger.register_program(MATERIALIZE_PROGRAM, phase="materialize")
        ledger.register_program(FIT_PROGRAM, phase="fit")
        if cap is not None:
            register_kernel_census(cap.newton, cap.segment)
        mat_seconds = 0.0
        if mat_window is not None:
            t0, t1 = mat_window
            mat_seconds = t1 - t0
            ledger.record_dispatch(MATERIALIZE_PROGRAM, mat_seconds,
                                   phase="materialize", start=t0, end=t1)
            ledger.set_resident(f"{FIT_PROGRAM}/slabs", sum(
                _nbytes(m["ebs"]) for m in ebs_all.values()))
        fit_seconds = max(sp.t1 - t_fit0, 0.0)
        parts = None
        if rec_seconds:
            parts = {}
            for (_, cid), s in rec_seconds.items():
                parts[cid] = parts.get(cid, 0.0) + s
        ledger.record_dispatch(FIT_PROGRAM, fit_seconds, phase="fit",
                               start=t_fit0, end=sp.t1, parts=parts)
        ledger.record_unattributed(
            max(sp.seconds - fit_seconds - mat_seconds, 0.0))

    # ------------------------------------------------------------------
    # the public entry
    # ------------------------------------------------------------------

    def models(self, coords, states, initial_models=None) -> GameModel:
        """The fit's ``GameModel`` from its output states (a locked
        coordinate's model passes through from ``initial_models``)."""
        models: dict = {}
        for i, cid in enumerate(self.seq):
            kind = self.kinds[cid]
            if kind == "locked":
                models[cid] = initial_models[cid]
                continue
            inner = getattr(coords[cid], "inner", coords[cid])
            if kind == "fixed":
                means, variances = states[i]
                glm = GeneralizedLinearModel(
                    Coefficients(means=means, variances=variances),
                    inner.problem.task)
                models[cid] = FixedEffectModel(
                    glm, coords[cid].feature_shard_id)
            else:
                ds = inner.dataset
                w_all, v_all = states[i]
                models[cid] = RandomEffectModel(
                    coefficients=w_all,
                    random_effect_type=ds.config.random_effect_type,
                    feature_shard_id=ds.config.feature_shard_id,
                    task=inner.task,
                    proj_all=ds.proj_all,
                    variances=v_all,
                    entity_keys=ds.entity_keys)
        return GameModel(models)

    def run(self, coords: dict, initial_models: dict | None = None
            ) -> CoordinateDescentResult:
        from photon_tpu_torch import obs
        from photon_tpu_torch.resilience import faults, retry

        # With telemetry on, the span syncs on the fit's outputs at exit
        # (the one host sync of a fit, where the caller's first read
        # would wait anyway); off, it is a no-op and the replay stays
        # asynchronous.
        cap = None
        with obs.span("fused_fit") as sp:
            ops = self._operands(coords, initial_models)
            statics = self._statics(coords, initial_models)
            if self.device is None:
                self.device = _device_of(ops)
            aot = self._consume_aot()
            mat_window = None
            share = self._mat_shared
            ebs_all = (share.get("ebs") if share is not None
                       else self._mat_cache)
            if ebs_all is None:
                t_m0 = time.perf_counter()
                ebs_all = self._mat_fn(coords)
                if aot is not None:
                    ebs_all = self._adopt(aot, coords, ops, ebs_all, statics)
                mat_window = (t_m0, time.perf_counter())
                if share is not None:
                    share["ebs"] = ebs_all
                else:
                    self._mat_cache = ebs_all
            elif aot is not None:
                self._adopt(aot, coords, ops, ebs_all, statics)
            del aot
            t_fit0 = time.perf_counter()
            fit_window_pure = True

            def dispatch_once():
                # The fault point fires before the graph is entered, so
                # an injected transient fault exercises the retry with no
                # device state touched; a retry re-runs the whole
                # dispatch, which is idempotent (the inputs are reloaded).
                nonlocal fit_window_pure
                faults.check("fit.dispatch")
                out, fresh = self._execute(ops, ebs_all, statics)
                # A capture inside the window is not pure fit execution.
                fit_window_pure = fit_window_pure and not fresh
                return out

            def _mark_impure(attempt, exc):
                nonlocal fit_window_pure
                fit_window_pure = False

            out = retry.call_with_retry(
                dispatch_once, site="fused_fit.dispatch",
                on_retry=_mark_impure)
            states, scores, total, packed_flat, conv = out
            cap = self._graphs.get(statics)
            if sp is not None:
                sp.sync = out
        conv_ids = tuple(cid for cid in self.seq
                         if self.kinds[cid] != "locked")
        if sp is not None:
            obs.convergence.record(conv_ids, conv)
            obs.REGISTRY.counter("fused_fits_total").inc()
            obs.REGISTRY.histogram("fused_fit_wall_seconds").observe(
                sp.seconds)
            if sp.device_wait_seconds is not None:
                obs.REGISTRY.histogram(
                    "fused_fit_device_wait_seconds").observe(
                        sp.device_wait_seconds)
        # Numerics sentinel: park the same convergence block (a reference
        # only: no sync, no copy).
        if obs.health.enabled():
            obs.health.sentinel_watch(conv_ids, conv)
        shapes: list = []
        diag_index: dict = {}
        t = self.num_iterations
        for i, cid in enumerate(self.seq):
            kind = self.kinds[cid]
            if kind == "locked":
                continue
            shape = (t,) if kind == "fixed" else (t, ops[i]["w0"].shape[0])
            diag_index[cid] = (len(shapes), len(shapes) + 1)
            shapes.extend([shape, shape])
        packed = _PackedDiags(packed_flat, shapes)
        rec_seconds = None
        if sp is not None and sp.device_wait_seconds is not None:
            fit_seconds = max(sp.t1 - t_fit0, 0.0)
            if sp.attrs is None:
                sp.attrs = {}
            sp.attrs["fit_seconds"] = round(fit_seconds, 6)
            sp.attrs["fit_window_pure"] = fit_window_pure
            if fit_window_pure:
                rec_seconds = self._attribute_seconds(
                    fit_seconds, ops, packed, diag_index)
        from photon_tpu_torch.obs import ledger

        if ledger.enabled() and sp is not None:
            self._ledger_record(sp, mat_window, t_fit0, rec_seconds,
                                ebs_all, cap)
        final = self.models(coords, states, initial_models)
        history: list = []
        for it in range(self.num_iterations):
            for i, cid in enumerate(self.seq):
                kind = self.kinds[cid]
                if kind == "locked":
                    continue
                it_idx, rs_idx = diag_index[cid]
                if kind == "fixed":
                    diag = FusedFixedEffectStats(packed, it_idx, rs_idx, it)
                else:
                    keep = self._re_meta[cid]["keep"]
                    diag = RandomEffectTrainingStats.from_thunk(
                        lambda packed=packed, it_idx=it_idx,
                        rs_idx=rs_idx, it=it, keep=keep: (
                            packed.get(rs_idx)[it][keep],
                            packed.get(it_idx)[it][keep]))
                history.append(CoordinateUpdateRecord(
                    iteration=it, coordinate_id=cid,
                    seconds=(None if rec_seconds is None
                             else rec_seconds[(it, cid)]),
                    diagnostics=diag, evaluation=None))
        return CoordinateDescentResult(
            model=final, best_model=final, best_evaluation=None,
            history=tuple(history))


def _clone_tree(value):
    if isinstance(value, torch.Tensor):
        return value.clone()
    if isinstance(value, tuple):
        return tuple(_clone_tree(v) for v in value)
    if isinstance(value, list):
        return [_clone_tree(v) for v in value]
    return value


def _device_of(ops) -> torch.device:
    for op in ops:
        for key in ("w0", "z"):
            if key in op:
                return op[key].device
    raise ValueError("fused fit: no operand to take the device from")
