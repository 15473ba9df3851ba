"""The program tier: contracts on the programs the port dispatches (port
of ``photon_tpu/analysis/program.py``, the reference's tier 2, with its
rule ids, exit codes and CLI words).

The reference traces jaxprs abstractly. The port has no jaxpr: what an
entry point "compiles" is what it dispatches. So a program here is the
ordered aten ops of one call, each with its dtypes, shapes, devices and
scalar arguments, recorded by a ``TorchDispatchMode``, plus the kernel
launches the wrappers mark (``utils.device_loop.note_launch``: name and
statics). Its signature is a hash of that text. Two kinds:

- **graph** programs: what a CUDA graph captures (the fused fit, a
  serving rung, a kernel wrapper's dispatch). A scalar argument is
  baked into a captured graph, so its value is part of the text, and
  each device loop's body appears once, bracketed, as the graph's
  conditional node holds it. On the card the recorder reads the real
  capture (``capturing_only``); on the CPU the call runs with
  ``device_loop.observing(unroll=True)``, which runs every loop body
  once without asking its condition, so the same structure is recorded
  with the plain versions of the kernels;
- **eager** programs (the unfused coordinate update, which branches on
  the host by design): nothing is compiled per call, so the program is
  the set of distinct ops it dispatches, scalars by type.

Checks (rule ids):

- ``program-dispatch-census``: distinct signatures across a contract's
  base programs and ``stable_under`` variants stay within
  ``max_programs``; on the card, the CUDA graphs the build captured for
  them too;
- ``program-recompile-key``: a ``stable_under`` family leaves every
  signature unchanged, a ``recompiles_on`` family moves at least one; the
  report names the program that moved;
- ``program-host-boundary``: a ``hot_loop`` contract's hot programs
  hold no host sync (``_local_scalar_dense`` / ``.item()``,
  ``nonzero``, ``is_nonzero``, a blocking copy from the device to the
  host). A contract that syncs by design declares the counters that
  count its syncs (``host_syncs``, with ``host_sync_reason``), and the
  check holds the syncs the recorder saw to the counters' total;
- ``program-f64-cast``: no op of an audited program produces float64;
- ``program-sharding``: the mesh's collectives are the SPMD tier's
  (``--spmd``, ``parallel.mesh.SPMD_AUDIT``); this tier reports the mesh
  contract as covered there and checks nothing twice;
- ``program-contract``: a builder that raises is a finding, never a
  skip; a declaration naming an unknown builder is rejected; a declared
  family with no variants is unchecked, so a finding.

Findings reuse ``core.Finding`` (path: ``<contract>``), so the reporters
and the suppression audit work unchanged; suppressions are per contract
(``rule``) or per program (``rule@program``), in the declaration's
``suppress`` mapping, each with its reason.

Run via ``python -m photon_tpu_torch.analysis --semantic [--json]
[--device cpu|cuda]`` (exit 0 clean, 1 findings, 2 usage). The
builders trace at a tiny size on the card when there is one, so the
card's real captures and kernels are audited; ``--device cpu`` (or
``device="cpu"``) asks for the plain versions on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import os
from typing import Any, Callable, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from photon_tpu_torch.analysis.core import Finding

SEMANTIC_RULES: dict[str, str] = {
    "program-dispatch-census": (
        "distinct dispatched programs (or captured graphs) across a "
        "config grid exceed the contract's bound"
    ),
    "program-recompile-key": (
        "a config family perturbs (or stops perturbing) a program "
        "signature against its declaration"
    ),
    "program-host-boundary": (
        "host sync inside a hot-loop program (a round trip per "
        "dispatch), or more syncs than the contract declares"
    ),
    "program-f64-cast": "an op of an audited program produces float64",
    "program-sharding": (
        "mesh operand placement or collectives against the declaration "
        "(the port: covered by the --spmd tier)"
    ),
    "program-contract": "contract declaration or builder integrity error",
}

# Modules that declare program contracts (each exports PROGRAM_AUDIT: one
# declaration dict or a list of them, plain data).
DECLARING_MODULES = (
    "photon_tpu_torch.algorithm.fused_fit",
    "photon_tpu_torch.estimators.game_estimator",
    "photon_tpu_torch.ops.newton_kernel",
    "photon_tpu_torch.ops.segment_reduce",
    "photon_tpu_torch.ops.serve_kernel",
    "photon_tpu_torch.serve",
)

# The reference's contracts this tier does not run yet (ROADMAP Queue A
# item 13's later parts), by the port module that will declare them.
DEFERRED_CONTRACTS = {
    "photon_tpu_torch.obs": ("telemetry", "trace", "monitor", "ledger",
                             "health", "fleet-obs"),
    "photon_tpu_torch.resilience": ("resilience-retry",),
    "photon_tpu_torch.data.pipeline": ("ingest-pipeline",),
    "photon_tpu_torch.data.stream": ("streaming-ingest",),
    "photon_tpu_torch.pilot": ("pilot",),
}
DEFERRED_ITEM = 13

# Contracts another tier owns; reported as covered, with the reason.
COVERED_ELSEWHERE = {
    "mesh-sharding": (
        "covered by the SPMD tier (python -m photon_tpu_torch.analysis "
        "--spmd): every rank's ordered census of collectives, each at a "
        "site parallel.mesh.SPMD_AUDIT declares, and the partition-rule "
        "coverage of every placed leaf; the port's mesh is process "
        "ranks, so there is no HLO collective set to read here"),
}

# Ops that make the host wait for the device (or would, on a device
# tensor).
_SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::item", "aten::nonzero",
    "aten::is_nonzero", "aten::equal", "aten::allclose",
})
_F64 = (torch.float64, torch.complex128)


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------


def _describe(value, scalars: str) -> str:
    if isinstance(value, torch.Tensor):
        dt = str(value.dtype).replace("torch.", "")
        return f"{dt}{list(value.shape)}@{value.device.type}"
    if isinstance(value, (list, tuple)):
        inner = ", ".join(_describe(v, scalars) for v in value)
        return f"[{inner}]" if isinstance(value, list) else f"({inner})"
    if isinstance(value, (bool, int, float, complex)) and scalars == "type":
        return type(value).__name__
    return repr(value)


def _is_sync(name: str, args, kwargs, device: str | None) -> bool:
    """Whether the op makes the host wait for ``device`` (None: any
    device, the CPU included, as the CPU trace reads a host read of a
    tensor for the sync it is on the card)."""
    if name in _SYNC_OPS:
        ts = _tensors(list(args))
        return device is None or any(t.device.type == device for t in ts)
    # A blocking copy from the device to the host.
    if name == "aten::_to_copy" and args:
        src = args[0]
        dst = kwargs.get("device")
        return (isinstance(src, torch.Tensor) and src.device.type != "cpu"
                and dst is not None and torch.device(dst).type == "cpu"
                and not kwargs.get("non_blocking", False))
    if name == "aten::copy_" and len(args) >= 2:
        dst, src = args[0], args[1]
        blocking = not (args[2] if len(args) > 2
                        else kwargs.get("non_blocking", False))
        return (isinstance(src, torch.Tensor) and src.device.type != "cpu"
                and dst.device.type == "cpu" and blocking)
    return False


def _tensors(value) -> list:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


class Recorder(TorchDispatchMode):
    """Records every aten op dispatched in this thread while active
    (``capturing_only``: only while a CUDA graph is being captured),
    and the loop and launch marks of ``utils.device_loop``."""

    def __init__(self, *, scalars: str = "value",
                 capturing_only: bool = False):
        super().__init__()
        self.device = _AUDIT_DEVICE
        self.scalars = scalars
        self.capturing_only = capturing_only
        self.lines: list[str] = []
        self.syncs: list[str] = []
        self.f64: list[str] = []
        self.launches: dict[str, int] = {}
        self.depth = 0

    def _live(self) -> bool:
        return (not self.capturing_only
                or (torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing()))

    def mark(self, text: str) -> None:
        if not self._live():
            return
        if text == "}":
            self.depth -= 1
        self.lines.append("  " * self.depth + text)
        if text.endswith("{"):
            self.depth += 1
        if text.startswith("launch "):
            name = text.split()[1]
            self.launches[name] = self.launches.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._live():
            name = func.name()
            ins = ", ".join([_describe(a, self.scalars) for a in args]
                            + [f"{k}={_describe(v, self.scalars)}"
                               for k, v in sorted(kwargs.items())])
            line = f"{name}({ins}) -> {_describe(out, self.scalars)}"
            self.lines.append("  " * self.depth + line)
            if _is_sync(name, args, kwargs, self.device):
                self.syncs.append(line)
            if any(t.dtype in _F64 for t in _tensors(out)):
                self.f64.append(line)
        return out


# --------------------------------------------------------------------------
# data model
# --------------------------------------------------------------------------


@dataclasses.dataclass
class TracedProgram:
    """One program: its text (the signature's source), the host syncs
    and float64-producing ops the recorder saw in it, the kernel
    launches it marked, and whether it is a hot program (what a graph
    captures or a kernel wrapper dispatches; a generation's eager
    set-up is not)."""

    name: str
    text: str
    syncs: list[str] = dataclasses.field(default_factory=list)
    f64: list[str] = dataclasses.field(default_factory=list)
    launches: dict[str, int] = dataclasses.field(default_factory=dict)
    ops: int = 0
    hot: bool = True
    # Syncs the contract's declared counters counted during the call.
    declared_syncs: int = 0

    @property
    def signature(self) -> str:
        return hashlib.sha1(self.text.encode("utf-8")).hexdigest()[:16]


@dataclasses.dataclass
class ContractTrace:
    """What a builder hands the checks: the base ``programs``, each
    config family's ``variants`` (one program-name -> signature dict per
    generated config), ``captures`` (CUDA graphs the build captured for
    the base programs and the stable families; None on the CPU) and
    ``notes``."""

    programs: dict[str, TracedProgram]
    variants: dict[str, list[dict[str, str]]] = dataclasses.field(
        default_factory=dict)
    captures: int | None = None
    notes: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class ProgramContract:
    name: str
    entry: str  # human-readable entry-point path (report/docs)
    build: Callable[[str], ContractTrace]  # takes the device
    max_programs: int | None = None
    stable_under: tuple[str, ...] = ()
    recompiles_on: tuple[str, ...] = ()
    hot_loop: bool = False
    host_syncs: tuple[str, ...] = ()  # "module:counter" paths
    host_sync_reason: str | None = None
    suppress: dict[str, str] = dataclasses.field(default_factory=dict)
    # Fields where the port's declaration departs from the reference's,
    # each with its reason.
    port_differs: dict[str, str] = dataclasses.field(default_factory=dict)


def _finding(contract: ProgramContract, rule: str, message: str) -> Finding:
    return Finding(rule=rule, path=f"<{contract.name}>", line=0, col=0,
                   message=message)


@contextlib.contextmanager
def recording(*, scalars: str = "value", capturing_only: bool = False,
              unroll: bool = False):
    """A ``Recorder`` over this thread's dispatches and device-loop
    marks (``unroll``: each eager loop body once, the CPU's trace of a
    capture)."""
    from photon_tpu_torch.utils import device_loop

    rec = Recorder(scalars=scalars, capturing_only=capturing_only)
    with device_loop.observing(rec, unroll=unroll), rec:
        yield rec


def program_from(name: str, rec: Recorder, *, prefix: str = "",
                 kind: str = "graph", hot: bool = True) -> TracedProgram:
    """A ``TracedProgram`` of what ``rec`` saw: the ordered text for a
    graph program, the sorted distinct ops for an eager one."""
    lines = (rec.lines if kind == "graph"
             else sorted({ln.strip() for ln in rec.lines
                          if not ln.strip().endswith(("{", "}"))}))
    return TracedProgram(name=name, text=prefix + "\n".join(lines),
                         syncs=list(rec.syncs), f64=list(rec.f64),
                         launches=dict(rec.launches), ops=len(rec.lines),
                         hot=hot)


def trace_program(name: str, fn: Any, *args: Any, kind: str = "graph",
                  hot: bool = True, **kwargs: Any) -> TracedProgram:
    """Run ``fn(*args, **kwargs)`` under the recorder and return its
    program. A graph program on CPU tensors runs every device loop body
    once (the capture's structure); on the card the call runs as it
    is (use ``recording(capturing_only=True)`` around a real capture)."""
    before = counter_total(_COUNTERS)
    with recording(scalars="value" if kind == "graph" else "type",
                   unroll=kind == "graph") as rec:
        fn(*args, **kwargs)
    prog = program_from(name, rec, kind=kind, hot=hot)
    prog.declared_syncs = counter_total(_COUNTERS) - before
    return prog


# The sync counters the contract under audit declares, and the device
# type it is built on (``audit`` sets them around its build; on the
# card a host read of a CPU tensor is no sync).
_COUNTERS: tuple[str, ...] = ()
_AUDIT_DEVICE: str | None = None


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------


def check_dispatch_census(contract: ProgramContract,
                          trace: ContractTrace) -> Iterable[Finding]:
    if contract.max_programs is None:
        return
    sigs: dict[str, str] = {
        p.signature: f"{name} (base)" for name, p in trace.programs.items()}
    for fam in contract.stable_under:
        for i, cfg in enumerate(trace.variants.get(fam, [])):
            for name, sig in cfg.items():
                sigs.setdefault(sig, f"{name} ({fam}[{i}])")
    if len(sigs) > contract.max_programs:
        yield _finding(
            contract, "program-dispatch-census",
            f"{len(sigs)} distinct compiled programs across the declared "
            f"config grid, contract allows {contract.max_programs}: "
            + ", ".join(sorted(sigs.values())))
    if trace.captures is not None and trace.captures > contract.max_programs:
        yield _finding(
            contract, "program-dispatch-census",
            f"{trace.captures} CUDA graphs captured across the declared "
            f"config grid, contract allows {contract.max_programs}")


def check_recompile_key(contract: ProgramContract,
                        trace: ContractTrace) -> Iterable[Finding]:
    base = {name: p.signature for name, p in trace.programs.items()}
    for fam in contract.stable_under:
        if not trace.variants.get(fam):
            yield _finding(
                contract, "program-contract",
                f"declared stable family '{fam}' generated no variants — "
                "the stability guarantee is unchecked")
            continue
        for i, cfg in enumerate(trace.variants[fam]):
            moved = sorted(name for name, sig in cfg.items()
                           if name in base and sig != base[name])
            if moved:
                yield _finding(
                    contract, "program-recompile-key",
                    f"config family '{fam}' (variant {i}) perturbs the "
                    f"compile key of {', '.join(moved)} — these configs "
                    "must re-enter the same program")
    for fam in contract.recompiles_on:
        variants = trace.variants.get(fam, [])
        if not variants:
            yield _finding(
                contract, "program-contract",
                f"declared recompile family '{fam}' generated no variants "
                "— the declaration is unchecked")
            continue
        if all(all(sig == base.get(name) for name, sig in cfg.items())
               for cfg in variants):
            yield _finding(
                contract, "program-recompile-key",
                f"declared recompile trigger '{fam}' no longer perturbs any "
                "program key — the static specialization it documents is "
                "gone; tighten the contract declaration")


def check_host_boundary(contract: ProgramContract,
                        trace: ContractTrace) -> Iterable[Finding]:
    observed = allowed = 0
    for name, prog in trace.programs.items():
        if not (contract.hot_loop and prog.hot):
            continue
        observed += len(prog.syncs)
        allowed += prog.declared_syncs
        if prog.syncs and not contract.host_syncs:
            yield _finding(
                contract, "program-host-boundary",
                f"program '{name}' carries {len(prog.syncs)} host sync(s) "
                f"in its hot loop, first: {prog.syncs[0]}")
    if contract.host_syncs and contract.hot_loop:
        if observed > allowed:
            yield _finding(
                contract, "program-host-boundary",
                f"{observed} host syncs dispatched, the declared counters "
                f"({', '.join(contract.host_syncs)}) account for {allowed}")


def check_f64_cast(contract: ProgramContract, name: str,
                   prog: TracedProgram) -> Iterable[Finding]:
    if prog.f64:
        yield _finding(contract, "program-f64-cast",
                       f"program '{name}' produces float64: {prog.f64[0]}")


CHECKS = (check_dispatch_census, check_recompile_key, check_host_boundary)


def run_checks(contract: ProgramContract,
               trace: ContractTrace) -> list[Finding]:
    """All checks over one contract's trace, suppressions applied: a
    ``suppress`` key ``rule@program`` covers that program's findings
    only, a bare ``rule`` the whole contract's."""
    findings: list[Finding] = []

    def add(f: Finding, program: str | None = None) -> None:
        reason = (contract.suppress.get(f"{f.rule}@{program}")
                  if program is not None else None)
        if reason is None:
            reason = contract.suppress.get(f.rule)
        if reason is not None:
            f = dataclasses.replace(f, suppressed=True,
                                    suppress_reason=reason)
        findings.append(f)

    for check in CHECKS:
        for f in check(contract, trace):
            add(f)
    for name, prog in trace.programs.items():
        for f in check_f64_cast(contract, name, prog):
            add(f, name)
    return findings


def counter_total(paths: Iterable[str]) -> int:
    """The sum of the ``module:name`` integer counters."""
    total = 0
    for path in paths:
        mod, attr = path.split(":")
        total += int(getattr(importlib.import_module(mod), attr))
    return total


# --------------------------------------------------------------------------
# shared tiny workload
# --------------------------------------------------------------------------


def _l2_config(weight: float, optimizer=None, variance=None):
    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm.problems import (
        GLMOptimizationConfiguration,
    )

    kw: dict[str, Any] = dict(
        regularization=optim.RegularizationContext(
            optim.RegularizationType.L2),
        regularization_weight=weight)
    if optimizer is not None:
        kw["optimizer"] = optimizer
    if variance is not None:
        kw["variance_computation"] = variance
    return GLMOptimizationConfiguration(**kw)


def _tiny_glmix(device: str, num_iterations: int = 2, n: int = 96,
                e: int = 7):
    """The reference's miniature GLMix (one dense fixed effect, one
    random effect, logistic, float32) as a port estimator and dataset
    on ``device``."""
    import numpy as np

    from photon_tpu_torch.data.dataset import DenseFeatures
    from photon_tpu_torch.data.game_data import make_game_dataset
    from photon_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
    )
    from photon_tpu_torch.estimators.game_estimator import (
        FixedEffectCoordinateConfiguration,
        GameEstimator,
        RandomEffectCoordinateConfiguration,
    )
    from photon_tpu_torch.types import TaskType

    d, du = 5, 4
    rng = np.random.default_rng(20260803)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, -1] = 1.0
    xu = rng.normal(size=(n, du)).astype(np.float32)
    xu[:, -1] = 1.0
    users = rng.integers(0, e, size=n)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    data = make_game_dataset(
        y, {"global": DenseFeatures(x), "userShard": DenseFeatures(xu)},
        id_tags={"userId": users}, dtype=torch.float32, device=device)
    est = GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"global": FixedEffectCoordinateConfiguration(
            "global", _l2_config(0.01)),
         "per-user": RandomEffectCoordinateConfiguration(
             RandomEffectDataConfiguration("userId", "userShard"),
             _l2_config(0.5))},
        intercept_indices={"global": d - 1, "userShard": du - 1},
        num_iterations=num_iterations, mesh="off", device=device)
    return est, data


def _zero_initial_models(coords: dict) -> dict:
    """Warm-start models of the coordinates' structure (zeros: the
    values never enter a signature, the warm flag does)."""
    from photon_tpu_torch.algorithm.coordinate import FixedEffectCoordinate
    from photon_tpu_torch.models.game import (
        FixedEffectModel,
        RandomEffectModel,
    )
    from photon_tpu_torch.models.glm import (
        Coefficients,
        GeneralizedLinearModel,
    )

    out = {}
    for cid, coord in coords.items():
        inner = getattr(coord, "inner", coord)
        if isinstance(inner, FixedEffectCoordinate):
            b = inner.batch
            glm = GeneralizedLinearModel(
                Coefficients(means=torch.zeros(
                    b.num_features, dtype=b.labels.dtype,
                    device=b.labels.device)), inner.problem.task)
            out[cid] = FixedEffectModel(glm, "global")
        else:
            ds = inner.dataset
            out[cid] = RandomEffectModel(
                coefficients=torch.zeros(
                    (ds.num_entities, ds.max_sub_dim), dtype=ds.dtype,
                    device=ds.device),
                random_effect_type=ds.config.random_effect_type,
                feature_shard_id=ds.config.feature_shard_id,
                task=inner.task,
                proj_all=ds.proj_all,
                entity_keys=tuple(ds.entity_keys))
    return out


def _cuda(device: str) -> bool:
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def _no_sync(device: str):
    """The card's own sync guard around hot dispatches: a synchronizing
    call raises (``torch.cuda.set_sync_debug_mode("error")``)."""
    if not _cuda(device):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def _env(name: str, value: str):
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


# --------------------------------------------------------------------------
# contract builders (named by the PROGRAM_AUDIT declarations)
# --------------------------------------------------------------------------


def build_fused_fit(device: str) -> ContractTrace:
    """The fused fit's programs: the generation's slab materialization
    (eager set-up, not a hot program), the cold fit and its warm-start
    twin (one CUDA graph each on the card), and the families of the
    lambda-grid / optimizer-swap discipline. A fit program's text is its
    statics (the graph cache's key) and the ops its capture holds."""
    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm.fused_fit import FusedFit, _device_of

    est, data = _tiny_glmix(device)
    datasets, _ = est.prepare(data)
    cuda = _cuda(device)
    text_of_graph: dict[int, str] = {}
    fits: list[FusedFit] = []

    def fused_for(opt_configs: dict, iters: int = 2,
                  precision: str = "float32"):
        coords = est._build_coordinates(datasets, opt_configs, {})
        fused = FusedFit(coords, est.update_sequence, iters, set(),
                         precision=precision)
        fits.append(fused)
        return fused, coords

    def fit_program(fused, coords, init=None, name="fit") -> TracedProgram:
        statics = fused._statics(coords, init)
        prefix = f"statics {statics!r}\n"
        if not cuda:
            ops = fused._operands(coords, init)
            fused.device = _device_of(ops)
            ebs = fused._mat_fn(coords)
            with recording(unroll=True) as rec:
                fused._fit_fn(ops, ebs, statics)
            return program_from(name, rec, prefix=prefix)
        with recording(capturing_only=True) as rec:
            fused.run(coords, init)
        cap = fused.captured(statics)
        if id(cap) in text_of_graph:
            # A replay of a graph captured earlier: that graph's program.
            return TracedProgram(name=name, text=text_of_graph[id(cap)])
        prog = program_from(name, rec, prefix=prefix)
        text_of_graph[id(cap)] = prog.text
        return prog

    fused, coords = fused_for({})
    with recording() as rec:
        fused._mat_fn(coords)
    mat = program_from("materialize", rec, hot=False)
    fit_cold = fit_program(fused, coords)
    warm = _zero_initial_models(coords)
    fit_warm = fit_program(fused, coords, warm, name="fit_warm")
    if cuda:
        # The hot replays, guarded: a sync on the path raises.
        with _no_sync(device):
            fused.run(coords)
            fused.run(coords, warm)
        torch.cuda.synchronize()

    variants: dict[str, list[dict[str, str]]] = {
        "lambda_grid": [], "optimizer_swap": [], "iteration_count": [],
        "precision": []}
    for w in (0.003, 3.0):
        # The same generation's program with new weights (on the card a
        # replay of the graphs above when the grid holds).
        c2 = est._build_coordinates(
            datasets, {"global": _l2_config(w), "per-user": _l2_config(w)},
            {})
        variants["lambda_grid"].append({
            "fit": fit_program(fused, c2).signature,
            "fit_warm": fit_program(fused, c2, _zero_initial_models(c2),
                                    name="fit_warm").signature})
    captures = (sum(len(f._graphs) for f in fits) if cuda else None)
    f3, c3 = fused_for({"global": _l2_config(
        0.01, optimizer=optim.OptimizerConfig.tron())})
    variants["optimizer_swap"].append({"fit": fit_program(f3, c3).signature})
    f4, c4 = fused_for({}, iters=3)
    variants["iteration_count"].append(
        {"fit": fit_program(f4, c4).signature})
    f5, c5 = fused_for({}, precision="bfloat16")
    variants["precision"].append({"fit": fit_program(f5, c5).signature})
    notes = ["a fused fit is the generation's materialize (eager set-up) "
             "and one CUDA graph per static structure and warm-start "
             "twin: the cold and the warm fit"]
    if cuda:
        notes.append(
            f"{captures} CUDA graphs captured for the base and the lambda "
            f"grid; {sum(len(f._graphs) for f in fits)} in all; the base "
            "replays ran under set_sync_debug_mode('error')")
    return ContractTrace(
        programs={"materialize": mat, "fit": fit_cold, "fit_warm": fit_warm},
        variants=variants, captures=captures, notes=notes)




def build_fused_cache_keys(device: str) -> ContractTrace:
    """The estimator's static-key discipline, on keys alone: a lambda
    grid maps to one fused-cache entry, an optimizer swap or a precision
    switch to another, and a mixed grid stays within the cache."""
    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm.fused_fit import fused_static_key
    from photon_tpu_torch.estimators.game_estimator import _FUSED_CACHE_SIZE

    est, data = _tiny_glmix(device)
    datasets, _ = est.prepare(data)

    def key_for(opt_configs: dict, precision: str = "float32") -> str:
        coords = est._build_coordinates(datasets, opt_configs, {})
        return repr(fused_static_key(coords, est.update_sequence,
                                     est.num_iterations,
                                     est.locked_coordinates, precision))

    def sig(text: str) -> dict:
        return {"fused_static_key": TracedProgram("k", text).signature}

    base = TracedProgram(name="fused_static_key", text=key_for({}))
    lam = [sig(key_for({"global": _l2_config(w), "per-user": _l2_config(w)}))
           for w in (1e-4, 0.01, 1.0, 100.0)]
    swap = [sig(key_for({"global": _l2_config(
        0.01, optimizer=optim.OptimizerConfig.tron())}))]
    prec = [sig(key_for({}, precision="bfloat16"))]
    mixed = ({s["fused_static_key"] for s in lam + swap + prec}
             | {base.signature})
    notes = [f"mixed lambda x optimizer x precision grid occupies "
             f"{len(mixed)} of {_FUSED_CACHE_SIZE} fused-cache slots"]
    if len(mixed) > _FUSED_CACHE_SIZE:
        notes.append("mixed grid exceeds the fused-cache LRU capacity — "
                     "alternating configs will recapture whole fits")
    return ContractTrace(
        programs={"fused_static_key": base},
        variants={"lambda_grid": lam, "optimizer_swap": swap,
                  "precision": prec},
        notes=notes)


def build_unfused_update(device: str) -> ContractTrace:
    """The unfused coordinate update (``problems.run_impl``, what
    ``GLMOptimizationProblem.run`` calls): an eager program, its ops as a
    set; the lambda and the warm start are values, never new ops, and
    its host syncs are the solvers' counted ones."""
    import numpy as np

    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm.problems import (
        VarianceComputationType,
        run_impl,
    )
    from photon_tpu_torch.data.dataset import DenseFeatures, GLMBatch
    from photon_tpu_torch.ops.normalization import NormalizationContext
    from photon_tpu_torch.types import TaskType

    n, d = 64, 5
    rng = np.random.default_rng(0)
    dev = torch.device(device)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    y = torch.from_numpy(
        (rng.uniform(size=n) < 0.5).astype(np.float32)).to(dev)
    batch = GLMBatch(DenseFeatures(x), y, torch.zeros_like(y),
                     torch.ones_like(y))
    norm = NormalizationContext()

    def tr(l2: float, opt_config=None, w0=None) -> TracedProgram:
        return trace_program(
            "coordinate_update", run_impl, batch,
            torch.zeros(d, dtype=torch.float32, device=dev)
            if w0 is None else w0,
            0.0, l2, norm, None, 1.0, kind="eager",
            task=TaskType.LOGISTIC_REGRESSION,
            opt_config=opt_config or optim.OptimizerConfig(),
            intercept_index=d - 1,
            variance_computation=VarianceComputationType.NONE)

    base = tr(0.01)
    warm = torch.ones(d, dtype=torch.float32, device=dev)
    return ContractTrace(
        programs={"coordinate_update": base},
        variants={
            "lambda_grid": [{"coordinate_update": tr(w).signature}
                            for w in (1e-3, 10.0)],
            "warm_start": [{"coordinate_update": tr(
                0.01, w0=warm).signature}],
            "optimizer_swap": [{"coordinate_update": tr(
                0.01, opt_config=optim.OptimizerConfig.tron()).signature}],
        },
        notes=[f"{len(base.syncs)} host syncs dispatched against "
               f"{base.declared_syncs} counted by the solvers' declared "
               "counters"])


def _kernel_program(name: str, device: str, fn, *args, **kwargs):
    """A kernel wrapper's program: on the CPU its plain version traced
    with loops once; on the card the wrapper's dispatch (its allocations
    and its marked launch) under the sync guard."""
    if not _cuda(device):
        return trace_program(name, fn, *args, **kwargs)
    with _no_sync(device), recording() as rec:
        fn(*args, **kwargs)
    return program_from(name, rec)


def build_newton_kernel(device: str) -> ContractTrace:
    """The Newton-step wrapper at [B, R, S] = [128, 6, 4] (the
    reference's 128 lanes): one program; the bucket shape and the line
    search's trial count are its statics."""
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.types import TaskType

    dev = torch.device(device)
    if _cuda(device):
        nk.load()
    b = 128

    def tr(name: str, *, s=4, r=6, trials=16) -> TracedProgram:
        g = torch.Generator().manual_seed(0)

        def t(*shape):
            return torch.rand(shape, generator=g).to(dev)

        x, w, y, wt, off = t(b, r, s), t(b, s), t(b, r), t(b, r), t(b, r)
        l2, mt, vm, f = t(b, s), t(b, s), torch.ones(b, s, device=dev), t(b)
        before = nk.launches
        prog = _kernel_program(name, device, nk.newton_step, x, w, y, wt,
                               off, l2, mt, vm, f,
                               task=TaskType.LOGISTIC_REGRESSION,
                               trials=trials)
        prog.launches["newton_step(counter)"] = nk.launches - before
        return prog

    base = tr("newton_step")
    return ContractTrace(
        programs={"newton_step": base},
        variants={
            "bucket_shape": [{"newton_step": tr("n", r=8).signature}],
            "line_search_trials": [
                {"newton_step": tr("n", trials=8).signature}],
        })


def build_segment_reduce(device: str) -> ContractTrace:
    """The segment-sum wrapper over sorted int32 ids: values and ids are
    operands; the reduce's shape keys a new program."""
    from photon_tpu_torch.ops import segment_reduce as sr

    dev = torch.device(device)
    if _cuda(device):
        sr.load()

    def tr(name: str, *, m: int, n: int, mult: int = 1) -> TracedProgram:
        g = torch.Generator().manual_seed(1)
        ids = torch.sort(torch.randint(0, n, (m,), generator=g)).values
        vals = torch.rand(m, generator=g)
        before = sr.launches
        prog = _kernel_program(
            name, device, sr.sorted_segment_sum, vals.to(dev),
            ids.to(torch.int32).to(dev), n, multiplicity=mult)
        prog.launches["segment_sum(counter)"] = sr.launches - before
        return prog

    base = tr("segment_sum", m=4096, n=2048)
    return ContractTrace(
        programs={"segment_sum": base},
        variants={"reduce_shape": [
            {"segment_sum": tr("v", m=8192, n=2048).signature},
            {"segment_sum": tr("v", m=4096, n=2048, mult=4).signature}]},
        notes=["the run reduction chooses no window, so the reference's "
               "multiplicity keys nothing here; the element count does"])


def _serving_model(d: int, scale: float, rng, e: int = 7, s: int = 3,
                   du: int = 6):
    """The reference's serving fixture: a dense fixed effect of ``d``
    features and a random effect with a fixed-seed projector."""
    import numpy as np

    from photon_tpu_torch.models.game import (
        FixedEffectModel,
        GameModel,
        RandomEffectModel,
    )
    from photon_tpu_torch.models.glm import (
        Coefficients,
        GeneralizedLinearModel,
    )
    from photon_tpu_torch.types import TaskType

    prng = np.random.default_rng(1234)
    proj = np.sort(np.stack([prng.permutation(du)[:s] for _ in range(e)]),
                   axis=1).astype(np.int64)
    task = TaskType.LOGISTIC_REGRESSION
    return GameModel({
        "global": FixedEffectModel(GeneralizedLinearModel(
            Coefficients(means=torch.from_numpy(
                scale * rng.normal(size=d).astype(np.float32))), task),
            "features"),
        "per-user": RandomEffectModel(
            coefficients=torch.from_numpy(
                scale * rng.normal(size=(e, s)).astype(np.float32)),
            random_effect_type="userId", feature_shard_id="userShard",
            task=task, proj_all=proj,
            entity_keys=tuple(str(i) for i in range(e))),
    })


def _rung_programs(programs, rungs, device: str) -> dict:
    """Each rung's program: on the card the ops its graph capture holds
    (``compile_rung``); on the CPU the rung's score on zero inputs of the
    rung's shapes, the capture's content without its copies."""
    out = {}
    for r in rungs:
        name = f"score_b{r}"
        if _cuda(device):
            with recording(capturing_only=True) as rec:
                programs.compile_rung(r)
            out[name] = program_from(name, rec)
            continue
        flat = [torch.zeros(shape, dtype=dt, device=programs.device)
                for shape, dt in programs._flat_layout(r)]
        ops = programs._device_operands(*programs._unflat(flat))
        out[name] = trace_program(name, programs._score, **ops)
    return out


def build_serve_kernel(device: str) -> ContractTrace:
    """The fused serve score: one program a rung; tables, features and
    codes are operands, the rung and the model's structure statics. On
    the CPU the plain version stands for the kernel, as in every CPU
    route of the port."""
    import numpy as np

    from photon_tpu_torch.serve.programs import ScorePrograms, ShapeLadder
    from photon_tpu_torch.serve.tables import CoefficientTables

    rng = np.random.default_rng(20260806)
    captures = 0

    def rung_program(d: int, rung: int, name: str) -> TracedProgram:
        nonlocal captures
        tables = CoefficientTables.from_game_model(
            _serving_model(d, 1.0, rng), device=device)
        programs = ScorePrograms(tables, ladder=ShapeLadder((rung,)),
                                 compile_now=False)
        if _cuda(device) and not programs.use_kernel:
            raise RuntimeError(
                "the serve kernel is off (PHOTON_SERVE_KERNEL): the "
                "serve-kernel contract would audit nothing")
        prog = _rung_programs(programs, (rung,), device)[f"score_b{rung}"]
        captures += programs.stats["programs_compiled"]
        return dataclasses.replace(prog, name=name)

    base = rung_program(5, 8, "serve_kernel_b8")
    base_captures = captures
    variants = {
        "rung": [{"serve_kernel_b8": rung_program(5, r, "v").signature}
                 for r in (1, 64)],
        "model_structure": [
            {"serve_kernel_b8": rung_program(9, 8, "v").signature}],
    }
    return ContractTrace(
        programs={"serve_kernel_b8": base}, variants=variants,
        captures=base_captures if _cuda(device) else None,
        notes=["one rung is one program: the tables, features and codes "
               "are operands (a values-only reload re-enters it; the "
               "serving contract's model_reload family)"])


def build_serving(device: str) -> ContractTrace:
    """The serving ladder: one program a rung (one CUDA graph each on the
    card); every request count pads into a rung, and a values-only model
    reload re-enters the same programs."""
    import numpy as np

    from photon_tpu_torch.serve.programs import ScorePrograms, ShapeLadder
    from photon_tpu_torch.serve.tables import CoefficientTables

    rng = np.random.default_rng(20260803)
    ladder = ShapeLadder((1, 8, 64))
    tables = CoefficientTables.from_game_model(
        _serving_model(5, 1.0, rng), device=device)
    programs = ScorePrograms(tables, ladder=ladder, compile_now=False)
    base = _rung_programs(programs, ladder.rungs, device)
    cuda = _cuda(device)

    def rung_signature(rung: int) -> str:
        if cuda:
            # A request of this rung through the rung's graph (no new
            # capture may come of it), then the graph's replay alone
            # under the sync guard.
            feats = {s: (np.zeros((rung, sp.d), np.float32)
                         if sp.kind == "dense" else
                         (np.zeros((rung, sp.k), np.int32),
                          np.zeros((rung, sp.k), np.float32)))
                     for s, sp in programs.specs.items()}
            codes = {nm: np.full(rung, -1, np.int32)
                     for nm in programs._re_names}
            programs.score_padded(feats, codes, rung)
            with _no_sync(device):
                programs._graphs[rung].graph.replay()
            torch.cuda.synchronize()
            return base[f"score_b{rung}"].signature
        flat = [torch.zeros(shape, dtype=dt, device=programs.device)
                for shape, dt in programs._flat_layout(rung)]
        ops = programs._device_operands(*programs._unflat(flat))
        return trace_program("v", programs._score, **ops).signature

    variants: dict[str, list[dict[str, str]]] = {
        "request_batch": [], "model_reload": []}
    rung_sigs: dict[int, str] = {}
    for n in range(1, ladder.max_batch + 1):
        rung = ladder.rung_for(n)
        if rung not in rung_sigs:
            rung_sigs[rung] = rung_signature(rung)
        variants["request_batch"].append({f"score_b{rung}": rung_sigs[rung]})
    if not tables.reload(_serving_model(5, 2.5, rng)):
        raise RuntimeError("the serving fixture's reload changed structure")
    variants["model_reload"].append(
        {f"score_b{r}": rung_signature(r) for r in ladder.rungs})
    captures = programs.stats["programs_compiled"] if cuda else None
    return ContractTrace(
        programs=base, variants=variants, captures=captures,
        notes=[f"ladder {ladder.rungs}: every request count 1.."
               f"{ladder.max_batch} pads into the {len(ladder.rungs)} "
               "rungs; an in-place reload re-enters the same programs"])


def build_evaluators(device: str) -> ContractTrace:
    """Evaluation and scoring: shaped by the row count (by design),
    stable in values."""
    from photon_tpu_torch.data.dataset import DenseFeatures
    from photon_tpu_torch.evaluation.evaluators import auc_roc, rmse
    from photon_tpu_torch.models.glm import Coefficients

    dev = torch.device(device)
    g = torch.Generator().manual_seed(2)

    def t(*shape):
        return torch.rand(shape, generator=g).to(dev)

    def score(w, x):
        return Coefficients(means=w).compute_score(DenseFeatures(x))

    def tr(name, fn, n):
        return trace_program(name, fn, t(n), (t(n) > 0.5).float())

    return ContractTrace(
        programs={"auc": tr("auc", auc_roc, 256),
                  "rmse": tr("rmse", rmse, 256),
                  "fixed_effect_score": trace_program(
                      "fixed_effect_score", score, t(5), t(256, 5))},
        variants={"row_count": [{"auc": tr("auc", auc_roc, 512).signature,
                                 "rmse": tr("rmse", rmse, 512).signature}]})


_BUILDERS: dict[str, Callable[[str], ContractTrace]] = {
    "build_fused_fit": build_fused_fit,
    "build_fused_cache_keys": build_fused_cache_keys,
    "build_unfused_update": build_unfused_update,
    "build_newton_kernel": build_newton_kernel,
    "build_segment_reduce": build_segment_reduce,
    "build_serve_kernel": build_serve_kernel,
    "build_serving": build_serving,
    "build_evaluators": build_evaluators,
}

# Contracts owned by the tier itself (no better home module).
_LOCAL_AUDITS = (
    dict(
        name="evaluation-scoring",
        entry="evaluation.evaluators.auc_roc / rmse; "
        "models.glm.Coefficients.compute_score",
        builder="build_evaluators",
        max_programs=3,
        recompiles_on=("row_count",),
        hot_loop=True,
        suppress={"program-f64-cast@auc": (
            "on the card the AUC's running sums accumulate in float64 and "
            "round once to float32 (evaluation.evaluators.running_sum): a "
            "scan in a fixed order that repeats bit for bit, as the CPU's "
            "torch.cumsum accumulates a float32 scan in float64")},
        port_differs={"suppress": "the port's card route accumulates the "
                      "AUC's running sums in float64 by design"},
    ),
)


def contract_from_declaration(spec: dict) -> ProgramContract:
    builder = spec.get("builder")
    if builder not in _BUILDERS:
        raise ValueError(
            f"PROGRAM_AUDIT declaration {spec.get('name')!r} names unknown "
            f"builder {builder!r}")
    return ProgramContract(
        name=spec["name"],
        entry=spec["entry"],
        build=_BUILDERS[builder],
        max_programs=spec.get("max_programs"),
        stable_under=tuple(spec.get("stable_under", ())),
        recompiles_on=tuple(spec.get("recompiles_on", ())),
        hot_loop=bool(spec.get("hot_loop", False)),
        host_syncs=tuple(spec.get("host_syncs", ())),
        host_sync_reason=spec.get("host_sync_reason"),
        suppress=dict(spec.get("suppress", {})),
        port_differs=dict(spec.get("port_differs", {})),
    )


def declarations() -> list[dict]:
    """Every PROGRAM_AUDIT declaration of the declaring modules, then the
    tier's own."""
    specs: list[dict] = []
    for modname in DECLARING_MODULES:
        mod = importlib.import_module(modname)
        decl = getattr(mod, "PROGRAM_AUDIT", None)
        if decl is None:
            raise ValueError(f"{modname} is a declaring module but exports "
                             "no PROGRAM_AUDIT")
        specs.extend(decl if isinstance(decl, (list, tuple)) else [decl])
    specs.extend(_LOCAL_AUDITS)
    return specs


def collect_contracts(names: Iterable[str] | None = None
                      ) -> list[ProgramContract]:
    """The declared contract registry (``names``: only those)."""
    contracts = [contract_from_declaration(s) for s in declarations()]
    if names is None:
        return contracts
    wanted = list(names)
    unknown = set(wanted) - {c.name for c in contracts}
    if unknown:
        raise ValueError(f"unknown program contract(s): {sorted(unknown)}")
    return [c for c in contracts if c.name in wanted]


# --------------------------------------------------------------------------
# the audit driver
# --------------------------------------------------------------------------


def default_device() -> str:
    """The card when there is one, else the CPU."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def audit(contracts: Iterable[ProgramContract] | None = None, *,
          device: str | None = None) -> tuple[list[Finding], dict]:
    global _COUNTERS, _AUDIT_DEVICE
    """Run every contract on ``device`` (default: ``default_device()``);
    returns (findings, report). The builds run with serial ingest (no
    warm capture on a pool thread: a build must be deterministic, and
    its captures its own)."""
    device = device or default_device()
    findings: list[Finding] = []
    report: dict[str, Any] = {"device": str(device), "contracts": {},
                              "covered_elsewhere": dict(COVERED_ELSEWHERE),
                              "deferred": {m: list(c) for m, c in
                                           DEFERRED_CONTRACTS.items()}}
    with _env("PHOTON_TPU_SERIAL_INGEST", "1"):
        resolved = (collect_contracts() if contracts is None
                    else list(contracts))
        for contract in resolved:
            entry: dict[str, Any] = {"entry": contract.entry,
                                     "programs": {}, "notes": []}
            report["contracts"][contract.name] = entry
            _COUNTERS = contract.host_syncs
            _AUDIT_DEVICE = torch.device(device).type
            try:
                trace = contract.build(device)
            except Exception as exc:  # noqa: BLE001 — a crash is a finding
                findings.append(_finding(
                    contract, "program-contract",
                    f"contract builder failed: {exc!r}"))
                continue
            finally:
                _COUNTERS, _AUDIT_DEVICE = (), None
            entry["notes"] = list(trace.notes)
            if trace.captures is not None:
                entry["captures"] = trace.captures
            if contract.host_syncs:
                entry["host_syncs"] = list(contract.host_syncs)
                entry["host_sync_reason"] = contract.host_sync_reason
            for name, prog in trace.programs.items():
                entry["programs"][name] = {
                    "signature": prog.signature, "ops": prog.ops,
                    "syncs": len(prog.syncs),
                    "declared_syncs": prog.declared_syncs,
                    "launches": prog.launches}
            findings.extend(run_checks(contract, trace))
    findings.sort(key=lambda f: (f.path, f.rule, f.message))
    return findings, report


def render_rule_list() -> str:
    width = max(len(r) for r in SEMANTIC_RULES)
    return "\n".join(f"{r.ljust(width)}  {s}"
                     for r, s in SEMANTIC_RULES.items())
