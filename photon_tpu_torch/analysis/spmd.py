"""The SPMD tier: proofs that every rank of the port's mesh issues the
same collectives (port of ``photon_tpu/analysis/spmd.py``, the
reference's tier 6, with its rule ids, exit codes and CLI words).

A rank whose host code branches differently from its peers (a rank id in
a shape, a clock in a branch predicate) issues a DIFFERENT sequence of
collectives, and the first mismatched one hangs the whole group with no
error on any rank. The reference proves its
programs against that on jaxprs and compiled HLO under simulated
``process_index`` values. The port has no jaxpr or HLO: its collectives
are the ``torch.distributed`` calls its host code makes. So each rule
reads what real ranks actually issue:

- **the census**: ``build_mesh_spmd`` starts ``hosts`` gloo ranks on the
  CPU (``tests/test_torch_mesh_ranks.py``'s launch: a time limit, every
  rank killed past it), and each runs the contract's fits at a tiny
  size: a GLMix fit through ``GameEstimator(mesh="auto")`` with a
  row-sharded fixed effect and a random effect, then two column-sharded
  fixed-effect fits (L-BFGS; OWL-QN with FULL variances). Each rank returns its ordered census
  (``parallel.mesh.CollectiveStats.census``: op, call site, dtype,
  operand shape, bytes) of each fit;
- ``spmd-collective-order``: site and op, position by position, against
  rank 0's; the first divergent position is named (a mismatch is the
  hang);
- ``spmd-trace-divergence``: the operand shapes and dtypes where the
  sites agree (a rank that gathers another shape corrupts the sum, or
  hangs);
- ``spmd-implicit-reshard``: a site the contract's
  ``ordered_collectives`` does not declare, priced by
  ``costmodel.collective_transfer``;
- ``spmd-partition-coverage``: every leaf the mesh places matched by
  exactly one of ``parallel.mesh.PARTITION_RULES`` (the reference's
  rules as they are), its placement agreeing with the rule; a leaf's
  placement is what the rank holds of it (a share of the rows or
  entities: sharded; the whole: replicated);
- ``spmd-contract``: contract integrity; a builder that crashes or
  hangs is a finding, not a crash;
- ``spmd-host-divergence``: the pure-``ast`` lint over the port's
  package: a rank-varying value (``torch.distributed.get_rank``, a
  mesh's ``rank`` / ``is_coordinator``, ``RANK`` / ``LOCAL_RANK`` and
  other environment reads, clocks, unseeded RNGs, hostname, pid) flowing
  into a tensor constructor's shape, or into a branch predicate of a
  function that issues collectives. The port's legitimate rank-dependent
  code carries a suppression with its reason.

Run via ``python -m photon_tpu_torch.analysis --spmd [--hosts N]``
(exit 0 clean, 1 findings, 2 usage).
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys
import tempfile
import types
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator

from photon_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    iter_python_files,
)

SPMD_RULES = {
    "spmd-trace-divergence": (
        "ranks issue a collective at the same site with different operand "
        "shapes or dtypes — the group gathers mismatched buffers"
    ),
    "spmd-host-divergence": (
        "a rank-varying value (rank, coordinator, clock, unseeded RNG, "
        "hostname, pid, env) flows into a trace-affecting position (a "
        "tensor constructor's shape, a branch predicate of a function "
        "that issues collectives)"
    ),
    "spmd-collective-order": (
        "the ordered collective sequence differs between ranks — the "
        "first mismatched collective hangs the group"
    ),
    "spmd-implicit-reshard": (
        "a rank issues a collective at a site the contract did not "
        "declare — an undeclared transfer paid on every fit"
    ),
    "spmd-partition-coverage": (
        "a placed leaf is matched by zero or multiple partition rules, "
        "or its placement contradicts the matched rule (e.g. a slab "
        "intended to shard is silently replicated)"
    ),
    "spmd-contract": "contract declaration or builder integrity error",
}

# Modules that declare SPMD contracts (each exports SPMD_AUDIT — one
# declaration dict or a list of them; plain data, no analysis imports).
SPMD_DECLARING_MODULES = ("photon_tpu_torch.parallel.mesh",)

# Seconds a builder waits for its ranks; past it every rank is killed
# and the contract gets a finding.
BUILD_LIMIT_SECONDS = 180.0


# --------------------------------------------------------------------------
# data model
# --------------------------------------------------------------------------


@dataclasses.dataclass
class HostTrace:
    """One rank's view: the ordered census of each audited fit."""

    process_index: int
    sequences: dict[str, list[dict]] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class SpmdTrace:
    """Everything a contract's builder hands the checks: one
    :class:`HostTrace` per rank, the partition-rule ``coverage`` table
    (None when the contract declares no rules), and ``notes`` for the
    report."""

    hosts: list[HostTrace]
    coverage: dict | None = None
    notes: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class SpmdContract:
    name: str
    entry: str  # human-readable entry-point path (report/docs)
    build: Callable[[int], SpmdTrace]  # takes the rank count
    hosts: int = 2
    ordered_collectives: tuple[str, ...] = ()  # declared sites
    partition_rules: str | None = None  # attr name on the declaring module
    suppress: dict[str, str] = dataclasses.field(default_factory=dict)


def _finding(contract: SpmdContract, rule: str, message: str) -> Finding:
    return Finding(rule=rule, path=f"<{contract.name}>", line=0, col=0,
                   message=message)


# --------------------------------------------------------------------------
# partition-rule coverage
# --------------------------------------------------------------------------


def _spec_shards(spec: Any) -> bool:
    """True when a PartitionSpec names at least one mesh axis."""
    if spec is None:
        return False
    try:
        return any(ax is not None for ax in spec)
    except TypeError:
        return False


def partition_coverage(rules: Iterable[tuple[str, Any]],
                       leaves: dict[str, Any]) -> dict:
    """Match named placed leaves against the regex partition rules.

    ``rules`` is ``((pattern, PartitionSpec), ...)``; ``leaves`` maps
    slash-joined names to leaves with ``ndim`` and ``sharding.spec`` (the
    placement, ``None`` where unknown). The table records, per leaf,
    every matching rule index, the matched spec, the placed spec, and
    whether each side shards. Scalars are exempt."""
    rules = list(rules)
    table: dict[str, dict] = {}
    for name, leaf in sorted(leaves.items()):
        ndim = int(getattr(leaf, "ndim", 0))
        matches = [i for i, (pat, _) in enumerate(rules)
                   if re.search(pat, name)]
        matched_spec = rules[matches[0]][1] if matches else None
        placed_spec = getattr(getattr(leaf, "sharding", None), "spec", None)
        table[name] = {
            "ndim": ndim,
            "matches": matches,
            "rule": rules[matches[0]][0] if matches else None,
            "spec": None if matched_spec is None else str(matched_spec),
            "placed": None if placed_spec is None else str(placed_spec),
            "intended_sharded": _spec_shards(matched_spec),
            "placed_sharded": _spec_shards(placed_spec),
        }
    return {"rules": [pat for pat, _ in rules], "leaves": table}


# --------------------------------------------------------------------------
# the contract's builder: real gloo ranks on the CPU
# --------------------------------------------------------------------------


def _tiny_glmix(rank_count: int):
    """A GLMix of numpy arrays from a fixed seed: a dense 5-feature
    fixed effect (intercept last) and 2 entities a rank, logistic."""
    import numpy as np

    rng = np.random.default_rng(1)
    n, d, e = 16 * rank_count, 5, 2 * rank_count
    x = rng.normal(size=(n, d))
    x[:, -1] = 1.0
    users = rng.integers(0, e, size=n)
    z = x @ rng.normal(size=d) + 0.5 * rng.normal(size=e)[users]
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(float)
    return {"x": x, "y": y, "users": np.asarray([f"u{u}" for u in users])}


def _tiny_wide(rank_count: int):
    """A linear fixed effect over 13 features a rank, 4 entries a row
    (the column fit)."""
    import numpy as np

    rng = np.random.default_rng(2)
    n, d, k = 48, 13 * rank_count, 4
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k))
    y = (val * rng.normal(size=d)[idx]).sum(axis=1) + 0.1 * rng.normal(
        size=n)
    return idx, val, y, d


def _named_mesh_leaves(mesh, batch, re_ds, w) -> dict[str, dict]:
    """Slash-named leaves this rank placed, each ``{"ndim", "placed"}``:
    ``P('data')`` where the rank holds a share of the leaf's rows or
    entities, ``P()`` where it holds the whole."""
    import torch

    from photon_tpu_torch.parallel.mesh import P, maybe_row_shard

    def leaf(t: torch.Tensor, whole: int) -> dict:
        spec = P(mesh.axis_name) if int(t.shape[0]) < whole else P()
        return {"ndim": int(t.dim()), "placed": list(spec)}

    n = batch.logical_rows
    leaves = {"fe/features": leaf(batch.features.x, n),
              "fe/labels": leaf(batch.labels, n),
              "fe/offsets": leaf(batch.offsets, n),
              "fe/weights": leaf(batch.weights, n),
              "coef/w": leaf(w, int(w.shape[0]))}
    for i, b in enumerate(re_ds.blocks):
        whole = len(re_ds.block_codes_np[i])
        for field in ("entity_codes", "row_ids", "row_counts", "proj",
                      "intercept_slots"):
            t = getattr(b, field, None)
            if t is not None:
                leaves[f"re/block{i}/{field}"] = leaf(t, whole)
    raw = re_ds.raw
    if raw is not None:
        t = raw.x if hasattr(raw, "x") else raw.values
        leaves["re/raw"] = leaf(t, int(t.shape[0]))
    if re_ds.score_codes is not None:
        (share,) = maybe_row_shard(mesh, re_ds.score_codes)
        leaves["re/score_codes"] = leaf(share, re_ds.num_rows)
    return leaves


def rank_build(out_path: str) -> None:
    """One rank of ``build_mesh_spmd`` (``python -m
    photon_tpu_torch.analysis.spmd --rank OUT``, under the launcher's
    variables): the GLMix fit on the mesh, then the two column fits, each
    fit's slice of this rank's census and the GLMix fit's placed leaves
    written to ``OUT`` as JSON."""
    import torch

    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm.problems import (
        GLMOptimizationConfiguration,
        VarianceComputationType,
    )
    from photon_tpu_torch.data.dataset import DenseFeatures, SparseFeatures
    from photon_tpu_torch.data.game_data import make_game_dataset
    from photon_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
    )
    from photon_tpu_torch.estimators.game_estimator import (
        FixedEffectCoordinateConfiguration,
        GameEstimator,
        RandomEffectCoordinateConfiguration,
    )
    from photon_tpu_torch.parallel import mesh as mesh_mod
    from photon_tpu_torch.types import TaskType

    torch.set_num_threads(1)
    mesh = mesh_mod.init_from_env("cpu")
    if mesh is None:
        raise RuntimeError("the SPMD builder's rank needs WORLD_SIZE >= 2")
    try:
        l2 = GLMOptimizationConfiguration(
            regularization=optim.RegularizationContext(
                optim.RegularizationType.L2), regularization_weight=1.0)
        census = mesh_mod.group_stats().census
        a = _tiny_glmix(mesh.size)
        data = make_game_dataset(
            a["y"], {"features": DenseFeatures(a["x"])},
            id_tags={"userId": a["users"]}, dtype=torch.float32,
            device="cpu")
        est = GameEstimator(
            TaskType.LOGISTIC_REGRESSION,
            {"global": FixedEffectCoordinateConfiguration("features", l2),
             "per-user": RandomEffectCoordinateConfiguration(
                 RandomEffectDataConfiguration("userId", "features"), l2)},
            num_iterations=2, intercept_indices={"features": 4},
            mesh="auto", device="cpu")
        at = len(census)
        res = est.fit(data)[0]
        glmix = census[at:]
        datasets, _ = est.prepare(data)
        leaves = _named_mesh_leaves(
            mesh, datasets["global"], datasets["per-user"],
            res.model["global"].model.coefficients.means)
        idx, val, y, d = _tiny_wide(mesh.size)
        wide = make_game_dataset(y, {"wide": SparseFeatures(idx, val, d)},
                                 dtype=torch.float32, device="cpu")
        col = GameEstimator(
            TaskType.LINEAR_REGRESSION,
            {"global": FixedEffectCoordinateConfiguration(
                "wide", l2, feature_sharding="column")},
            num_iterations=1, mesh="auto", device="cpu")
        at = len(census)
        col.fit(wide)
        column = census[at:]
        # OWL-QN (elastic net) with FULL variances on the column shard:
        # the L1 term's sums and the gathered Hessian.
        enet = GLMOptimizationConfiguration(
            regularization=optim.RegularizationContext(
                optim.RegularizationType.ELASTIC_NET, 0.5),
            regularization_weight=1.0,
            variance_computation=VarianceComputationType.FULL)
        col_l1 = GameEstimator(
            TaskType.LINEAR_REGRESSION,
            {"global": FixedEffectCoordinateConfiguration(
                "wide", enet, feature_sharding="column")},
            num_iterations=1, mesh="auto", device="cpu")
        at = len(census)
        col_l1.fit(wide)
        column_l1 = census[at:]
        with open(out_path, "w") as f:
            json.dump({"rank": mesh.rank, "size": mesh.size,
                       "sequences": {"glmix_fit": glmix,
                                     "column_fit": column,
                                     "column_l1_fit": column_l1},
                       "leaves": leaves}, f)
    finally:
        mesh_mod.shutdown()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(hosts: int, root: str,
              limit: float | None = None) -> list[dict]:
    """``rank_build`` in ``hosts`` gloo processes on the CPU; each
    rank's JSON in rank order. A rank that exits non-zero, or a group
    past ``limit`` seconds (default ``BUILD_LIMIT_SECONDS``; every rank
    killed), raises."""
    import time

    limit = BUILD_LIMIT_SECONDS if limit is None else limit
    port = _free_port()
    pkg_root = str(Path(__file__).resolve().parents[2])
    procs = []
    for r in range(hosts):
        env = dict(os.environ)
        env.update(
            RANK=str(r), WORLD_SIZE=str(hosts), LOCAL_RANK=str(r),
            LOCAL_WORLD_SIZE=str(hosts), MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(port), OMP_NUM_THREADS="1",
            PHOTON_DIST_TIMEOUT_SECONDS=str(int(limit)),
            PYTHONPATH=os.pathsep.join(
                [pkg_root] + [p for p in [env.get("PYTHONPATH")] if p]))
        log = open(os.path.join(root, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "photon_tpu_torch.analysis.spmd",
             "--rank", os.path.join(root, f"rank{r}.json")],
            env=env, cwd=root, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + limit
    timed_out = False
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if timed_out:
        raise TimeoutError(f"{hosts} ranks did not end within {limit:g} s")
    out = []
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(root, f"rank{r}.log")) as f:
                tail = f.read()[-2000:]
            raise RuntimeError(f"rank {r} exited {p.returncode}: {tail}")
        with open(os.path.join(root, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _leaf_stub(row: dict):
    from photon_tpu_torch.parallel.mesh import P

    return types.SimpleNamespace(
        ndim=row["ndim"], sharding=types.SimpleNamespace(
            spec=P(*row["placed"])))


def build_mesh_spmd(hosts: int) -> SpmdTrace:
    """The mesh contract: ``hosts`` gloo ranks run the GLMix fit and the
    two column fits; each rank's ordered census of each, and the coverage of
    rank 0's placed leaves by ``PARTITION_RULES``."""
    from photon_tpu_torch.parallel import mesh as mesh_mod

    with tempfile.TemporaryDirectory(prefix="photon-spmd-") as root:
        ranks = run_ranks(hosts, root)
    traces = [HostTrace(r["rank"], r["sequences"]) for r in ranks]
    coverage = partition_coverage(
        mesh_mod.PARTITION_RULES,
        {k: _leaf_stub(v) for k, v in ranks[0]["leaves"].items()})
    counts = ", ".join(f"{name} {len(seq)}"
                       for name, seq in traces[0].sequences.items())
    notes = [f"{hosts} gloo ranks on the CPU; collectives a rank: "
             f"{counts}; {len(coverage['leaves'])} placed leaves against "
             f"{len(coverage['rules'])} partition rules"]
    return SpmdTrace(hosts=traces, coverage=coverage, notes=notes)


_BUILDERS: dict[str, Callable[[int], SpmdTrace]] = {
    "build_mesh_spmd": build_mesh_spmd,
}


def contract_from_declaration(spec: dict) -> SpmdContract:
    builder = spec.get("builder")
    if builder not in _BUILDERS:
        raise ValueError(
            f"SPMD_AUDIT declaration {spec.get('name')!r} names unknown "
            f"builder {builder!r}")
    return SpmdContract(
        name=spec["name"], entry=spec["entry"], build=_BUILDERS[builder],
        hosts=int(spec.get("hosts", 2)),
        ordered_collectives=tuple(spec.get("ordered_collectives", ())),
        partition_rules=spec.get("partition_rules"),
        suppress=dict(spec.get("suppress", {})))


def collect_contracts() -> list[SpmdContract]:
    """The port's declared SPMD contracts (module hooks)."""
    specs: list[dict] = []
    for modname in SPMD_DECLARING_MODULES:
        mod = importlib.import_module(modname)
        decl = getattr(mod, "SPMD_AUDIT", None)
        if decl is None:
            raise ValueError(f"{modname} is an SPMD declaring module but "
                             "exports no SPMD_AUDIT")
        specs.extend(decl if isinstance(decl, (list, tuple)) else [decl])
    return [contract_from_declaration(s) for s in specs]


# --------------------------------------------------------------------------
# contract checks
# --------------------------------------------------------------------------


def _step(s: dict) -> str:
    return f"{s.get('op')}@{s.get('site')}"


def check_collective_order(contract: SpmdContract,
                           trace: SpmdTrace) -> Iterator[Finding]:
    if not trace.hosts:
        return
    base = trace.hosts[0]
    for host in trace.hosts[1:]:
        for name, seq in base.sequences.items():
            other = host.sequences.get(name, [])
            ops_a = [_step(s) for s in seq]
            ops_b = [_step(s) for s in other]
            if ops_a == ops_b:
                continue
            idx = next((i for i, (x, y) in enumerate(zip(ops_a, ops_b))
                        if x != y), min(len(ops_a), len(ops_b)))
            at_a = ops_a[idx] if idx < len(ops_a) else "<end>"
            at_b = ops_b[idx] if idx < len(ops_b) else "<end>"
            yield _finding(
                contract, "spmd-collective-order",
                f"fit '{name}' collective sequences diverge between rank 0 "
                f"and rank {host.process_index} at position {idx}: {at_a} "
                f"vs {at_b} ({len(ops_a)} vs {len(ops_b)} collectives) — "
                "the group hangs at the first mismatched collective")


def check_trace_divergence(contract: SpmdContract,
                           trace: SpmdTrace) -> Iterator[Finding]:
    """Operand shapes and dtypes, position by position, where the two
    ranks' sites and ops agree (the order check names the rest)."""
    if len(trace.hosts) < 2:
        return
    base = trace.hosts[0]
    for host in trace.hosts[1:]:
        for name, seq in base.sequences.items():
            other = host.sequences.get(name)
            if other is None:
                yield _finding(
                    contract, "spmd-trace-divergence",
                    f"fit '{name}' ran on rank 0 but not on rank "
                    f"{host.process_index} — the ranks ran different fits")
                continue
            for i, (a, b) in enumerate(zip(seq, other)):
                if _step(a) != _step(b):
                    break
                if (a.get("dtype"), list(a.get("shape") or ())) != (
                        b.get("dtype"), list(b.get("shape") or ())):
                    yield _finding(
                        contract, "spmd-trace-divergence",
                        f"fit '{name}' position {i} ({_step(a)}): rank 0 "
                        f"sends {a.get('dtype')}{list(a.get('shape') or ())}"
                        f", rank {host.process_index} sends "
                        f"{b.get('dtype')}{list(b.get('shape') or ())}")
                    break


def check_implicit_reshard(contract: SpmdContract,
                           trace: SpmdTrace) -> Iterator[Finding]:
    if not trace.hosts:
        return
    declared = set(contract.ordered_collectives)
    seen_any = False
    for name, seq in trace.hosts[0].sequences.items():
        seen_any = seen_any or bool(seq)
        undeclared = [s for s in seq if s.get("site") not in declared]
        if not undeclared:
            continue
        from photon_tpu_torch.analysis import costmodel

        price = costmodel.collective_transfer(undeclared)
        link = price["min_seconds_link"]
        yield _finding(
            contract, "spmd-implicit-reshard",
            f"fit '{name}' issues collective(s) at undeclared site(s) "
            f"{', '.join(sorted({str(s.get('site')) for s in undeclared}))}"
            f" (declared: {', '.join(sorted(declared)) or 'none'}) — "
            f"{len(undeclared)} collective(s) moving "
            f"{int(price['total_bytes'])} bytes a rank a fit"
            + (f" (>= {link:.2e} s at the H100's NVLink peak)"
               if link else ""))
    if declared and not seen_any:
        yield _finding(
            contract, "spmd-contract",
            "contract declares ordered_collectives "
            f"({', '.join(sorted(declared))}) but no rank issued any "
            "collective — the declaration is unchecked")


def check_partition_coverage(contract: SpmdContract,
                             trace: SpmdTrace) -> Iterator[Finding]:
    cov = trace.coverage
    if cov is None:
        if contract.partition_rules and trace.hosts:
            yield _finding(
                contract, "spmd-contract",
                f"contract declares partition rules "
                f"({contract.partition_rules}) but the builder produced "
                "no coverage table")
        return
    rules_hit: set[int] = set()
    for name, row in cov["leaves"].items():
        if row["ndim"] == 0:
            continue  # scalars are replicated by construction
        if not row["matches"]:
            yield _finding(
                contract, "spmd-partition-coverage",
                f"placed leaf '{name}' (ndim {row['ndim']}, placed "
                f"{row['placed']}) matches NO partition rule")
            continue
        if len(row["matches"]) > 1:
            pats = ", ".join(repr(cov["rules"][i]) for i in row["matches"])
            yield _finding(
                contract, "spmd-partition-coverage",
                f"placed leaf '{name}' matches {len(row['matches'])} "
                f"partition rules ({pats}) — rules must partition the "
                "namespace, first-match ordering is a silent tiebreak")
        rules_hit.update(row["matches"][:1])
        if row["intended_sharded"] and not row["placed_sharded"]:
            yield _finding(
                contract, "spmd-partition-coverage",
                f"leaf '{name}' is intended to shard (rule "
                f"{row['rule']!r} -> {row['spec']}) but was placed "
                f"{row['placed']} — a silently-replicated slab pays a "
                "full copy on every rank")
        elif row["placed_sharded"] and not row["intended_sharded"]:
            yield _finding(
                contract, "spmd-partition-coverage",
                f"leaf '{name}' is placed sharded ({row['placed']}) but "
                f"its rule {row['rule']!r} says replicate ({row['spec']})"
                " — the rule tree and the placement code disagree")
    for i, pat in enumerate(cov["rules"]):
        if i not in rules_hit:
            yield _finding(
                contract, "spmd-contract",
                f"partition rule {pat!r} matched no placed leaf as a first "
                "match — a dead rule documents sharding that no longer "
                "exists")


CHECKS = (
    check_trace_divergence,
    check_collective_order,
    check_implicit_reshard,
    check_partition_coverage,
)


def run_checks(contract: SpmdContract, trace: SpmdTrace) -> list[Finding]:
    """All checks over one contract's trace, suppressions applied."""
    findings: list[Finding] = []
    for unknown in sorted(set(contract.suppress) - set(SPMD_RULES)):
        findings.append(_finding(contract, "spmd-contract",
                                 f"suppression names unknown rule "
                                 f"'{unknown}'"))
    for check in CHECKS:
        for f in check(contract, trace):
            reason = contract.suppress.get(f.rule)
            if reason is not None:
                f = dataclasses.replace(f, suppressed=True,
                                        suppress_reason=reason)
            findings.append(f)
    return findings


# --------------------------------------------------------------------------
# the host-divergence AST lint
# --------------------------------------------------------------------------

# Calls whose value differs between the ranks of one group. Seeded RNGs
# are deterministic and rank-uniform; only the unseeded forms vary.
_HOST_VARYING_CALLS = frozenset({
    "torch.distributed.get_rank",
    "torch.distributed.get_node_local_rank",
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "os.getpid",
    "os.urandom",
    "os.getenv",
    "socket.gethostname",
    "socket.getfqdn",
    "uuid.uuid1",
    "uuid.uuid4",
    "random.random",
    "random.randint",
    "random.randrange",
    "random.getrandbits",
    "secrets.token_bytes",
    "secrets.token_hex",
    "secrets.randbits",
    "torch.seed",
    "torch.initial_seed",
})

# A mesh's place in the group: ``mesh.rank``, ``self.is_coordinator``.
_HOST_VARYING_ATTRS = frozenset({"rank", "is_coordinator"})

# Tensor constructors whose shape argument decides the buffers a rank
# hands its collectives: a rank-varying shape is a divergent operand.
_SHAPE_CONSTRUCTORS = frozenset({
    "torch.zeros",
    "torch.ones",
    "torch.full",
    "torch.empty",
    "torch.arange",
    "torch.linspace",
    "torch.eye",
    "torch.rand",
    "torch.randn",
    "torch.randint",
    "torch.tile",
    "torch.broadcast_to",
    "torch.reshape",
    "numpy.zeros",
    "numpy.ones",
    "numpy.full",
    "numpy.empty",
    "numpy.arange",
})
_SHAPE_METHODS = frozenset({"new_zeros", "new_ones", "new_full",
                            "new_empty"})

# Collectives a function can issue: ``torch.distributed``'s, and the
# mesh's (``Mesh.all_gather`` / ``sum`` / ``sum_parts`` /
# ``gather_rows`` / ``barrier``). A branch on a rank-varying value in
# such a function can send the ranks down different collective
# sequences.
_DIST_COLLECTIVES = frozenset(
    f"torch.distributed.{op}" for op in (
        "all_gather", "all_gather_into_tensor", "all_reduce", "all_to_all",
        "barrier", "broadcast", "gather", "reduce", "reduce_scatter",
        "reduce_scatter_tensor", "scatter", "send", "recv",
        "all_gather_object", "broadcast_object_list"))
_MESH_COLLECTIVES = frozenset({"all_gather", "sum_parts", "gather_rows",
                               "barrier"})


def _host_varying_source(ctx: ModuleContext, node: ast.AST) -> str | None:
    """The rank-varying source a single expression node IS, else None."""
    if isinstance(node, ast.Call):
        resolved = ctx.resolve(node.func)
        if resolved in _HOST_VARYING_CALLS:
            return resolved
        if resolved in ("numpy.random.default_rng", "torch.Generator",
                        "random.Random") and not node.args:
            return f"{resolved}()  # unseeded"
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and ctx.resolve(node.func.value) == "os.environ"):
            return "os.environ.get"
    if (isinstance(node, ast.Subscript)
            and ctx.resolve(node.value) == "os.environ"):
        return "os.environ[...]"
    if (isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load)
            and node.attr in _HOST_VARYING_ATTRS
            and ctx.resolve(node) is None):
        return f".{node.attr}"
    return None


def _taint_sources(ctx: ModuleContext, expr: ast.AST,
                   tainted: dict[str, str]) -> list[str]:
    """Every rank-varying source reachable inside one expression."""
    out: list[str] = []
    for node in ast.walk(expr):
        src = _host_varying_source(ctx, node)
        if src is not None:
            out.append(src)
        elif (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
              and node.id in tainted):
            out.append(f"{node.id} (from {tainted[node.id]})")
    return out


def _function_taint(ctx: ModuleContext
                    ) -> dict[ast.AST | None, dict[str, str]]:
    """Per-scope forward taint map: local names assigned (directly or
    transitively, in line order) from rank-varying sources."""
    taint: dict[ast.AST | None, dict[str, str]] = {}
    assigns: list[tuple[int, ast.AST | None, ast.AST, ast.AST]] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                assigns.append((node.lineno, ctx.enclosing_function(node),
                                tgt, node.value))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and (
                node.value is not None):
            assigns.append((node.lineno, ctx.enclosing_function(node),
                            node.target, node.value))
    for _, scope, tgt, value in sorted(assigns, key=lambda t: t[0]):
        scope_taint = taint.setdefault(scope, {})
        sources = _taint_sources(ctx, value, scope_taint)
        if not sources:
            continue
        for leaf in ast.walk(tgt):
            if isinstance(leaf, ast.Name):
                scope_taint[leaf.id] = sources[0]
    return taint


def _scope_issues_collectives(ctx: ModuleContext,
                              scope: ast.AST | None) -> bool:
    """True when a function (or the module body) issues a collective:
    branches inside it select which collectives run."""
    root = scope if scope is not None else ctx.tree
    for node in ast.walk(root):
        if not isinstance(node, ast.Call):
            continue
        if ctx.resolve(node.func) in _DIST_COLLECTIVES:
            return True
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr in _MESH_COLLECTIVES:
                return True
            if func.attr == "sum" and "mesh" in ast.unparse(
                    func.value).lower():
                return True
    return False


def _shape_args(call: ast.Call) -> list[ast.AST]:
    out: list[ast.AST] = list(call.args[:1])
    out.extend(kw.value for kw in call.keywords if kw.arg in ("size",
                                                              "shape"))
    return out


def audit_source(source: str, path: str = "<string>") -> list[Finding]:
    """The spmd-host-divergence lint over one source blob: rank-varying
    values flowing into (a) a tensor constructor's shape and (b) a
    branch predicate inside a function that issues collectives. Per-line
    ``# photon: ignore[...]`` suppressions apply."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(rule="syntax-error", path=path,
                        line=exc.lineno or 1, col=(exc.offset or 1) - 1,
                        message=f"file does not parse: {exc.msg}")]
    ctx = ModuleContext(path, source, tree)
    taint = _function_taint(ctx)
    issues_cache: dict[ast.AST | None, bool] = {}
    findings: list[Finding] = []
    seen: set[tuple] = set()

    def emit(node: ast.AST, message: str) -> None:
        f = Finding(rule="spmd-host-divergence", path=path,
                    line=getattr(node, "lineno", 1),
                    col=getattr(node, "col_offset", 0), message=message)
        key = (f.line, f.col, f.message)
        if key in seen:
            return
        seen.add(key)
        sup = ctx.suppressions.get(f.line)
        if sup is not None and sup.covers(f.rule):
            f = dataclasses.replace(f, suppressed=True,
                                    suppress_reason=sup.reason)
        findings.append(f)

    for node in ast.walk(tree):
        scope = ctx.enclosing_function(node)
        scope_taint = taint.get(scope, {})
        if isinstance(node, ast.Call):
            resolved = ctx.resolve(node.func)
            method = (node.func.attr if isinstance(node.func, ast.Attribute)
                      else None)
            if resolved in _SHAPE_CONSTRUCTORS or (
                    resolved is None and method in _SHAPE_METHODS):
                for arg in _shape_args(node):
                    sources = _taint_sources(ctx, arg, scope_taint)
                    if sources:
                        emit(node,
                             f"rank-varying value ({sources[0]}) flows "
                             f"into the shape of "
                             f"{resolved or '.' + method} — ranks build "
                             "buffers of different shapes")
                        break
        elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
            sources = _taint_sources(ctx, node.test, scope_taint)
            if not sources:
                continue
            if scope not in issues_cache:
                issues_cache[scope] = _scope_issues_collectives(ctx, scope)
            if issues_cache[scope]:
                emit(node,
                     f"branch predicate on a rank-varying value "
                     f"({sources[0]}) in a function that issues "
                     "collectives — ranks taking different sides issue "
                     "different collective sequences")
    findings.sort(key=lambda f: (f.path, f.line, f.col))
    return findings


def audit_paths(paths: Iterable[str | Path]) -> list[Finding]:
    findings: list[Finding] = []
    for p in iter_python_files(paths):
        findings.extend(audit_source(p.read_text(encoding="utf-8"),
                                     path=str(p)))
    return findings


# --------------------------------------------------------------------------
# the audit driver
# --------------------------------------------------------------------------


def _package_paths() -> list[str]:
    """The port's source root, resolved from the import (not the CWD)."""
    import photon_tpu_torch

    return [str(Path(photon_tpu_torch.__file__).parent)]


def audit(contracts: Iterable[SpmdContract] | None = None, *,
          hosts: int | None = None,
          lint_paths: Iterable[str | Path] | None = None,
          with_lint: bool = True) -> tuple[list[Finding], dict]:
    """Run the host-divergence lint and every SPMD contract. ``hosts``
    overrides each contract's declared rank count. Returns ``(findings,
    report)``."""
    findings: list[Finding] = []
    report: dict[str, Any] = {"contracts": {}}
    if with_lint:
        lint = audit_paths(lint_paths if lint_paths is not None
                           else _package_paths())
        findings.extend(lint)
        report["lint"] = {"findings": len(lint),
                          "suppressed": sum(1 for f in lint if f.suppressed)}
    resolved = collect_contracts() if contracts is None else list(contracts)
    for contract in resolved:
        n_hosts = hosts if hosts is not None else contract.hosts
        entry: dict[str, Any] = {"entry": contract.entry, "hosts": n_hosts,
                                 "fits": {}, "notes": []}
        report["contracts"][contract.name] = entry
        if n_hosts < 2:
            findings.append(_finding(
                contract, "spmd-contract",
                f"contract declares {n_hosts} host(s) — the cross-rank "
                "proof needs at least 2"))
            continue
        try:
            trace = contract.build(n_hosts)
        except Exception as exc:  # noqa: BLE001 — a builder crash is a finding
            findings.append(_finding(contract, "spmd-contract",
                                     f"contract builder failed: {exc!r}"))
            continue
        entry["notes"] = list(trace.notes)
        if trace.hosts:
            base = trace.hosts[0]
            for name, seq in base.sequences.items():
                same = all(
                    [_step(s) for s in h.sequences.get(name, [])]
                    == [_step(s) for s in seq] for h in trace.hosts)
                sites: dict[str, int] = {}
                for s in seq:
                    sites[str(s.get("site"))] = sites.get(
                        str(s.get("site")), 0) + 1
                entry["fits"][name] = {"identical": same,
                                       "collectives": len(seq),
                                       "sites": sites}
        if trace.coverage is not None:
            leaves = trace.coverage["leaves"]
            entry["coverage"] = {
                "rules": len(trace.coverage["rules"]),
                "leaves": len(leaves),
                "uncovered": sorted(n for n, row in leaves.items()
                                    if row["ndim"] > 0
                                    and not row["matches"])}
        findings.extend(run_checks(contract, trace))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings, report


def render_rule_list() -> str:
    width = max(len(r) for r in SPMD_RULES)
    return "\n".join(f"{rule_id.ljust(width)}  {summary}"
                     for rule_id, summary in sorted(SPMD_RULES.items()))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank":
        rank_build(sys.argv[2])
        sys.exit(0)
    sys.exit("usage: python -m photon_tpu_torch.analysis.spmd --rank OUT")
