"""The port's program tier (``photon_tpu_torch/analysis/program.py``):
``tests/test_analysis_program.py``'s cases on the port.

- one deliberately violating fixture per check (a lambda baked into the
  program as a Python scalar, a stale recompile declaration, a float64
  cast, a host sync inside a device loop's body) and the check that
  catches it;
- the framework: contract suppressions with their reasons, a builder
  crash as a finding, unknown builders refused, the registry and its
  deferred contracts, signature stability, the CLI's usage errors;
- the port's declarations against the reference's, field by field;
- the gate: ``--semantic`` over the port's declared contracts has no
  unsuppressed finding.
"""

from __future__ import annotations

import json

import pytest
import torch

from photon_tpu_torch.analysis import program
from photon_tpu_torch.analysis.__main__ import main as cli_main
from photon_tpu_torch.analysis.program import (
    ContractTrace,
    ProgramContract,
    run_checks,
    trace_program,
)
from photon_tpu_torch.utils import device_loop


def _rules(findings, *, suppressed=False):
    return sorted(f.rule for f in findings if f.suppressed == suppressed)


def _x(n=4):
    return torch.ones(n, dtype=torch.float32)


# ---------------------------------------------------------------------------
# violating fixtures, one per check
# ---------------------------------------------------------------------------


def _baked_lambda_trace(device="cpu") -> ContractTrace:
    """A lambda baked into the program as a Python scalar: every grid
    point is a new program (a captured graph bakes the value in)."""

    def make(lam):
        return trace_program("fit", lambda x: x * lam, _x())

    return ContractTrace(
        programs={"fit": make(0.5)},
        variants={"lambda_grid": [{"fit": make(w).signature}
                                  for w in (1.0, 2.0)]})


def _operand_lambda_trace(device="cpu") -> ContractTrace:
    """The same lambda as a 0-d tensor operand: one program."""

    def make(lam):
        return trace_program("fit", lambda x, w: x * w, _x(),
                             torch.tensor(lam, dtype=torch.float32))

    return ContractTrace(
        programs={"fit": make(0.5)},
        variants={"lambda_grid": [{"fit": make(w).signature}
                                  for w in (1.0, 2.0)]})


@pytest.mark.parametrize("build, caught", [(_baked_lambda_trace, True),
                                           (_operand_lambda_trace, False)])
def test_census_catches_extra_dispatch(build, caught):
    contract = ProgramContract(name="fx-extra-dispatch", entry="<fixture>",
                               build=build, max_programs=1,
                               stable_under=("lambda_grid",))
    findings = run_checks(contract, build())
    census = [f for f in findings if f.rule == "program-dispatch-census"]
    assert bool(census) == caught
    if caught:
        assert "3 distinct compiled programs" in census[0].message


def test_census_counts_captured_graphs():
    trace = _operand_lambda_trace()
    trace.captures = 2
    contract = ProgramContract(name="fx-captures", entry="<fixture>",
                               build=lambda d: trace, max_programs=1,
                               stable_under=("lambda_grid",))
    findings = run_checks(contract, trace)
    assert _rules(findings) == ["program-dispatch-census"]
    assert "2 CUDA graphs captured" in findings[0].message


def test_recompile_key_catches_unstable_family():
    contract = ProgramContract(name="fx-unstable-key", entry="<fixture>",
                               build=_baked_lambda_trace,
                               stable_under=("lambda_grid",))
    keyed = [f for f in run_checks(contract, _baked_lambda_trace())
             if f.rule == "program-recompile-key"]
    # Both variants move the key; the message names the family and the
    # program, so the report is actionable.
    assert len(keyed) == 2
    assert all("lambda_grid" in f.message and "fit" in f.message
               for f in keyed)


def test_recompile_key_catches_stale_declaration():
    def build(device="cpu"):
        base = trace_program("fit", lambda x: x + 1.0, _x())
        # "optimizer_swap" declared a recompile trigger, but the variant
        # is the identical program.
        return ContractTrace(programs={"fit": base},
                             variants={"optimizer_swap": [
                                 {"fit": base.signature}]})

    contract = ProgramContract(name="fx-stale", entry="<fixture>",
                               build=build, recompiles_on=("optimizer_swap",))
    findings = run_checks(contract, build())
    assert _rules(findings) == ["program-recompile-key"]
    assert "no longer perturbs" in findings[0].message


@pytest.mark.parametrize("family_kind", ["recompiles_on", "stable_under"])
def test_family_without_variants_is_a_contract_error(family_kind):
    """A declared family with no generated variants is an unchecked
    guarantee: a finding, never a pass."""

    def build(device="cpu"):
        return ContractTrace(programs={
            "fit": trace_program("fit", lambda x: x, _x(2))})

    contract = ProgramContract(name="fx-unchecked", entry="<fixture>",
                               build=build,
                               **{family_kind: ("optimizer_swap",)})
    findings = run_checks(contract, build())
    assert _rules(findings) == ["program-contract"]
    assert "no variants" in findings[0].message


def _loop_with_f64(xs):
    """A device loop whose body casts to float64."""
    st = type("S", (), {})()
    st.acc = torch.zeros((), dtype=xs.dtype)
    st.i = torch.zeros((), dtype=torch.int64)

    def body(mask):
        st.acc = st.acc + xs.to(torch.float64).sum().to(xs.dtype)
        st.i = st.i + 1

    device_loop.while_loop(lambda: st.i < xs.shape[0], body, (st,),
                           any_running=lambda m: bool(m.any()))
    return st.acc


@pytest.mark.parametrize("fn", [lambda x: x.to(torch.float64),
                                _loop_with_f64],
                         ids=["straight", "loop_body"])
def test_host_boundary_catches_f64_cast(fn):
    def build(device="cpu"):
        return ContractTrace(programs={"fit": trace_program("fit", fn,
                                                            _x())})

    contract = ProgramContract(name="fx-f64", entry="<fixture>",
                               build=build, hot_loop=True)
    findings = run_checks(contract, build())
    assert _rules(findings) == ["program-f64-cast"]
    assert "float64" in findings[0].message


def _loop_with_sync(xs):
    """A device loop whose body reads a value on the host: a capture
    would refuse it; the CPU trace records the sync in the body."""
    st = type("S", (), {})()
    st.acc = torch.zeros((), dtype=xs.dtype)
    st.i = torch.zeros((), dtype=torch.int64)

    def body(mask):
        st.acc = st.acc + xs[st.i] * float(xs.sum().item())
        st.i = st.i + 1

    device_loop.while_loop(lambda: st.i < xs.shape[0], body, (st,),
                           any_running=lambda m: bool(m.any()))
    return st.acc


def test_host_boundary_catches_sync_in_loop_body():
    """The trace runs the loop body once, as a capture would: the
    ``.item()`` inside it is found, bracketed in the loop."""
    prog = trace_program("fit", _loop_with_sync, _x(8))
    assert prog.syncs and "_local_scalar_dense" in prog.syncs[0]
    lines = prog.text.splitlines()
    start = lines.index("while {")
    assert any("_local_scalar_dense" in ln and ln.startswith("  ")
               for ln in lines[start:])
    assert prog.text.count("while {") == 1

    def build(device="cpu"):
        return ContractTrace(programs={"fit": prog})

    hot = ProgramContract(name="fx-sync", entry="<fixture>", build=build,
                          hot_loop=True)
    findings = run_checks(hot, build())
    assert _rules(findings) == ["program-host-boundary"]
    assert "host sync" in findings[0].message
    # Audited as no hot loop, the sync passes (a host boundary is legal
    # at an API's edge), while float64 stays global.
    cold = ProgramContract(name="fx-sync-cold", entry="<fixture>",
                           build=build)
    assert run_checks(cold, build()) == []


_SYNCS = 0


def _counted_sync(x, extra: int):
    """One counted sync, and ``extra`` uncounted ones."""
    global _SYNCS
    _SYNCS += 1
    bool(x.sum() > 0)
    for _ in range(extra):
        float(x.max())
    return x


@pytest.mark.parametrize("extra, caught", [(0, False), (1, True)])
def test_host_boundary_holds_declared_sync_count(extra, caught):
    """A contract that syncs by design declares the counters of its
    syncs; a sync they do not count is a finding."""
    contract = ProgramContract(
        name="fx-declared", entry="<fixture>",
        build=lambda d: ContractTrace(programs={"update": trace_program(
            "update", _counted_sync, _x(), extra, kind="eager")}),
        hot_loop=True, host_syncs=(f"{__name__}:_SYNCS",),
        host_sync_reason="fixture")
    findings, report = program.audit([contract], device="cpu")
    assert bool(findings) == caught
    entry = report["contracts"]["fx-declared"]["programs"]["update"]
    assert entry["syncs"] == 1 + extra and entry["declared_syncs"] == 1
    if caught:
        assert _rules(findings) == ["program-host-boundary"]
        assert "account for 1" in findings[0].message


def test_eager_program_is_the_set_of_its_ops():
    a = trace_program("u", lambda x: (x * 0.5).sum(), _x(), kind="eager")
    b = trace_program("u", lambda x: (x * 3.0).sum(), _x(), kind="eager")
    c = trace_program("u", lambda x: (x * 3.0).mean(), _x(), kind="eager")
    assert a.signature == b.signature != c.signature


# ---------------------------------------------------------------------------
# framework behaviour
# ---------------------------------------------------------------------------


def test_contract_suppression_carries_reason():
    def build(device="cpu"):
        return ContractTrace(programs={"fit": trace_program(
            "fit", lambda x: x.to(torch.float64), _x())})

    contract = ProgramContract(
        name="fx-suppressed", entry="<fixture>", build=build, hot_loop=True,
        suppress={"program-f64-cast": "deliberate float64 fixture"})
    findings = run_checks(contract, build())
    assert _rules(findings) == []
    assert _rules(findings, suppressed=True) == ["program-f64-cast"]
    assert findings[0].suppress_reason == "deliberate float64 fixture"


def test_program_scoped_suppression_covers_that_program_only():
    """``rule@program`` suppresses one program's finding; the same rule
    in the contract's other programs still reports."""
    def build(device="cpu"):
        return ContractTrace(programs={
            name: trace_program(name, lambda x: x.to(torch.float64), _x())
            for name in ("auc", "rmse")})

    contract = ProgramContract(
        name="fx-scoped", entry="<fixture>", build=build, hot_loop=True,
        suppress={"program-f64-cast@auc": "deliberate float64 fixture"})
    findings = run_checks(contract, build())
    assert [f.message.split("'")[1] for f in findings if f.suppressed] \
        == ["auc"]
    assert [f.message.split("'")[1] for f in findings
            if not f.suppressed] == ["rmse"]


def test_builder_crash_is_a_finding_not_a_skip():
    def build(device):
        raise RuntimeError("fixture exploded")

    contract = ProgramContract(name="fx-crash", entry="<fixture>",
                               build=build)
    findings, report = program.audit([contract], device="cpu")
    assert _rules(findings) == ["program-contract"]
    assert "fixture exploded" in findings[0].message
    assert report["contracts"]["fx-crash"]["programs"] == {}


def test_declaration_with_unknown_builder_rejected():
    with pytest.raises(ValueError, match="unknown builder"):
        program.contract_from_declaration(
            dict(name="x", entry="e", builder="no_such_builder"))
    with pytest.raises(ValueError, match="unknown program contract"):
        program.collect_contracts(["no-such-contract"])


def test_registry_covers_the_declaring_modules():
    contracts = {c.name: c for c in program.collect_contracts()}
    assert set(contracts) == {
        "fused-fit", "fused-cache-key", "unfused-coordinate-update",
        "newton-kernel", "segment-reduce-kernel", "serve-kernel",
        "serving", "evaluation-scoring"}
    # The programs inside the fit loop and the request loop are all held
    # to the host boundary.
    for name in ("fused-fit", "unfused-coordinate-update", "newton-kernel",
                 "segment-reduce-kernel", "serve-kernel", "serving"):
        assert contracts[name].hot_loop
    for c in contracts.values():
        for rule_id, reason in c.suppress.items():
            assert reason and reason.strip(), (c.name, rule_id)
        for field, reason in c.port_differs.items():
            assert reason and reason.strip(), (c.name, field)
        if c.host_syncs:
            assert c.host_sync_reason and c.host_sync_reason.strip()
            assert program.counter_total(c.host_syncs) >= 0
    # The reference's other contracts are named as deferred, and the
    # mesh's as covered by the SPMD tier.
    deferred = {n for names in program.DEFERRED_CONTRACTS.values()
                for n in names}
    assert {"telemetry", "trace", "monitor", "ledger", "health",
            "fleet-obs", "resilience-retry", "ingest-pipeline",
            "streaming-ingest", "pilot"} == deferred
    assert "--spmd" in program.COVERED_ELSEWHERE["mesh-sharding"]


def test_traced_program_signature_is_text_stable():
    a = trace_program("p", lambda x: x * 2.0, _x())
    b = trace_program("p", lambda x: x * 2.0, _x())
    c = trace_program("p", lambda x: x * 3.0, _x())
    d = trace_program("p", lambda x: x * 2.0, _x(5))
    assert a.signature == b.signature
    assert len({a.signature, c.signature, d.signature}) == 3


def test_semantic_cli_usage_errors(tmp_path):
    assert cli_main(["--semantic", "photon_tpu_torch"]) == 2
    assert cli_main(["--cost-out", str(tmp_path / "x.json")]) == 2
    assert cli_main(["--device", "cuda"]) == 2
    assert cli_main(["--semantic", "--spmd"]) == 2
    assert cli_main(["--semantic", "--select", "program-contract"]) == 2


@pytest.mark.parametrize("has_card, want", [(True, "cuda"), (False, "cpu")])
def test_semantic_default_device_is_the_card_when_present(
        monkeypatch, has_card, want):
    """Without ``--device`` the tier audits the card's programs wherever
    there is a card; the CPU only when asked for or when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: has_card)
    assert program.default_device() == want
    seen = []
    contract = ProgramContract(
        name="fx-device", entry="<fixture>",
        build=lambda d: seen.append(d) or ContractTrace(programs={}))
    _, report = program.audit([contract])
    assert seen == [want] and report["device"] == want
    _, report = program.audit([contract], device="cpu")
    assert seen == [want, "cpu"] and report["device"] == "cpu"


def test_semantic_list_rules(capsys):
    assert cli_main(["--semantic", "--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule_id in program.SEMANTIC_RULES:
        assert rule_id in out


# ---------------------------------------------------------------------------
# the port's declarations against the reference's
# ---------------------------------------------------------------------------


def _reference_declarations() -> dict:
    import importlib

    from photon_tpu.analysis import program as ref

    specs = []
    for mod in ("photon_tpu.algorithm.fused_fit",
                "photon_tpu.estimators.game_estimator",
                "photon_tpu.ops.newton_kernel",
                "photon_tpu.ops.segment_reduce",
                "photon_tpu.ops.serve_kernel", "photon_tpu.serve"):
        decl = importlib.import_module(mod).PROGRAM_AUDIT
        specs.extend(decl if isinstance(decl, (list, tuple)) else [decl])
    specs.extend(ref._LOCAL_AUDITS)
    return {s["name"]: s for s in specs}


def test_rule_ids_are_the_reference_ids():
    from photon_tpu.analysis import program as ref

    assert set(program.SEMANTIC_RULES) == set(ref.SEMANTIC_RULES)


@pytest.mark.parametrize("field", ["max_programs", "stable_under",
                                   "recompiles_on", "hot_loop", "builder"])
def test_declarations_match_the_reference(field):
    """Each ported declaration's name and families are the reference's,
    except a field the port declares differently with its reason."""
    ref = _reference_declarations()
    for spec in program.declarations():
        assert spec["name"] in ref, spec["name"]
        if field in spec.get("port_differs", {}):
            continue
        want = ref[spec["name"]].get(field)
        got = spec.get(field)
        if isinstance(want, (list, tuple)):
            want, got = tuple(want), tuple(got or ())
        assert got == want, (spec["name"], field)


# ---------------------------------------------------------------------------
# the gate (through the real CLI)
# ---------------------------------------------------------------------------


def test_semantic_gate_zero_unsuppressed_findings(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = cli_main(["--semantic", "--device", "cpu", "--format", "json",
                   "--cost-out", str(out)])
    payload = json.loads(capsys.readouterr().out)
    unsuppressed = [f for f in payload["findings"] if not f["suppressed"]]
    assert rc == 0, unsuppressed
    assert unsuppressed == []
    for f in payload["findings"]:
        assert f["suppress_reason"]
    report = json.loads(out.read_text())
    assert report == payload["report"]
    contracts = report["contracts"]
    assert len(contracts) == 8
    fit = contracts["fused-fit"]["programs"]
    assert fit["fit"]["ops"] > 0 and fit["fit"]["syncs"] == 0
    assert fit["fit"]["signature"] != fit["fit_warm"]["signature"]
    upd = contracts["unfused-coordinate-update"]["programs"][
        "coordinate_update"]
    assert 0 < upd["syncs"] <= upd["declared_syncs"]
    assert "mesh-sharding" in report["covered_elsewhere"]


def test_semantic_text_report(capsys):
    assert cli_main(["--semantic", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out
    assert "contract fused-fit: materialize@" in out
    assert "contract mesh-sharding: covered by the SPMD tier" in out
    assert "not yet ported (ROADMAP Queue A item 13)" in out
