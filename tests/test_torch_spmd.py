"""The port's SPMD tier (``photon_tpu_torch/analysis/spmd.py``): the
counterparts of ``tests/test_analysis_spmd.py``'s classes.

- every rule fires on a planted fault and stays quiet without one
  (fabricated rank censuses and coverage tables, lint fixtures);
- held against the JAX package on the same inputs: the suppression
  parser and ``ModuleContext.resolve`` of ``analysis/core.py``,
  ``collective_transfer``'s bytes, the partition-coverage table, the
  fleet census join, and the lint's framework-neutral taint sources
  (clocks, environment, hostname, pid, unseeded RNGs);
- the gate: ``python -m photon_tpu_torch.analysis --spmd --hosts 2``
  exits 0 on the port's package (real gloo ranks on the CPU); a
  contract of 1 host, a crashing builder and a builder whose ranks hang
  are findings, not crashes.
"""

from __future__ import annotations

import ast
import dataclasses
import types

import pytest

from photon_tpu_torch.analysis import core as pt_core
from photon_tpu_torch.analysis import costmodel
from photon_tpu_torch.analysis import spmd as S
from photon_tpu_torch.analysis.__main__ import main as cli_main
from photon_tpu_torch.obs import fleet
from photon_tpu_torch.parallel import mesh as mesh_mod

P = mesh_mod.P


def _rules(findings) -> list[str]:
    return sorted(f.rule for f in findings if not f.suppressed)


def _contract(**kw) -> S.SpmdContract:
    base = dict(name="t", entry="tests", build=lambda hosts: S.SpmdTrace([]))
    base.update(kw)
    return S.SpmdContract(**base)


def _rec(site, op="all_gather", dtype="float32", shape=(5,)):
    return {"op": op, "site": site, "dtype": dtype, "shape": list(shape),
            "bytes": None}


# --------------------------------------------------------------------------
# the core, held against the reference's
# --------------------------------------------------------------------------

_SOURCE = '''\
import os, time
import numpy as np
import torch.distributed as dist
from torch.distributed import get_rank as gr
x = 1  # photon: ignore[spmd-host-divergence] -- why
y = 2  # photon: ignore[a, b]
z = "# photon: ignore[c] -- inside a string"
w = 3  # photon: ignore[]: empty list means every rule
v = dist.all_gather
u = np.random.default_rng
'''


class TestCore:
    def test_suppressions_match_reference(self):
        from photon_tpu.analysis import core as ref_core

        got = pt_core._collect_suppressions(_SOURCE)
        want = ref_core._collect_suppressions(_SOURCE)
        assert {k: (v.rules, v.reason) for k, v in got.items()} == {
            k: (v.rules, v.reason) for k, v in want.items()}
        assert got[5].reason == "why" and got[8].covers("anything")
        assert 7 not in got

    def test_resolve_matches_reference(self):
        from photon_tpu.analysis import core as ref_core

        tree = ast.parse(_SOURCE)
        pt_ctx = pt_core.ModuleContext("m.py", _SOURCE, tree)
        ref_ctx = ref_core.ModuleContext("m.py", _SOURCE, tree)
        exprs = [n for n in ast.walk(tree)
                 if isinstance(n, (ast.Attribute, ast.Name))]
        assert exprs
        resolved = [pt_ctx.resolve(n) for n in exprs]
        assert resolved == [ref_ctx.resolve(n) for n in exprs]
        assert "torch.distributed.all_gather" in resolved
        assert "numpy.random.default_rng" in resolved

    def test_finding_format_and_json(self):
        f = pt_core.Finding("r", "p.py", 3, 4, "msg")
        assert f.format() == "p.py:3:5: [r] msg"
        assert f.to_json()["suppressed"] is False


# --------------------------------------------------------------------------
# transfer pricing
# --------------------------------------------------------------------------


class TestTransferPricing:
    @pytest.mark.parametrize("dtype,hlo", [
        ("float32", "f32"), ("float64", "f64"), ("int32", "s32"),
        ("bfloat16", "bf16"), ("bool", "pred")])
    def test_bytes_match_reference(self, dtype, hlo):
        from photon_tpu.analysis import costmodel as ref_cost

        shapes = [[128, 64], [7], []]
        got = costmodel.collective_transfer(
            [_rec("s", dtype=dtype, shape=s) for s in shapes])
        want = ref_cost.collective_transfer(
            [{"op": "all-gather",
              "shape": f"{hlo}[{','.join(map(str, s))}]"} for s in shapes])
        assert got["total_bytes"] == want["total_bytes"]
        assert [o["bytes"] for o in got["ops"]] == [
            o["bytes"] for o in want["ops"]]

    def test_recorded_bytes_win_and_link_bound(self):
        priced = costmodel.collective_transfer(
            [dict(_rec("s"), bytes=1000)])
        assert priced["total_bytes"] == 1000
        peak = costmodel.CHIP_PEAKS[costmodel.DEFAULT_CHIP][
            "link_bytes_per_sec"]
        assert peak == 900e9
        assert priced["min_seconds_link"] == pytest.approx(1000 / peak)


# --------------------------------------------------------------------------
# the census checks
# --------------------------------------------------------------------------


def _trace(seq_a, seq_b, name="fit"):
    return S.SpmdTrace(hosts=[S.HostTrace(0, {name: seq_a}),
                              S.HostTrace(1, {name: seq_b})])


class TestCollectiveOrder:
    def test_mismatched_order_names_the_position(self):
        trace = _trace([_rec("a"), _rec("b")], [_rec("b"), _rec("a")])
        found = list(S.check_collective_order(_contract(), trace))
        assert _rules(found) == ["spmd-collective-order"]
        msg = found[0].message
        assert "position 0" in msg
        assert "all_gather@a vs all_gather@b" in msg
        assert "hangs" in msg

    def test_length_mismatch_diverges_at_end(self):
        trace = _trace([_rec("a")], [_rec("a"), _rec("b")])
        found = list(S.check_collective_order(_contract(), trace))
        assert _rules(found) == ["spmd-collective-order"]
        assert "<end> vs all_gather@b" in found[0].message

    def test_op_mismatch_at_one_site(self):
        trace = _trace([_rec("a")], [_rec("a", op="barrier")])
        found = list(S.check_collective_order(_contract(), trace))
        assert _rules(found) == ["spmd-collective-order"]

    def test_matching_order_passes(self):
        trace = _trace([_rec("a"), _rec("a")], [_rec("a"), _rec("a")])
        assert list(S.check_collective_order(_contract(), trace)) == []


class TestTraceDivergence:
    def test_shape_divergence_names_the_position(self):
        trace = _trace([_rec("a"), _rec("b", shape=(4,))],
                       [_rec("a"), _rec("b", shape=(5,))])
        found = list(S.check_trace_divergence(_contract(), trace))
        assert _rules(found) == ["spmd-trace-divergence"]
        assert "position 1" in found[0].message
        assert "float32[4]" in found[0].message

    def test_dtype_divergence(self):
        trace = _trace([_rec("a")], [_rec("a", dtype="float64")])
        found = list(S.check_trace_divergence(_contract(), trace))
        assert _rules(found) == ["spmd-trace-divergence"]

    def test_missing_fit_on_one_rank(self):
        trace = S.SpmdTrace(hosts=[S.HostTrace(0, {"fit": [_rec("a")]}),
                                   S.HostTrace(1, {})])
        found = list(S.check_trace_divergence(_contract(), trace))
        assert _rules(found) == ["spmd-trace-divergence"]
        assert "not on rank 1" in found[0].message

    def test_identical_traces_pass(self):
        trace = _trace([_rec("a"), _rec("b")], [_rec("a"), _rec("b")])
        assert list(S.check_trace_divergence(_contract(), trace)) == []


class TestImplicitReshard:
    def test_undeclared_site_is_priced(self):
        trace = S.SpmdTrace(hosts=[S.HostTrace(0, {"fit": [
            _rec("declared"), _rec("rogue", shape=(128, 64))]})])
        c = _contract(ordered_collectives=("declared",))
        found = list(S.check_implicit_reshard(c, trace))
        assert _rules(found) == ["spmd-implicit-reshard"]
        msg = found[0].message
        assert "rogue" in msg
        assert f"{128 * 64 * 4} bytes" in msg
        assert "NVLink" in msg

    def test_unchecked_declaration_is_a_contract_finding(self):
        trace = S.SpmdTrace(hosts=[S.HostTrace(0, {"fit": []})])
        c = _contract(ordered_collectives=("declared",))
        found = list(S.check_implicit_reshard(c, trace))
        assert _rules(found) == ["spmd-contract"]
        assert "unchecked" in found[0].message

    def test_declared_sites_pass(self):
        trace = S.SpmdTrace(hosts=[S.HostTrace(0, {"fit": [_rec("d")]})])
        c = _contract(ordered_collectives=("d",))
        assert list(S.check_implicit_reshard(c, trace)) == []

    def test_unlabelled_collective_is_undeclared(self):
        """A collective issued without a site records its caller, which
        no contract declares."""
        import torch

        stats = mesh_mod.CollectiveStats()
        stats.record("all_gather", mesh_mod._caller_site(0),
                     torch.zeros(3), 0.0)
        site = stats.census[0]["site"]
        assert site.endswith(":test_unlabelled_collective_is_undeclared")
        assert site not in mesh_mod.SPMD_AUDIT["ordered_collectives"]
        assert stats.by_site[site]["bytes"] == 12


# --------------------------------------------------------------------------
# partition-rule coverage
# --------------------------------------------------------------------------


def _leaf(ndim: int, spec=None):
    sharding = None if spec is None else types.SimpleNamespace(spec=spec)
    return types.SimpleNamespace(ndim=ndim, sharding=sharding)


class TestPartitionCoverage:
    RULES = ((r"^fe/", P("data")), (r"^coef(/|$)", P()))

    def _check(self, leaves, rules=None):
        cov = S.partition_coverage(self.RULES if rules is None else rules,
                                   leaves)
        trace = S.SpmdTrace(hosts=[S.HostTrace(0)], coverage=cov)
        return list(S.check_partition_coverage(
            _contract(partition_rules="RULES"), trace))

    def _clean_leaves(self):
        return {"fe/features": _leaf(2, P("data")), "coef/w": _leaf(1, P())}

    def test_table_matches_reference(self):
        from jax.sharding import PartitionSpec as JP

        from photon_tpu.analysis import spmd as ref_spmd
        from photon_tpu.parallel import mesh as ref_mesh

        def leaves(spec):
            return {"fe/features": _leaf(2, spec("data")),
                    "fe/labels": _leaf(1, spec()),
                    "re/block0/proj": _leaf(2, spec("data")),
                    "re/raw": _leaf(2, spec()),
                    "coef/w": _leaf(1, spec()), "zz/s": _leaf(0),
                    "nothing/here": _leaf(1, spec())}

        got = S.partition_coverage(mesh_mod.PARTITION_RULES, leaves(P))
        want = ref_spmd.partition_coverage(ref_mesh.PARTITION_RULES,
                                           leaves(JP))
        assert got == want

    def test_rules_are_the_reference_rules(self):
        from photon_tpu.parallel import mesh as ref_mesh

        assert [(p, tuple(s)) for p, s in mesh_mod.PARTITION_RULES] == [
            (p, tuple(s)) for p, s in ref_mesh.PARTITION_RULES]

    def test_clean_coverage_passes(self):
        assert self._check(self._clean_leaves()) == []

    def test_uncovered_leaf(self):
        leaves = self._clean_leaves()
        leaves["re/block0/proj"] = _leaf(2, P("data"))
        found = self._check(leaves)
        assert _rules(found) == ["spmd-partition-coverage"]
        assert "matches NO partition rule" in found[0].message

    def test_ambiguous_leaf(self):
        found = self._check(self._clean_leaves(),
                            self.RULES + ((r"features$", P()),))
        assert "spmd-partition-coverage" in _rules(found)
        assert any("2 partition rules" in f.message for f in found)

    def test_silently_replicated_slab(self):
        leaves = self._clean_leaves()
        leaves["fe/features"] = _leaf(2, P())
        found = self._check(leaves)
        assert _rules(found) == ["spmd-partition-coverage"]
        assert "silently-replicated slab" in found[0].message

    def test_placement_contradicts_rule(self):
        leaves = self._clean_leaves()
        leaves["coef/w"] = _leaf(1, P("data"))
        found = self._check(leaves)
        assert _rules(found) == ["spmd-partition-coverage"]
        assert "disagree" in found[0].message

    def test_dead_rule(self):
        leaves = self._clean_leaves()
        del leaves["coef/w"]
        found = self._check(leaves)
        assert _rules(found) == ["spmd-contract"]
        assert "dead rule" in found[0].message

    def test_scalars_are_exempt(self):
        leaves = self._clean_leaves()
        leaves["zz/scalar"] = _leaf(0)
        assert self._check(leaves) == []


# --------------------------------------------------------------------------
# the host-divergence lint
# --------------------------------------------------------------------------


class TestHostDivergenceLint:
    def test_rank_in_a_shape(self):
        src = ("import torch\n"
               "import torch.distributed as dist\n"
               "def build():\n"
               "    n = dist.get_rank()\n"
               "    return torch.zeros((n + 1, 4))\n")
        found = S.audit_source(src)
        assert _rules(found) == ["spmd-host-divergence"]
        assert "shape" in found[0].message

    def test_mesh_rank_in_a_new_zeros_shape(self):
        src = ("def pad(mesh, t):\n"
               "    k = mesh.rank\n"
               "    return t.new_zeros(k)\n")
        assert _rules(S.audit_source(src)) == ["spmd-host-divergence"]

    def test_branch_on_rank_in_a_function_with_collectives(self):
        src = ("def fit(mesh, t):\n"
               "    if mesh.is_coordinator:\n"
               "        t = t + 1\n"
               "    return mesh.sum(t, site='s')\n")
        found = S.audit_source(src)
        assert _rules(found) == ["spmd-host-divergence"]
        assert "branch predicate" in found[0].message

    def test_branch_on_env_around_a_dist_collective(self):
        src = ("import os\n"
               "import torch.distributed as dist\n"
               "def sync(t):\n"
               "    if os.environ.get('RANK') == '0':\n"
               "        dist.barrier()\n")
        assert _rules(S.audit_source(src)) == ["spmd-host-divergence"]

    def test_branch_outside_collective_scope_passes(self):
        src = ("def log(mesh):\n"
               "    if mesh.rank == 0:\n"
               "        print('hello')\n")
        assert S.audit_source(src) == []

    def test_time_and_env_are_host_varying(self):
        src = ("import os, time\n"
               "import torch\n"
               "def build():\n"
               "    k = int(time.time())\n"
               "    j = int(os.environ.get('N', '1'))\n"
               "    return torch.zeros((k,)), torch.zeros((j,))\n")
        assert _rules(S.audit_source(src)) == ["spmd-host-divergence"] * 2

    def test_suppression_applies(self):
        src = ("import torch\n"
               "import torch.distributed as dist\n"
               "def build():\n"
               "    n = dist.get_rank()\n"
               "    return torch.zeros((n,))"
               "  # photon: ignore[spmd-host-divergence] -- test fixture\n")
        found = S.audit_source(src)
        assert len(found) == 1 and found[0].suppressed
        assert found[0].suppress_reason == "test fixture"

    def test_neutral_sources_match_reference(self):
        """Clocks, the environment, hostname, pid and unseeded RNGs are
        rank-varying to both packages' lints."""
        from photon_tpu.analysis import core as ref_core
        from photon_tpu.analysis import spmd as ref_spmd

        src = ("import os, socket, time, uuid\n"
               "import numpy as np\n"
               "a = time.time()\n"
               "b = time.perf_counter()\n"
               "c = os.environ.get('LOCAL_RANK')\n"
               "d = os.environ['RANK']\n"
               "e = socket.gethostname()\n"
               "f = os.getpid()\n"
               "g = np.random.default_rng()\n"
               "h = np.random.default_rng(7)\n"
               "i = uuid.uuid4()\n"
               "j = os.getenv('X')\n")
        tree = ast.parse(src)
        pt_ctx = pt_core.ModuleContext("m.py", src, tree)
        ref_ctx = ref_core.ModuleContext("m.py", src, tree)
        values = [n.value for n in tree.body if isinstance(n, ast.Assign)]
        got = [S._taint_sources(pt_ctx, v, {}) for v in values]
        want = [ref_spmd._taint_sources(ref_ctx, v, {}) for v in values]
        assert got == want
        assert [bool(g) for g in got] == [True] * 7 + [False, True, True]

    def test_port_package_lint_is_clean(self):
        found = S.audit_paths(S._package_paths())
        assert [f for f in found if not f.suppressed] == []
        assert all(f.suppress_reason for f in found if f.suppressed)


# --------------------------------------------------------------------------
# contracts
# --------------------------------------------------------------------------


class TestContractHygiene:
    def test_unknown_builder_is_an_error(self):
        with pytest.raises(ValueError, match="unknown\\s+builder"):
            S.contract_from_declaration(
                dict(name="ghost", entry="x", builder="no_such_builder"))

    def test_unknown_suppress_key_is_a_finding(self):
        c = _contract(suppress={"not-a-rule": "why"})
        found = S.run_checks(c, S.SpmdTrace(hosts=[]))
        assert _rules(found) == ["spmd-contract"]
        assert "unknown rule 'not-a-rule'" in found[0].message

    def test_contract_suppression_applies_by_rule(self):
        trace = _trace([_rec("a")], [])
        c = _contract(suppress={"spmd-collective-order": "known fixture"})
        found = S.run_checks(c, trace)
        assert [f for f in found if f.rule == "spmd-collective-order"]
        assert all(f.suppressed for f in found
                   if f.rule == "spmd-collective-order")

    def test_repo_declaration(self):
        contracts = S.collect_contracts()
        assert [c.name for c in contracts] == ["mesh-spmd"]
        c = contracts[0]
        assert c.hosts == 2 and c.partition_rules == "PARTITION_RULES"
        for site in ("glm.row_sums", "random_effect.bucket_gather",
                     "score.row_gather", "column.margins",
                     "column.coefficient_gather"):
            assert site in c.ordered_collectives


# --------------------------------------------------------------------------
# the fleet census join, held against the reference's
# --------------------------------------------------------------------------


class TestFleetCensusJoin:
    def _report(self, missing=()):
        return {"bundles": 2 - len(missing),
                "ranks": [r for r in (0, 1) if r not in missing],
                "missing_ranks": list(missing), "wall_seconds": 5.0,
                "per_rank": []}

    @pytest.mark.parametrize("missing,ops", [
        ((), ["all-reduce"]), ((1,), ["all-reduce", "all-gather"]),
        ((1,), [])])
    def test_join_matches_reference(self, missing, ops):
        from photon_tpu.obs import fleet as ref_fleet

        got_report, want_report = self._report(missing), self._report(missing)
        got = fleet.crosscheck_collective_census(got_report, ops)
        want = ref_fleet.crosscheck_collective_census(want_report, ops)
        assert got == want
        assert (fleet.multichip_row(got_report, n_devices=2)
                == ref_fleet.multichip_row(want_report, n_devices=2))

    def test_port_census_records_join(self):
        report = self._report(missing=(1,))
        entry = fleet.crosscheck_collective_census(
            report, [_rec("column.margins"), _rec("glm.row_sums")])
        assert entry["ops"] == ["all_gather@column.margins",
                                "all_gather@glm.row_sums"]
        assert entry["count"] == 2 and len(entry["mismatches"]) == 1
        assert "rank 1" in entry["mismatches"][0]


# --------------------------------------------------------------------------
# the audit and the CLI gate
# --------------------------------------------------------------------------


class TestAuditGate:
    def test_cli_spmd_exits_zero_on_the_port(self, capsys):
        assert cli_main(["--spmd", "--hosts", "2"]) == 0
        out = capsys.readouterr().out
        assert "contract mesh-spmd (2 hosts)" in out
        assert "glmix_fit@ok" in out and "column_fit@ok" in out
        assert "column_l1_fit@ok" in out
        assert "column.margins" in out and "glm.row_sums" in out
        assert "column.hessian_gather" in out
        assert "12 leaves / 5 rules" in out

    def test_cli_arg_validation(self):
        assert cli_main(["--spmd", "photon_tpu_torch"]) == 2
        assert cli_main(["--spmd", "--hosts", "1"]) == 2
        assert cli_main(["--hosts", "2", "--memory"]) == 2
        assert cli_main(["--spmd", "--select", "spmd-contract"]) == 2
        assert cli_main(["--spmd", "--numerics"]) == 2

    def test_unported_tiers_name_the_item(self, capsys):
        for flag in ("--concurrency", "--memory", "--numerics"):
            assert cli_main([flag]) == 2
        assert cli_main(["photon_tpu_torch"]) == 2
        err = capsys.readouterr().err
        assert err.count("ROADMAP Queue A item 13") == 4

    def test_list_rules(self, capsys):
        assert cli_main(["--spmd", "--list-rules"]) == 0
        out = capsys.readouterr().out
        for rule_id in S.SPMD_RULES:
            assert rule_id in out

    def test_rule_ids_are_the_reference_ids(self):
        from photon_tpu.analysis import spmd as ref_spmd

        assert set(S.SPMD_RULES) == set(ref_spmd.SPMD_RULES)

    def test_audit_hosts_below_two_is_a_contract_finding(self):
        findings, report = S.audit([_contract(hosts=1)], with_lint=False)
        assert any(f.rule == "spmd-contract" and "at least 2" in f.message
                   for f in findings)
        assert report["contracts"]["t"]["hosts"] == 1

    def test_builder_crash_is_a_finding_not_a_crash(self):
        def boom(hosts):
            raise RuntimeError("fixture blew up")

        findings, _ = S.audit([_contract(build=boom)], with_lint=False)
        assert any(f.rule == "spmd-contract" and "builder failed" in f.message
                   for f in findings)

    def test_hanging_ranks_are_a_finding(self, monkeypatch):
        """Ranks still running past the builder's limit are killed and
        the contract gets a finding."""
        monkeypatch.setattr(S, "BUILD_LIMIT_SECONDS", 0.5)
        c = dataclasses.replace(S.collect_contracts()[0])
        findings, _ = S.audit([c], with_lint=False)
        assert any(f.rule == "spmd-contract" and "did not end" in f.message
                   for f in findings)
