"""The port's ``cli.profile`` and the fit's cost-ledger rows, ported from
``tests/test_ledger.py``'s ``TestEndToEnd``: the workload's fit is the
fused fit, as in the JAX package, so its rows are ``fused_fit`` rows
(``FusedFit._ledger_record``), then:

- ``_tiny_workload(128, 6, 2)`` fitted by both packages (the JAX
  package on its unfused loop, the loop the port mirrors): the
  coefficients within the bounds of an f32 solve against float64 that
  ``tests/test_torch_wide.py`` derives (fixed effect 5e-4, random
  effects 2e-3), and within 1e-9 in float64;
- ``main`` on the CPU: exit 0 with both kernel probes None;
- with the ledger off, a fit registers nothing and makes the host syncs
  a fit with telemetry off makes; with it on, the ledger adds none on
  the CPU.

The ``cuda`` cases (``--noconftest -m cuda`` on the card; this module
imports JAX only inside its CPU tests) run ``main`` with both probes
launching their kernel once, and a warm fused fit (one graph replay)
whose ledger rows register the Newton kernel's bucket shapes with their
counts, with no solver or feed sync and the Newton launches (counted on
the card) of the ledger-off replay.
"""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from photon_tpu_torch import obs
from photon_tpu_torch.algorithm import coordinate_descent as cd_mod
from photon_tpu_torch.algorithm import random_effect as ra
from photon_tpu_torch.algorithm.fused_fit import FIT_PROGRAM
from photon_tpu_torch.cli import profile
from photon_tpu_torch.obs import ledger
from photon_tpu_torch.optim import batched, lbfgs

FE_ATOL = 5e-4
RE_ATOL = 2e-3
F64_ATOL = 1e-9


@pytest.fixture(autouse=True)
def _clean_ledger():
    was = obs.enabled()
    ledger.disable()
    ledger.reset()
    yield
    ledger.disable()
    ledger.reset()
    obs.TRACER.enabled = was
    obs.reset()


@pytest.fixture
def armed():
    obs.enable()
    ledger.enable()
    yield


def host_syncs() -> int:
    """Every host sync a fit counts: the solvers' and the ledger feed's."""
    return (lbfgs.host_syncs + batched.host_syncs + ra.host_syncs
            + cd_mod.feed_syncs)


# ---------------------------------------------------------------------------
# TestEndToEnd, on the port's fit
# ---------------------------------------------------------------------------


class TestEndToEnd:
    def test_fit_and_serve_feed_the_ledger(self, armed):
        est, data = profile._tiny_workload(128, 6, 2, device="cpu")
        mark = ledger.mark()
        # The first fit builds its program (its window is not attributed
        # and books the materialize row); the second is warm.
        profile._fit_once(est, data)
        result = profile._fit_once(est, data)
        profile._serve_pass(result, data)
        snap = ledger.snapshot()
        assert {"materialize", FIT_PROGRAM} <= set(snap["programs"])
        assert any(
            k.startswith("serve/score@") for k in snap["programs"]
        )
        rows = {
            (r["coordinate"], r["phase"], r["program"])
            for r in snap["rows"]
        }
        # Per-coordinate fit attribution + the explicit residual.
        assert ("global", "fit", FIT_PROGRAM) in rows
        assert ("per-user", "fit", FIT_PROGRAM) in rows
        assert ("-", "host", "unattributed") in rows
        assert snap["resident_bytes"].get(f"{FIT_PROGRAM}/slabs", 0) > 0
        assert any(
            k.startswith("table/") for k in snap["resident_bytes"]
        )
        out = ledger.attribution_since(mark)
        assert out["attributed_fraction"] is not None
        top = ledger.top_k(3)
        assert top and all("blocking" in r for r in top)

    def test_ledger_off_fit_registers_zero_programs(self):
        obs.enable()
        assert not ledger.enabled()
        est, data = profile._tiny_workload(96, 5, 2, device="cpu")
        profile._fit_once(est, data)
        snap = ledger.snapshot()
        assert snap["programs"] == {}
        assert snap["rows"] == []
        assert snap["resident_bytes"] == {}

    def test_profile_cli_main(self, tmp_path):
        out = tmp_path / "profile.json"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = profile.main([
                "--rows", "128", "--entities", "6", "--fits", "2",
                "--json", str(out), "--device", "cpu",
            ])
        assert rc == 0
        doc = json.loads(out.read_text())
        assert doc["failures"] == []
        assert doc["report"]["rows"]
        assert doc["fit_window"]["attributed_fraction"]
        named = [
            r for r in doc["attribution"]["rows"]
            if r["program"] != "unattributed"
        ]
        assert named


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


def _coefficients(model) -> dict:
    out = {}
    for cid, m in model.items():
        glm = getattr(m, "model", None)
        c = glm.coefficients.means if glm is not None else m.coefficients
        if isinstance(c, torch.Tensor):
            c = c.detach().cpu()
        out[cid] = np.asarray(c, dtype=np.float64)
    return out


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_tiny_workload_fit_matches_the_reference(monkeypatch, precision):
    import jax.numpy as jnp

    from photon_tpu.cli import profile as jax_profile
    from photon_tpu.data import game_data as jax_game_data

    from photon_tpu_torch.data import game_data as pt_game_data

    if precision == "float64":
        # Both workloads' datasets in float64, through each package's
        # make_game_dataset (the workloads build float32 data).
        for mod, dtype in ((jax_game_data, jnp.float64),
                           (pt_game_data, torch.float64)):
            make = mod.make_game_dataset
            monkeypatch.setattr(
                mod, "make_game_dataset",
                lambda *a, make=make, dtype=dtype, **kw: make(
                    *a, **kw, dtype=dtype))
    jest, jdata = jax_profile._tiny_workload(128, 6, 2)
    # The non-finite guard keeps the JAX estimator on its unfused loop;
    # it changes no result of a finite fit.
    jest.non_finite_guard = True
    pest, pdata = profile._tiny_workload(128, 6, 2, device="cpu")
    assert pdata.labels.dtype == getattr(torch, precision)
    jres = jest.fit(jdata)[0]
    pres = profile._fit_once(pest, pdata)
    want, got = _coefficients(jres.model), _coefficients(pres.model)
    assert want.keys() == got.keys() == {"global", "per-user"}
    for cid in want:
        atol = (F64_ATOL if precision == "float64"
                else FE_ATOL if cid == "global" else RE_ATOL)
        np.testing.assert_allclose(got[cid], want[cid], rtol=0, atol=atol,
                                   err_msg=cid)


def test_profile_main_on_the_cpu_has_no_probes(tmp_path):
    out = tmp_path / "profile.json"
    with contextlib.redirect_stdout(io.StringIO()) as text:
        rc = profile.main(["--rows", "128", "--entities", "6", "--fits",
                           "1", "--top", "3", "--json", str(out),
                           "--device", "cpu"])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["kernel_probe"] is None
    assert doc["serve_kernel_probe"] is None
    assert doc["failures"] == [] and doc["overhead"] is None
    assert "fit-window attribution" in text.getvalue()


def test_ledger_off_fit_adds_no_sync_and_no_row():
    est, data = profile._tiny_workload(128, 6, 2, device="cpu")
    profile._fit_once(est, data)  # prepare, outside the counts

    def counted_fit():
        before = host_syncs()
        result = est.fit(data)[0]
        return host_syncs() - before, _coefficients(result.model)

    obs.disable()
    off_syncs, off_model = counted_fit()
    obs.enable()
    on_syncs, on_model = counted_fit()
    assert ledger.snapshot()["programs"] == {}
    assert ledger.snapshot()["rows"] == []
    assert on_syncs == off_syncs > 0
    ledger.enable()
    armed_syncs, armed_model = counted_fit()
    # On the CPU the feed reads perf_counter stamps: no sync either.
    assert armed_syncs == off_syncs
    for cid in off_model:
        assert np.array_equal(on_model[cid], off_model[cid])
        assert np.array_equal(armed_model[cid], off_model[cid])


@pytest.mark.parametrize("fit_seconds,fits_per_sample",
                         [(0.02, 50), (0.4, 3)])
def test_overhead_ab_samples_span_the_sample_time(monkeypatch, fit_seconds,
                                                  fits_per_sample):
    """Each A/B sample holds at least 3 fits an arm, lasting at least
    ``AB_SAMPLE_SECONDS``, from one ledger-off fit timed first, the
    arms alternating fit by fit (off, on, on, off, ...); the overhead is
    the median of the samples' on/off ratios minus 1: every fit on a
    fake clock, an armed fit 1% slower."""
    clock = [0.0]
    arms: list = []

    def fit_once(est, data):
        clock[0] += fit_seconds * (1.01 if ledger.enabled() else 1.0)
        arms.append(ledger.enabled())

    monkeypatch.setattr(profile, "_fit_once", fit_once)
    monkeypatch.setattr(profile.time, "perf_counter", lambda: clock[0])
    out = profile._overhead_ab(None, None, samples=3)
    k = fits_per_sample
    assert out["fits_per_sample"] == k and out["samples"] == 3
    sample = ([False, True, True, False] * k)[:2 * k]
    assert arms == [False] + sample * 3
    assert out["off_best_seconds"] == pytest.approx(k * fit_seconds)
    assert out["overhead_fraction"] == pytest.approx(0.01, abs=1e-4)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_profile_probes_launch_their_kernels(cuda_device, tmp_path):
    from photon_tpu_torch.ops import newton_kernel as nk

    out = tmp_path / "profile.json"
    nk.launches = 0
    ra.plain_route_solves = 0
    with contextlib.redirect_stdout(io.StringIO()):
        rc = profile.main(["--rows", "512", "--entities", "16",
                           "--fits", "2", "--json", str(out)])
    doc = json.loads(out.read_text())
    assert rc == 0, doc["failures"]
    assert nk.launches > 0 and ra.plain_route_solves == 0
    for key in ("kernel_probe", "serve_kernel_probe"):
        probe = doc[key]
        assert probe is not None and probe["launches"] == 1
        row = next(r for r in doc["report"]["rows"]
                   if r["program"] == probe["program"])
        assert row["vs_roofline"] is not None
    assert doc["fit_window"]["attributed_fraction"] > 0
    programs = doc["report"]["programs"]
    assert any(k.startswith("newton_step/") and v["cost"]["flops"] > 0
               for k, v in programs.items())


@pytest.mark.cuda
def test_cuda_fit_feed_syncs_once_and_launches_as_off(cuda_device):
    """A warm fused fit is one replay: with the ledger armed it makes no
    solver or feed sync (the span's one sync waits for the outputs) and
    launches the Newton kernel as often as with the ledger off (counted
    on the card: ``device_loop.count_graph_launches``)."""
    from photon_tpu_torch.utils import device_loop

    device_loop.count_graph_launches(cuda_device)
    est, data = profile._tiny_workload(512, 16, 2, device=cuda_device)
    profile._fit_once(est, data)

    def counted_fit():
        syncs = host_syncs()
        device_loop.reset_graph_launches()
        result = profile._fit_once(est, data)
        return (host_syncs() - syncs,
                device_loop.graph_launches("newton_step"),
                _coefficients(result.model))

    obs.enable()
    off = counted_fit()
    ledger.enable()
    feed_before = cd_mod.feed_syncs
    on = counted_fit()
    assert cd_mod.feed_syncs == feed_before
    assert on[0] == off[0] == 0 and on[1] == off[1] > 0
    again = counted_fit()
    assert again[:2] == on[:2]
    for cid in off[2]:
        assert np.array_equal(on[2][cid], off[2][cid])
    snap = ledger.snapshot()
    shapes = [k for k in snap["programs"] if k.startswith("newton_step/")]
    assert shapes and all(snap["programs"][k]["cost"]["hbm_bytes"] > 0
                          for k in shapes)
    rows = {(r["coordinate"], r["program"]): r for r in snap["rows"]}
    assert rows[("per-user", FIT_PROGRAM)]["seconds"] > 0
