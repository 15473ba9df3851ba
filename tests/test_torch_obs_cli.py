"""The port's telemetry through its CLIs and its training loop, against
the JAX package's, on the CPU.

- ``cli.train --telemetry --trace --flight-dir`` on the same small Avro
  files through both packages: each JSONL passes both packages'
  ``validate_jsonl``, each trace both ``validate_chrome_trace``; the
  span paths (stages, ``prepare``, ``fit/config:<i>``, ``coord:<cid>``,
  ``pipeline/<stage>``) are the same, and so are the record types and
  metric series but for the JAX package's XLA compile-cache counter.
- The ``coord:<cid>`` span tree of the port's estimator against the
  JAX estimator's unfused loop (the loop it takes with listeners).
- ``cli.serve --telemetry --trace --request-log`` on both: the same
  outcome counts, request-record keys and span paths; both request logs
  pass the JAX package's validator.
- A forced exception in each CLI leaves a flight dump with the JAX
  package's payload sections.
- The flags that raised until this port (``--telemetry``, ``--trace``,
  ``--flight-dir``, ``--no-flight``, the config's ``profile_dir``; and
  ``cli.serve``'s ``--request-log``) run.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json

import pytest
import torch

from photon_tpu import obs as jax_obs
from photon_tpu_torch import obs
from photon_tpu_torch.cli import serve as serve_cli
from photon_tpu_torch.cli import train as pt_train
from test_torch_serve_degraded import single_bag_files
from test_torch_train_cli import make_config, run_cli, write_glmix

# The JAX package's counter of its XLA compile cache: the port has no
# XLA cache (its counterpart is the compile_cache report).
XLA_ONLY = ("compile_cache_events_total",)


@pytest.fixture(autouse=True)
def _restore_telemetry():
    was = obs.enabled()
    yield
    obs.TRACER.enabled = was
    obs.reset()


@pytest.fixture
def files(tmp_path):
    train, val = tmp_path / "train.avro", tmp_path / "val.avro"
    write_glmix(train, 600, 1)
    write_glmix(val, 200, 2)
    return train, val


def _records(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _series(recs) -> set:
    return {r["series"] for r in recs
            if r["type"] in ("counter", "gauge", "histogram")
            and not r["series"].startswith(XLA_ONLY)}


def _train_both(tmp_path, train, val, *args, port_cfg=None):
    """Both train CLIs with ``args`` (``{side}`` in an argument names
    the side's directory); side -> its directory."""
    from photon_tpu.cli import train as jax_train

    out = {}
    for side, main, extra, more in (
            ("jax", jax_train.main, (), {}),
            ("pt", pt_train.main, ("--device", "cpu"), port_cfg or {})):
        root = tmp_path / side
        root.mkdir(exist_ok=True)
        cfg = make_config(tmp_path, train, val,
                          output_dir=str(root / "out"), **more)
        rc, _ = run_cli(main, cfg, root / "cfg.json",
                        *[a.format(side=root) for a in args], *extra)
        assert rc == 0, side
        out[side] = root
    return out


def test_train_cli_telemetry_and_trace_match_the_reference(tmp_path, files):
    train, val = files
    runs = _train_both(
        tmp_path, train, val, "--telemetry", "{side}/t.jsonl", "--trace",
        "{side}/trace.json", "--flight-dir", "{side}/flight",
        port_cfg={"profile_dir": str(tmp_path / "pt" / "profile")})
    recs = {}
    for side, root in runs.items():
        path = str(root / "t.jsonl")
        n = obs.validate_jsonl(path)
        assert jax_obs.validate_jsonl(path) == n
        m = obs.trace.validate_chrome_trace(str(root / "trace.json"))
        assert jax_obs.trace.validate_chrome_trace(
            str(root / "trace.json")) == m
        recs[side] = _records(path)
        # The snapshot rides the summary; no run crashed, so no dump.
        summary = json.loads((root / "out" / "training-summary.json")
                             .read_text())
        assert summary["telemetry"]["spans"]
        assert glob.glob(str(root / "flight" / "flight-*.json")) == []
    spans = {side: {r["path"] for r in rs if r["type"] == "span"}
             for side, rs in recs.items()}
    # The port's run was profiled: its one extra span wraps the fit.
    profiled = {p for p in spans["pt"] if "train_fit_profile" in p}
    assert profiled
    assert {p.replace("/train_fit_profile", "") for p in spans["pt"]
            if p != "train models/train_fit_profile"} == spans["jax"]
    assert {"prepare training datasets", "train models",
            "train models/fit/config:0/coord:global",
            "train models/fit/config:0/coord:per-user"} <= spans["jax"]
    types = {side: {r["type"] for r in rs} for side, rs in recs.items()}
    assert types["pt"] <= types["jax"]
    assert _series(recs["pt"]) == _series(recs["jax"])
    reports = {side: {r["name"] for r in rs if r["type"] == "report"}
               for side, rs in recs.items()}
    assert reports["pt"] == reports["jax"] == {"pipeline", "compile_cache"}
    # profile_dir holds the profiler's Chrome trace of the fit.
    (prof,) = glob.glob(str(tmp_path / "pt" / "profile" / "*.json"))
    assert json.loads(open(prof).read())["traceEvents"]


def test_coord_span_tree_matches_the_reference_estimator():
    """The port's estimator and the JAX estimator's unfused loop (taken
    with listeners) record the same span tree, update for update, with
    the same iteration attributes."""
    import test_torch_train as tt
    from photon_tpu.events import EventEmitter as JaxEmitter
    from photon_tpu_torch.events import EventEmitter

    jdata, pdata = tt.both_datasets(tt.synth(n=600))
    jest, pest = tt.both_estimators("logistic", tt.FE_2RE,
                                    num_iterations=2)
    jevents, pevents = [], []
    jest.emitter = JaxEmitter([jevents.append])
    pest.emitter = EventEmitter([pevents.append])
    trees = {}
    for side, pkg, est, data in (("jax", jax_obs, jest, jdata),
                                 ("pt", obs, pest, pdata)):
        was = pkg.enabled()
        pkg.reset()
        pkg.enable()
        try:
            est.fit(data)
            trees[side] = [(s.path, s.attrs) for s in pkg.TRACER.completed()
                           if "coord:" in s.path or s.name.startswith(
                               "fit/config")]
        finally:
            pkg.TRACER.enabled = was
            pkg.reset()
    assert trees["pt"] == trees["jax"]
    assert len(trees["pt"]) == 1 + 2 * 3
    assert [type(e).__name__ for e in pevents] == [
        type(e).__name__ for e in jevents]


def _serve(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_serve_cli_request_log_matches_the_reference(tmp_path):
    from photon_tpu.cli import serve as jax_serve_cli

    data, (model_dir, _) = single_bag_files(tmp_path)
    common = ["--model-dir", str(model_dir), "--input", str(data),
              "--id-tags", "userId", "movieId", "--batch-sizes", "1,8,64",
              "--deadline-ms", "30000"]
    outs, logs, spans = {}, {}, {}
    for side, main, extra in (("jax", jax_serve_cli.main, []),
                              ("pt", serve_cli.main, ["--device", "cpu"])):
        root = tmp_path / side
        root.mkdir()
        outs[side] = _serve(main, common + extra + [
            "--telemetry", str(root / "t.jsonl"),
            "--trace", str(root / "trace.json"),
            "--request-log", str(root / "requests.jsonl"),
            "--flight-dir", str(root / "flight")])
        for path in (root / "t.jsonl", root / "requests.jsonl"):
            assert jax_obs.validate_jsonl(str(path)) == obs.validate_jsonl(
                str(path))
        assert obs.trace.validate_chrome_trace(str(root / "trace.json"))
        logs[side] = _records(root / "requests.jsonl")
        spans[side] = {r["path"] for r in _records(root / "t.jsonl")
                       if r["type"] == "span"}
    assert outs["pt"]["request_trace"]["outcomes"] == outs["jax"][
        "request_trace"]["outcomes"] == {"served": 200}
    assert outs["pt"]["request_trace"]["records"] == 200
    assert set(outs["pt"]["request_trace"]["segment_mean_ms"]) == set(
        outs["jax"]["request_trace"]["segment_mean_ms"])
    assert logs["pt"][0] == logs["jax"][0] == {
        "type": "telemetry", "version": 1, "spans_dropped": 0,
        "events_dropped": 0}
    keys = {side: {tuple(sorted(r)) for r in recs[1:]}
            for side, recs in logs.items()}
    assert keys["pt"] == keys["jax"]
    assert len(logs["pt"]) == 201
    assert spans["pt"] == spans["jax"]
    # The outcome counts equal the queue's own counters.
    assert outs["pt"]["health"]["requests"] == 200


def test_serve_cli_no_flight_and_flags_still_refused(tmp_path):
    data, (model_dir, _) = single_bag_files(tmp_path)
    was = obs.enabled()
    out = _serve(serve_cli.main, [
        "--model-dir", str(model_dir), "--input", str(data), "--id-tags",
        "userId", "movieId", "--batch-sizes", "1,8,64", "--device", "cpu",
        "--no-flight", "--flight-dir", str(tmp_path / "flight")])
    assert out["errors"] == 0 and "request_trace" in out
    assert obs.enabled() == was  # the caller's flag is restored
    assert obs.flight.installed() is None
    # The flags that raised naming item 10 until it was ported (the
    # name is kept) now run, beside --no-flight.
    sketch = tmp_path / "serve-sketch.json"
    out = _serve(serve_cli.main, [
        "--model-dir", str(model_dir), "--input", str(data), "--id-tags",
        "userId", "movieId", "--batch-sizes", "1,8,64", "--device", "cpu",
        "--no-flight", "--monitor-port", "0", "--slo-p99-ms", "1",
        "--health-sketch", str(sketch)])
    assert out["errors"] == 0 and out["monitor"]["port"] > 0
    assert out["slo"]["p99_ms"]["target"] == 1.0
    assert out["health_sketch"]["requests_sampled"] > 0
    assert obs.health.DataSketch.load(str(sketch)).rows == out[
        "health_sketch"]["requests_sampled"]
    assert not obs.health.enabled()
    obs.health.reset()


def _flight_sections(directory) -> set:
    (path,) = glob.glob(str(directory / "flight-*.json"))
    return set(json.loads(open(path).read()))


def test_forced_exception_leaves_a_flight_dump_in_each_cli(
        tmp_path, files, monkeypatch):
    """An exception inside each CLI's run leaves flight-<pid>.json with
    the JAX package's payload sections (an in-process caller catches it,
    so the dump comes from the unwind, not the excepthook)."""
    import photon_tpu.estimators.game_estimator as jax_est
    import photon_tpu.serve.driver as jax_driver
    from photon_tpu.cli import serve as jax_serve_cli
    from photon_tpu.cli import train as jax_train
    from photon_tpu_torch.estimators import game_estimator as pt_est
    from photon_tpu_torch.serve import driver as pt_driver

    def boom(*a, **k):
        raise RuntimeError("forced")

    train, val = files
    sections = {}
    for side, main, est, extra in (
            ("jax", jax_train.main, jax_est, ()),
            ("pt", pt_train.main, pt_est, ("--device", "cpu"))):
        monkeypatch.setattr(est.GameEstimator, "fit", boom)
        root = tmp_path / f"train-{side}"
        root.mkdir()
        cfg = make_config(tmp_path, train, val, output_dir=str(root / "out"))
        with pytest.raises(RuntimeError, match="forced"):
            run_cli(main, cfg, root / "cfg.json", "--flight-dir",
                    str(root / "flight"), *extra)
        sections[f"train-{side}"] = _flight_sections(root / "flight")
    data, (model_dir, _) = single_bag_files(tmp_path)
    for side, main, drv, extra in (
            ("jax", jax_serve_cli.main, jax_driver, []),
            ("pt", serve_cli.main, pt_driver, ["--device", "cpu"])):
        monkeypatch.setattr(drv, "drive", boom)
        root = tmp_path / f"serve-{side}"
        root.mkdir()
        with pytest.raises(RuntimeError, match="forced"):
            main(["--model-dir", str(model_dir), "--input", str(data),
                  "--id-tags", "userId", "movieId", "--batch-sizes",
                  "1,8,64", "--flight-dir", str(root / "flight"), *extra])
        sections[f"serve-{side}"] = _flight_sections(root / "flight")
    assert sections["train-pt"] == sections["train-jax"]
    assert sections["serve-pt"] == sections["serve-jax"]
    assert {"reason", "host", "spans", "events", "metrics",
            "counter_deltas", "retry_stats",
            "faults_fired"} <= sections["train-pt"]


@pytest.mark.parametrize("args,overrides", [
    (["--telemetry", "{tmp}/t.jsonl"], {}),
    (["--trace", "{tmp}/t.json"], {}),
    (["--flight-dir", "{tmp}/f"], {}),
    ([], {"profile_dir": "{tmp}/p"}),
    (["--no-flight"], {}),
    (["--monitor-port", "0"], {}),
], ids=["telemetry", "trace", "flight-dir", "profile_dir", "no-flight",
        "monitor-port"])
def test_formerly_unported_telemetry_options_run(tmp_path, files, args,
                                                 overrides):
    """The options that raised naming item 10 until this port now run,
    and leave what they promise: the file, the profile, no recorder and
    the caller's flag back."""
    train, val = files
    fmt = {k: v.format(tmp=tmp_path) for k, v in overrides.items()}
    cfg = make_config(tmp_path, train, val, output_dir=str(tmp_path / "out"),
                      num_iterations=1, **fmt)
    was = obs.enabled()
    rc, line = run_cli(pt_train.main, cfg, tmp_path / "c.json", "--device",
                       "cpu", *[a.format(tmp=tmp_path) for a in args])
    assert rc == 0 and line["evaluation"]["RMSE"] < 1.0
    assert obs.enabled() == was
    assert obs.flight.installed() is None
    if "--telemetry" in args:
        assert obs.validate_jsonl(str(tmp_path / "t.jsonl")) > 1
    if "--trace" in args:
        assert obs.trace.validate_chrome_trace(str(tmp_path / "t.json"))
    if overrides:
        assert glob.glob(str(tmp_path / "p" / "train_fit_profile-*.json"))


def test_crash_fault_in_cli_train_dumps_and_names_the_fault(
        tmp_path, files, monkeypatch):
    """A ``crash`` fault at ``cd.iteration`` dumps through the faults
    listener at the raise point, and again at the CLI's unwind (the
    last dump holds the file, as in the JAX package): the dump names the
    fault that fired and carries its instant."""
    from photon_tpu_torch.resilience import InjectedCrash, faults

    train, val = files
    monkeypatch.setenv(faults.ENV_VAR, json.dumps({"faults": [
        {"point": "cd.iteration", "nth": 1, "error": "crash"}]}))
    cfg = make_config(tmp_path, train, val, output_dir=str(tmp_path / "out"))
    try:
        with pytest.raises(InjectedCrash):
            run_cli(pt_train.main, cfg, tmp_path / "c.json", "--device",
                    "cpu", "--flight-dir", str(tmp_path / "flight"))
    finally:
        faults.disarm()
    (path,) = glob.glob(str(tmp_path / "flight" / "flight-*.json"))
    payload = json.loads(open(path).read())
    assert payload["reason"] == "exception:InjectedCrash"
    assert payload["faults_fired"] == [
        {"point": "cd.iteration", "call": 1, "error": "crash"}]
    assert any(e["name"] == "fault.fired" for e in payload["events"])
    assert torch.__version__ == payload["host"]["torch_version"]
