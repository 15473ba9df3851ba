"""``photon_tpu_torch.cli.health`` against the JAX package's, and the
health and monitor options of the port's ``cli.serve`` and
``cli.train`` on the CPU at a small size.

Both packages' ``cli.health`` on the same two sketch files (or work
dirs) print the same comparison, write the same ``--json`` report
(exact) and exit with the same code under ``--max-psi``; ``--url``
scrapes a live monitor's ``health_*`` families. ``cli.serve
--monitor-port 0 --health-sketch`` answers ``/readyz`` 503 before its
tables and ladder exist and 200 once it serves, and writes a sketch
that ``cli.health`` reads; ``cli.train --monitor-port 0`` answers 503
until its datasets are prepared and 200 after, and a streamed run with
the health layer armed leaves ``ingest-sketch.json`` in its ingest work
dir. Every server binds ``127.0.0.1:0`` and is stopped by the CLI that
started it.
"""

from __future__ import annotations

import contextlib
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from photon_tpu_torch.cli import health as health_cli
from photon_tpu_torch.cli import serve as serve_cli
from photon_tpu_torch.cli import train as pt_train
from photon_tpu_torch.io import model_io
from photon_tpu_torch.obs import health, monitor
from test_torch_serve_degraded import glmix_model
from test_torch_stream import _cli_config, _write_shards


@pytest.fixture(autouse=True)
def _clean_health():
    health.reset()
    health.disable()
    yield
    health.reset()
    health.disable()


def _sketch(seed, shift=0.0, rows=400):
    rng = np.random.default_rng(seed)
    sk = health.DataSketch()
    idx = rng.integers(0, 8, size=(rows, 3))
    val = rng.normal(size=(rows, 3)) + shift
    sk.update_window(rng.normal(size=rows) + shift, np.zeros(rows),
                     np.ones(rows), {"s": (idx, val)}, {"s": 8})
    return sk


def _run(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("ceiling,shift", [(None, 0.0), (0.25, 0.0),
                                           (0.25, 3.0)],
                         ids=["no-gate", "gate-ok", "gate-fires"])
def test_cli_health_matches_the_reference(tmp_path, ceiling, shift):
    from photon_tpu.cli import health as jax_health_cli

    a = tmp_path / "a.json"
    _sketch(1).save(str(a))
    # --b as a work dir: ingest-sketch.json is resolved inside.
    work = tmp_path / "work"
    work.mkdir()
    _sketch(2, shift).save(str(work / "ingest-sketch.json"))
    gate = [] if ceiling is None else ["--max-psi", str(ceiling)]
    outs = {}
    for side, main in (("pt", health_cli.main),
                       ("jax", jax_health_cli.main)):
        report = tmp_path / f"{side}.json"
        rc, text = _run(main, ["--a", str(a), "--b", str(work), *gate,
                               "--json", str(report)])
        outs[side] = (rc, text, json.loads(report.read_text()))
    assert outs["pt"] == outs["jax"]
    rc, text, report = outs["pt"]
    assert rc == (1 if shift else 0)
    assert report["b"] == str(work / "ingest-sketch.json")
    assert (report["comparison"]["max_psi"] > 0.25) == bool(shift)
    assert "== health comparison ==" in text


def test_cli_health_refuses_a_dir_without_a_sketch(tmp_path):
    with pytest.raises(SystemExit, match="no sketch artifact"):
        health_cli.main(["--a", str(tmp_path), "--b", str(tmp_path)])
    with pytest.raises(SystemExit):
        health_cli.main(["--a", str(tmp_path)])  # --b comes with --a


def test_cli_health_url_scrapes_live_families(tmp_path):
    health.enable()
    with monitor.MonitorServer(0) as srv:
        rc, text = _run(health_cli.main, ["--url", srv.url, "--json",
                                          str(tmp_path / "live.json")])
    assert rc == 0
    live = json.loads((tmp_path / "live.json").read_text())
    assert "health_enabled 1" in live["live_families"]
    assert "health_enabled 1" in text


@pytest.fixture
def started_monitors(monkeypatch):
    """Every MonitorServer a CLI starts, with the /readyz status read at
    once, before the CLI goes on: (server, first status) pairs."""
    seen = []
    start = monitor.MonitorServer.start

    def recording_start(self):
        out = start(self)
        seen.append((self, _status(self.url + "/readyz")))
        return out

    monkeypatch.setattr(monitor.MonitorServer, "start", recording_start)
    return seen


def _status(url) -> int:
    try:
        return urllib.request.urlopen(url, timeout=5).status
    except urllib.error.HTTPError as exc:
        return exc.code


def test_cli_serve_monitor_port_and_health_sketch(tmp_path, rng,
                                                   started_monitors,
                                                   monkeypatch):
    from photon_tpu_torch.serve import driver

    ckpt = model_io.save_checkpoint(glmix_model(rng),
                                    str(tmp_path / "m.npz"))
    ready_at_drive = []
    drive = driver.drive

    def probing_drive(queue, *a, **k):
        (srv, _), = started_monitors
        ready_at_drive.append(_status(srv.url + "/readyz"))
        text = urllib.request.urlopen(srv.url + "/metrics",
                                      timeout=5).read().decode()
        assert monitor.validate_exposition(text) > 0
        assert "serve_queue_depth_live" in text
        assert "health_enabled 1" in text
        return drive(queue, *a, **k)

    monkeypatch.setattr(driver, "drive", probing_drive)
    sketch = tmp_path / "serve.json"
    rc, text = _run(serve_cli.main, [
        "--checkpoint", ckpt, "--synthetic", "120", "--batch-sizes", "1,8",
        "--device", "cpu", "--no-flight", "--monitor-port", "0",
        "--slo-p99-ms", "60000", "--health-sketch", str(sketch)])
    assert rc == 0
    out = json.loads(text.strip().splitlines()[-1])
    (srv, first), = started_monitors
    assert first == 503  # up before the model loaded
    assert ready_at_drive == [200]
    assert srv._httpd is None  # stopped by the CLI
    assert out["monitor"]["scrapes"]["/readyz"] == 2
    assert out["slo"]["healthy"] and out["window_latency"]["count"] > 0
    assert out["health_tap"]["requests_sampled"] > 0
    assert set(out["hot_entities"]) == {"per-user"}
    assert out["health_sketch"]["requests_sampled"] == (
        health.DataSketch.load(str(sketch)).rows)
    assert not health.enabled()
    rc, text = _run(health_cli.main, ["--a", str(sketch), "--b",
                                      str(sketch), "--max-psi", "0"])
    assert rc == 0 and "gate OK: max PSI 0.0" in text


def test_cli_train_monitor_port_readiness(tmp_path, started_monitors,
                                          monkeypatch):
    from photon_tpu_torch.estimators.game_estimator import GameEstimator

    shards = _write_shards(str(tmp_path / "shards"))
    cfg = _cli_config(tmp_path)
    ready_at_fit = []
    fit = GameEstimator.fit

    def probing_fit(self, *a, **k):
        (srv, _), = started_monitors
        ready_at_fit.append(_status(srv.url + "/readyz"))
        return fit(self, *a, **k)

    monkeypatch.setattr(GameEstimator, "fit", probing_fit)
    health.enable()
    rc, _ = _run(pt_train.main, [
        "--config", str(cfg), "--stream-dir", shards, "--device", "cpu",
        "--monitor-port", "0", "--no-flight"])
    assert rc == 0
    (srv, first), = started_monitors
    assert first == 503 and ready_at_fit == [200]
    assert srv._httpd is None
    # The armed streamed run left its sketch in the ingest work dir,
    # which cli.health resolves.
    work = tmp_path / "out" / "ingest-work"
    sketch = health.DataSketch.load(str(work / "ingest-sketch.json"))
    assert sketch.rows == 40 * 5
    rc, text = _run(health_cli.main, ["--a", str(work), "--b", str(work)])
    assert rc == 0 and "max PSI 0.0" in text
