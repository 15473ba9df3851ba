"""The port's ``utils/timed.py`` (ported from ``tests/test_timed.py``):
the deprecated ``Timed`` shim and ``profile_trace``.

``Timed`` keeps the reference's logging contract (util/Timed.scala
"begin execution" / "executed in") while delegating to
``obs.logged_span``; ``profile_trace`` routes a block through
``torch.profiler`` (monkeypatched here), and its None-directory no-op
never imports the profiler.
"""

from __future__ import annotations

import logging
import time

import pytest
import torch.profiler

from photon_tpu_torch import obs
from photon_tpu_torch.utils.timed import Timed, profile_trace


def _make_timed(msg, log=None):
    with pytest.warns(DeprecationWarning, match="logged_span"):
        return Timed(msg, log)


def test_timed_keeps_logging_contract_and_seconds(caplog):
    log = logging.getLogger("test.timed")
    with caplog.at_level(logging.INFO, logger="test.timed"):
        with _make_timed("section", log) as t:
            time.sleep(0.01)
    assert t.seconds >= 0.01
    messages = [r.getMessage() for r in caplog.records]
    assert "section: begin execution" in messages
    assert any("section: executed in" in m for m in messages)


def test_timed_records_span_when_telemetry_enabled():
    was = obs.enabled()
    obs.reset()
    obs.enable()
    try:
        with _make_timed("legacy-section"):
            pass
        agg = obs.snapshot()["spans"]
        # The same naming as obs.logged_span: one span tree.
        assert "legacy-section" in agg
        assert agg["legacy-section"]["count"] == 1
    finally:
        obs.TRACER.enabled = was
        obs.reset()


def test_timed_is_inert_when_telemetry_disabled():
    was = obs.enabled()
    obs.reset()
    obs.disable()
    try:
        with _make_timed("quiet") as t:
            pass
        assert t.seconds >= 0.0
        assert obs.TRACER.completed() == []
    finally:
        obs.TRACER.enabled = was


class _FakeProfile:
    """Stands in for ``torch.profiler.profile``: records its entry and
    the path its trace is exported to."""

    calls: list = []

    def __init__(self, activities=None):
        self.activities = activities

    def __enter__(self):
        _FakeProfile.calls.append("enter")
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        _FakeProfile.calls.append(path)


@pytest.fixture
def fake_profiler(monkeypatch):
    _FakeProfile.calls = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    return _FakeProfile.calls


def test_profile_trace_wraps_torch_profiler(fake_profiler, tmp_path):
    """A directory routes the block through the profiler, whose trace
    lands in it; None and "" are no-ops that never enter it."""
    ran = []
    with pytest.warns(DeprecationWarning, match="profile_session"):
        with profile_trace(str(tmp_path)):
            ran.append(True)
    assert len(fake_profiler) == 2 and fake_profiler[0] == "enter"
    assert fake_profiler[1].startswith(str(tmp_path))
    assert ran == [True]

    with profile_trace(None):
        ran.append(True)
    with profile_trace(""):
        ran.append(True)
    assert len(fake_profiler) == 2  # the no-op paths never profile
    assert len(ran) == 3


def test_profile_trace_propagates_exceptions(fake_profiler, tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with pytest.warns(DeprecationWarning):
            with profile_trace(str(tmp_path)):
                raise RuntimeError("boom")
    assert fake_profiler == ["enter"]  # entered; the export never ran
