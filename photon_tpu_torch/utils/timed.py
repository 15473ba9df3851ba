"""Section timing and optional device profiling (port of
``photon_tpu/utils/timed.py``).

.. deprecated::
    ``Timed`` is a shim over the telemetry layer
    (``photon_tpu_torch.obs.logged_span``): it keeps the reference's
    logging contract ("<msg>: begin execution" / "<msg>: executed in
    <t> s", util/Timed.scala:53-80) and a ``.seconds`` attribute, but new
    code opens an ``obs.span`` or ``obs.logged_span``. Using it emits a
    ``DeprecationWarning``.

``profile_trace`` is likewise a deprecated shim over
``photon_tpu_torch.obs.trace.profile_session``.
"""

from __future__ import annotations

import contextlib
import logging
import time
import warnings

logger = logging.getLogger("photon_tpu_torch.timed")


class Timed:
    """Context manager: log begin and end and the duration of a named
    section (Timed.measureDuration, util/Timed.scala:53-80); the
    elapsed time is ``.seconds``. Delegates to ``obs.logged_span``, so
    the log format and span naming are one."""

    def __init__(self, msg: str, log: logging.Logger | None = None):
        warnings.warn(
            "photon_tpu_torch.utils.Timed is deprecated; use "
            "photon_tpu_torch.obs.logged_span",
            DeprecationWarning,
            stacklevel=2,
        )
        self.msg = msg
        self.log = log or logger
        self.seconds = 0.0
        self._cm = None

    def __enter__(self) -> "Timed":
        from photon_tpu_torch import obs

        self._cm = obs.logged_span(self.msg, self.log)
        self._cm.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.seconds = time.perf_counter() - self._t0
        cm, self._cm = self._cm, None
        cm.__exit__(exc_type, exc, tb)


@contextlib.contextmanager
def profile_trace(trace_dir: str | None):
    """Profile the block with ``torch.profiler`` when a directory is
    given.

    .. deprecated::
        Shim over ``photon_tpu_torch.obs.trace.profile_session``. A None
        directory remains a no-op that never imports the profiler.
    """
    if not trace_dir:
        yield
        return
    warnings.warn(
        "photon_tpu_torch.utils.profile_trace is deprecated; use "
        "photon_tpu_torch.obs.trace.profile_session",
        DeprecationWarning,
        stacklevel=3,
    )
    from photon_tpu_torch.obs.trace import profile_session

    with profile_session(trace_dir):
        yield
