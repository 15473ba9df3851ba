"""Small utilities: section timing (``timed``)."""

from __future__ import annotations

from photon_tpu_torch.utils.timed import Timed, profile_trace

__all__ = ["Timed", "profile_trace"]
