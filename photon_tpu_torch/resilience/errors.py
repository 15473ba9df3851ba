"""Typed failures of the artifact and data readers (the part of
``photon_tpu/resilience/errors.py`` the scoring path raises).

A corrupt artifact is neither transient nor the caller's fault: it is
not retried, and its message names the file so an operator can replace
exactly that one.
"""

from __future__ import annotations


class CorruptModelError(RuntimeError):
    """A model or checkpoint artifact failed to decode.

    Raised by ``io.model_io`` loaders instead of the codec's own
    exception (``zipfile.BadZipFile``, an Avro decode error); the message
    names the file and what failed.
    """


class CorruptShardError(RuntimeError):
    """A data shard failed to decode.

    The data-path sibling of ``CorruptModelError``: raised by the Avro
    data readers when a part file's container does not decode; the
    message names the file.
    """
