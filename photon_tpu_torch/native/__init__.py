"""The native Avro block decoder, built lazily with the system's C compiler
(the port's own copy of ``photon_tpu/native``).

The scoring and training paths read ``TrainingExampleAvro`` data and
``BayesianLinearModelAvro`` models; ``avrodec.c`` is a CPython extension
that decodes one decompressed container block from a pre-compiled schema
program, tens of times faster than the interpreter codec of
``io/avro.py``. This is host code, not a device kernel.

``get_avro_decoder()`` compiles ``avrodec.c`` on first use into
``build/native/`` under the checkout (named by a hash of the source and
the interpreter's extension suffix, so an edited source builds anew) and
returns the extension module, or None when no working compiler or
Python headers are available: the callers then decode with the
interpreter codec, as the JAX package does.
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import sysconfig
from pathlib import Path

logger = logging.getLogger(__name__)

_SOURCE = Path(__file__).resolve().parent / "avrodec.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_cached = None
_failed = False


def _build() -> str | None:
    src = _SOURCE.read_bytes()
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    tag = hashlib.blake2b(src + ext.encode(), digest_size=8).hexdigest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"photon_avrodec_{tag}{ext}"
    if out.exists():
        return str(out)
    include = sysconfig.get_paths()["include"]
    cc = os.environ.get("CC", "cc")
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cc, "-O2", "-fPIC", "-shared", f"-I{include}", str(_SOURCE),
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.info(
            "native avro decoder unavailable (%s: %s); decoding with the "
            "interpreter codec", e, detail.decode(errors="replace")[:500],
        )
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    os.replace(tmp, out)
    return str(out)


def get_avro_decoder():
    """The compiled ``photon_avrodec`` module, or None (the interpreter
    codec decodes instead)."""
    global _cached, _failed
    if _cached is not None or _failed:
        return _cached
    path = None
    try:
        path = _build()
        if path is None:
            _failed = True
            return None
        spec = importlib.util.spec_from_file_location("photon_avrodec", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _cached = mod
    except Exception as e:  # any load failure: the interpreter codec
        logger.info("native avro decoder failed to load (%s)", e)
        # A corrupt build would poison every later process; drop it so
        # the next one rebuilds from the source.
        try:
            if path is not None:
                os.unlink(path)
        except OSError:
            pass
        _failed = True
        return None
    return _cached
