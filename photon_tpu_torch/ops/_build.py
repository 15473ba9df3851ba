"""Build and load the port's CUDA kernels.

Every ``photon_tpu_torch/csrc/*.cu`` source is compiled by ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
``build/kernels/<hash>/libphoton_torch_kernels.so`` under the checkout,
the first time a kernel is needed. ``<hash>`` covers the sources and the
flags, so an edited source builds anew and an unchanged one is loaded as
it is. One ``nvcc`` runs per source, all started together, then one link.
A failed build raises with nvcc's stderr: there is no fallback.

The library is loaded with ``ctypes``; each kernel module declares the
``argtypes`` of the functions it calls (every pointer and the stream as
``c_void_p``). ``utils.compile_cache`` counts a library found in its
build directory as a hit and one built as a miss.

``kernel_off`` reads a kernel's environment switch
(``PHOTON_SERVE_KERNEL``, ``PHOTON_NEWTON_KERNEL``,
``PHOTON_SEGMENT_KERNEL``) with the JAX package's spellings.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kernels"
LIB_NAME = "libphoton_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None
_logged_switches: set = set()
log = logging.getLogger(__name__)


def kernel_off(name: str) -> bool:
    """Whether the environment switch ``name`` turns its kernel off:
    ``off``/``0``/``false`` do, and then a CUDA tensor takes the plain
    PyTorch version; ``force``/``on``/``1``, anything else and unset
    leave the hand-written kernel on CUDA tensors. On the CPU every value
    runs the plain version (there is no kernel to force). Each choice is
    logged once per process."""
    off = os.environ.get(name, "auto").strip().lower() in ("0", "off",
                                                           "false")
    if (name, off) not in _logged_switches:
        _logged_switches.add((name, off))
        log.info("%s: %s", name,
                 "plain PyTorch version" if off
                 else "hand-written kernel on CUDA tensors")
    return off


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA "
        "kernels of photon_tpu_torch cannot be built on this machine"
    )


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the first failure's
    stderr after every process has ended."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for c in cmds
    ]
    failures = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(
                f"$ {' '.join(cmd)}\n(exit {proc.returncode})\n{out}{err}"
            )
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def build() -> Path:
    """Compile the library if this source hash has none yet; return
    its path."""
    global build_seconds
    target = BUILD_ROOT / source_hash() / LIB_NAME
    if target.is_file():
        return target
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
            for s, o in zip(srcs, objs)
        ])
        lib = Path(tmp) / LIB_NAME
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                   *map(str, objs)]])
        target.parent.mkdir(parents=True, exist_ok=True)
        os.replace(lib, target)
    build_seconds = time.perf_counter() - t0
    return target


def loaded_library() -> str | None:
    """The path of the loaded kernel library, or None before a kernel
    was first needed; never builds or loads."""
    lib = _lib
    return None if lib is None else lib._name


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            from photon_tpu_torch.utils import compile_cache

            built = not (BUILD_ROOT / source_hash() / LIB_NAME).is_file()
            path = build()
            _lib = ctypes.CDLL(str(path))
            compile_cache.note_library(str(path), built=built)
        return _lib
