"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled with ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, which is then loaded with
``ctypes``.  The build runs once, at first use, into ``build/kernels/`` at the
repository root (listed in ``.gitignore``); the library's file name carries a
hash of the sources and flags, so an edited source builds anew.  Importing
this module builds nothing.  A failed build or load raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the last build in this process (ptxas report)
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libsf_kernels_{h.hexdigest()[:16]}.so"


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.admm_shared_launch.argtypes = [p] * 23 + [i, i, i, i] + [f] * 6 + [i, i, p]
    lib.admm_shared_launch.restype = ctypes.c_int
    return lib


def load():
    """The kernels' library, building it first if needed."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
            os.replace(tmp, path)  # atomic: concurrent builds agree
            build_seconds = time.perf_counter() - t0
        _lib = _declare(ctypes.CDLL(str(path)))
        return _lib
