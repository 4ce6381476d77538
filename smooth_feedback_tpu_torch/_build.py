"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled with ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and the objects are
linked into one shared library with a plain C interface, which is then loaded
with ``ctypes``.  The build runs once, at first use, into ``build/kernels/`` at
the repository root (listed in ``.gitignore``); the library's file name
carries a hash of the sources and flags, so an edited source builds anew.  Importing
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    for name in ("admm_shared_launch", "admm_problem_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 23 + [i, i, i, i] + [f] * 6 + [i, i, p]
        fn.restype = ctypes.c_int
    lib.admm_shared_stream_launch.argtypes = [p] * 24 + [i, i, i] + [f] * 6 + [i, i, p]
    lib.admm_shared_stream_launch.restype = ctypes.c_int
    lib.admm_shared_cluster_launch.argtypes = [p] * 24 + [i, i, i] + [f] * 6 + [i, i, p]
    lib.admm_shared_cluster_launch.restype = ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.admm_shared_plan.argtypes = [i, i, i, i, ip]
    lib.admm_shared_plan.restype = ctypes.c_int
    lib.admm_shared_stream_plan.argtypes = [i, i, i, ip]
    lib.admm_shared_stream_plan.restype = ctypes.c_int
    lib.admm_shared_stream_scratch.argtypes = [i, i, i]
    lib.admm_shared_stream_scratch.restype = ctypes.c_longlong
    lib.admm_shared_cluster_plan.argtypes = [i, i, i, ip]
    lib.admm_shared_cluster_plan.restype = ctypes.c_int
    lib.admm_shared_cluster_scratch.argtypes = [i, i, i]
    lib.admm_shared_cluster_scratch.restype = ctypes.c_longlong
    lib.admm_problem_route.argtypes = [i, i, i, ip]
    lib.admm_problem_route.restype = ctypes.c_int
    ll = ctypes.c_longlong
    lib.admm_lane_launch.argtypes = [p] * 32 + [ll] * 7 + [i] * 5 + [f] * 9 + [i] * 6 + [p]
    lib.admm_lane_launch.restype = ctypes.c_int
    lib.admm_lane_plan.argtypes = [i, i, i, ip]
    lib.admm_lane_plan.restype = ctypes.c_int
    return lib


def _compile(nvcc: str, out: Path):
    """Compile every source to an object (in parallel) and link ``out``."""
    objs, procs = [], []
    for src in _sources():
        obj = out.with_name(f"{out.stem}_{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((src.name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
        objs.append(obj)
    logs, failed = [], []
    for name, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {name}\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    try:
        if failed:
            return "".join(logs), f"nvcc failed on {', '.join(failed)}"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(out), *map(str, objs)], capture_output=True, text=True
        )
        logs.append(link.stdout + link.stderr)
        return "".join(logs), None if link.returncode == 0 else "nvcc link failed"
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


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
            build_log, error = _compile(_nvcc(), Path(tmp))
            if error is not None:
                os.unlink(tmp)
                raise RuntimeError(f"{error}:\n{build_log}")
            os.replace(tmp, path)  # atomic: concurrent builds agree
            build_seconds = time.perf_counter() - t0
        _lib = _declare(ctypes.CDLL(str(path)))
        return _lib
