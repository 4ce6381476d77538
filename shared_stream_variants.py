#!/usr/bin/env python3
"""Builds of the shared kernel's cluster and streaming routes side by side,
on one CUDA GPU.

    python3 shared_stream_variants.py NAME=PATH [NAME=PATH ...]

Each PATH is a version of ``csrc/admm_shared_cluster.cu`` or of
``csrc/admm_shared_stream.cu`` (the file alone carries its C interface; which
route it is comes from its exports); each is compiled into a library of its
own (one ``nvcc`` per build, all started together) and loaded into this
process, so every build runs on the same inputs: tests/test_torch_cuda.py's
seeded shared family at bench.py --sweep's shapes past the resident route
and fleet sizes, (158, 158) at B = 8192, (200, 200) at 2048, (302, 302) at
4096 and (602, 602) at 2048, each cluster build in its own plan.  An older
version comes from git, e.g. ``git show
HEAD~:smooth_feedback_tpu_torch/csrc/admm_shared_stream.cu >
build/parent_stream.cu``.  For each shape and build: the time (mean of 3
back-to-back calls) of 20 fixed iterations (every tolerance 0; two checks)
and of the same without checks, the time of a solve from a cold start
(max_iter 200, as bench.py's sweep above K = 50; mean of 3 back-to-back
calls and median of 3 single launches) with its mean and largest iteration
count, and the largest distance of the fixed iterations' iterates from
the float64 plain run.  ptxas's registers and spills are printed per
instantiation.  Run from the repository root; builds go to build/variants/
(gitignored).
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "variants"
SHAPES = ((158, 8192), (200, 2048), (302, 4096), (602, 2048))


def build_all(specs):
    """Compile every build at once; returns ``{name: (ctypes library, True
    for a cluster build)}``."""
    from smooth_feedback_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, src in specs:
        so = OUT / f"shared_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), src]
        jobs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    libs = {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        kernel = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line.strip()
            if "registers" in line or "spill" in line:
                print(f"[{name}] {kernel[:60]}: {line.strip()}")
        lib = ctypes.CDLL(str(so))
        cluster = hasattr(lib, "admm_shared_cluster_launch")
        if cluster:
            lib.admm_shared_cluster_launch.argtypes = [p] * 24 + [i, i, i] + [f] * 6 + [i, i, p]
            lib.admm_shared_cluster_launch.restype = ctypes.c_int
            lib.admm_shared_cluster_plan.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
            lib.admm_shared_cluster_plan.restype = ctypes.c_int
        else:
            lib.admm_shared_stream_launch.argtypes = [p] * 24 + [i, i, i] + [f] * 6 + [i, i, p]
            lib.admm_shared_stream_launch.restype = ctypes.c_int
        libs[name] = (lib, cluster)
    return libs


def launch(lib, cluster, prm, args):
    """One launch of ``lib``'s route on the kernel's arguments (``cluster``:
    whether it is a cluster build)."""
    from smooth_feedback_tpu_torch.qp import cuda_kernel as ck

    Minv, As, Ps, qs, ls, us, rho, sx, sy, c, l, u, x0, z0, y0, status0 = args
    B, n = qs.shape
    m = ls.shape[1]
    f32 = dict(dtype=torch.float32, device=qs.device)
    i32 = dict(dtype=torch.int32, device=qs.device)
    outs = (torch.empty((B, n), **f32), torch.empty((B, m), **f32), torch.empty((B, m), **f32),
            torch.empty((B,), **i32), torch.empty((B,), **i32), torch.empty((B,), **f32),
            torch.empty((B,), **f32))
    ptrs = [t.data_ptr() for t in (Minv, As, Ps, rho, sx, sy, c, qs, ls, us, l, u, x0, z0, y0,
                                   status0, *outs)]
    tail = (prm.alpha, prm.sigma, prm.eps_abs, prm.eps_rel, prm.eps_primal_inf,
            prm.eps_dual_inf, prm.max_iter, prm.stop_check_iter,
            torch.cuda.current_stream().cuda_stream)
    if cluster:
        scratch = torch.empty(ck.shared_cluster_scratch(B, n, m), **f32)
        err = lib.admm_shared_cluster_launch(*ptrs, scratch.data_ptr(), B, n, m, *tail)
    else:
        scratch = torch.empty(ck.shared_stream_scratch(B, n, m), **f32)
        err = lib.admm_shared_stream_launch(*ptrs, scratch.data_ptr(), B, n, m, *tail)
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return outs


def layout(lib, cluster, B, n):
    """The cluster build's plan at (n, n) for B problems, as text."""
    if not cluster:
        return "streaming"
    out = (ctypes.c_int * 5)()
    err = lib.admm_shared_cluster_plan(B, n, n, out)
    return f"refused ({err})" if err else f"C={out[0]} G={out[1]} x{out[4]}"


def main(argv):
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from chip_smoke import time_ms, time_single_ms
    from smooth_feedback_tpu_torch.qp import QPSolverParams, admm_iterate_reference
    from test_torch_cuda import _inputs

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    specs = [a.split("=", 1) for a in argv]
    libs = build_all(specs)
    dev = torch.device("cuda", 0)
    zero = dict(eps_abs=0.0, eps_rel=0.0, eps_primal_inf=0.0, eps_dual_inf=0.0)
    kw = dict(polish=False, rho=2.0, rho_eq_scale=15.0)
    fixed = QPSolverParams(max_iter=20, stop_check_iter=10, **zero, **kw)
    nocheck = QPSolverParams(max_iter=20, stop_check_iter=1000, **zero, **kw)
    solve = QPSolverParams(max_iter=200, stop_check_iter=10, **kw)
    for n, B in SHAPES:
        args = _inputs(n, n, B, seed=1, dev=dev)
        d = admm_iterate_reference(fixed, *(a.double() if a.is_floating_point() else a
                                            for a in args))
        rows = []
        for name, (lib, cluster) in libs.items():
            plan = layout(lib, cluster, B, n)
            if plan.startswith("refused"):
                rows.append(f"{name}: {plan}")
                continue
            k = launch(lib, cluster, fixed, args)
            dist = max(float((a.double() - b).abs().max()) for a, b in zip(k[:3], d[:3]))
            ks = launch(lib, cluster, solve, args)
            rows.append(
                f"{name} ({plan}): 20 iterations "
                f"{time_ms(lambda: launch(lib, cluster, fixed, args), 3):.3f} ms, without checks "
                f"{time_ms(lambda: launch(lib, cluster, nocheck, args), 3):.3f} ms, solve "
                f"{time_ms(lambda: launch(lib, cluster, solve, args), 3):.3f} ms [single "
                f"{time_single_ms(lambda: launch(lib, cluster, solve, args), 3):.3f}] (iters mean "
                f"{float(ks[4].float().mean()):.2f} max {int(ks[4].max())}), max |x, z, y - f64| "
                f"{dist:.3e}")
        print(f"({n}, {n}) B={B}: " + "; ".join(rows), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main(sys.argv[1:])
