#!/usr/bin/env python3
"""Where an iteration of the shared kernel's cluster route spends its time,
on one CUDA GPU.

    python3 cluster_phase_split.py [PATH]

Writes a copy of ``csrc/admm_shared_cluster.cu`` (or PATH, a version of it)
with clock64 probes between the phases of a group's iteration into
build/variants/ (gitignored), builds it through shared_stream_variants.py
and runs 20 fixed iterations (every tolerance 0; two checks) of
tests/test_torch_cuda.py's seeded shared family at bench.py --sweep's
shapes past the resident route, (158, 158) at B = 8192, (200, 200) at 2048,
(302, 302) at 4096 and (602, 602) at 2048, each in the cluster kernel's own
plan.  For each shape: the time of the launch (mean of 3 back-to-back calls,
the probes in) and, as seen by thread 0 of block 0, the share of its cycles
in each phase: the matrix copy (prologue), taking a group, the commit and
loop control, rho z - y, the partial product (rho z - y) As and its
barrier, the rhs from the ranks' partials and its barrier, the gather of
the rhs, xt = rhs Minv, the barrier and gather of xt, zt = xt As', and the
check (with the wait for the other threads' share of zt).  A phase that ends
at a barrier includes the wait for the slowest thread.  Each probe costs
tens of cycles, so the split is a guide to where the time goes, not a
timing.  Run from the repository root.
"""

import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "smooth_feedback_tpu_torch" / "csrc" / "admm_shared_cluster.cu"
SHAPES = ((158, 8192), (200, 2048), (302, 4096), (602, 2048))
PHASES = ("prologue", "take a group", "commit and loop", "rho z - y", "(rho z - y) As",
          "barrier A", "rhs", "barrier B", "gather rhs", "rhs Minv", "barrier C and gather xt",
          "xt As'", "check and wait")

# (anchor in the source, probe before or after it, phase the probe closes)
PROBES = (
    ("  copy_wait();\n  __syncthreads();\n", "after", 0),
    ("    if (grp >= a.groups) break;\n", "after", 1),
    ("      if (!any_run) break;\n", "after", 2),
    ("      // U = the block", "before", 3),
    ("      cluster.sync();\n      // rhs = sigma x - qs", "before", 4),
    ("      // rhs = sigma x - qs", "before", 5),
    ("      cluster.sync();\n      gather<G>(cluster, U, XE, Wn, n, C);", "before", 6),
    ("      gather<G>(cluster, U, XE, Wn, n, C);", "before", 7),
    ("      // xt = rhs Minv on the block's columns", "before", 8),
    ("      cluster.sync();\n      gather<G>(cluster, U, XT, Wn, n, C);", "before", 9),
    ("      // zt = xt As' on the block's rows", "before", 10),
    ("      const bool check = it % sci == check_phase;", "before", 11),
    ("      // commit the members still running", "before", 12),
)


def probed(src):
    """The source with the probes in, and an export that copies block 0's
    and block 1's phase cycles out."""
    def put(at, text, where):
        nonlocal src
        if src.count(at) != 1:
            raise SystemExit(f"anchor not found once in the source: {at!r}")
        src = src.replace(at, at + text if where == "after" else text + at)

    put("template <int G>\n__global__ void __launch_bounds__",
        "__device__ unsigned long long g_phase[2][16];\n", "before")
    put("  const int sci = a.stop_check_iter, check_phase = 1 % sci;\n",
        "  long long phase[16] = {};\n  long long last = clock64();\n", "after")
    for at, where, k in PROBES:
        put(at, f"  if (t == 0) {{ const long long c_ = clock64(); phase[{k}] += c_ - last; "
                f"last = c_; }}\n", where)
    put("  }\n}\n\n// out (cols, rows) = in",
        "  if (t == 0 && blockIdx.x < 2)\n"
        "    for (int k = 0; k < 16; ++k) g_phase[blockIdx.x][k] = phase[k];\n", "before")
    return src + ('\nextern "C" int phase_read(unsigned long long* host) {\n'
                  "  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));\n}\n")


def main(argv):
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import shared_stream_variants as variants
    from chip_smoke import time_ms
    from smooth_feedback_tpu_torch.qp import QPSolverParams
    from test_torch_cuda import _inputs

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    source = Path(argv[0]) if argv else SOURCE
    variants.OUT.mkdir(parents=True, exist_ok=True)
    copy = variants.OUT / "cluster_phases.cu"
    copy.write_text(probed(source.read_text()))
    lib, cluster = variants.build_all([("phases", str(copy))])["phases"]
    lib.phase_read.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    prm = QPSolverParams(polish=False, rho=2.0, rho_eq_scale=15.0, max_iter=20,
                         stop_check_iter=10, eps_abs=0.0, eps_rel=0.0, eps_primal_inf=0.0,
                         eps_dual_inf=0.0)
    for n, B in SHAPES:
        args = _inputs(n, n, B, seed=1, dev=dev)
        ms = time_ms(lambda: variants.launch(lib, cluster, prm, args), 3)
        variants.launch(lib, cluster, prm, args)
        torch.cuda.synchronize()
        host = (ctypes.c_ulonglong * 32)()
        lib.phase_read(host)
        cycles = list(host)[:len(PHASES)]
        total = max(1, sum(cycles))
        print(f"({n}, {n}) B={B}, {variants.layout(lib, cluster, B, n)}: {ms:.3f} ms (probes in); "
              f"block 0, {total} cycles: " + ", ".join(
                  f"{name} {100 * c / total:.1f}%" for name, c in zip(PHASES, cycles)),
              flush=True)
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main(sys.argv[1:])
