#!/usr/bin/env python3
"""Builds of the per-problem ADMM kernel's source side by side on its
streaming route (matrices read from device memory every iteration), on one
CUDA GPU.

    python3 streaming_variants.py NAME=PATH [NAME=PATH ...]

Each PATH is a version of ``csrc/admm_problem.cu``; it is built into a
library of its own with the checkout's other sources (one ``nvcc`` per
source, every build started together), and each library is loaded in turn
into this process, so every build runs on the same inputs:

  - the output-feedback MPC's QPs at (262, 262), the first OF_KERNEL_STEPS
    steps of chip_smoke.py's output-feedback loop (run once on the
    checkout's own build), batched: 20 iterations from the cold start and
    the path's warm solve (4000 iterations, every member runs to max_iter)
    with every tolerance 0.  Per vector, the largest distance from the
    float64 plain run beside the float32 plain version's, |kernel - plain|
    against chip_smoke's fixed-iteration bound (1e-4 x scale + 2 x the
    float32 plain version's distance from float64), and the distances
    relative to each member's scale; the kernel's worst of those against
    chip_smoke's float64 rule (OF_F64_FACTOR x the plain version's worst +
    OF_F64_FLOOR);
  - problem_family at (147, 294), B = 64, with the OCP sweep's inner
    settings: statuses and iteration counts equal to the float64 run's,
    beside the float32 plain version's;
  - times (means of back-to-back calls, builds interleaved, twice in
    opposite orders) of the MPC's warm solve at B = 1, 1200 fixed
    iterations of problem_family at (133, 266), B = 64, and the (147, 294)
    solve, each beside chip_smoke's bound;
  - the registers and spills ptxas reports for the streaming route's
    instantiation;
  - chip_smoke's checks of the route (the output-feedback kernel phase and
    the ocp-qp phase) on the inputs each build's own closed loop gives, as
    the smoke would run them with that build.

Run from the repository root.  Builds go to build/variants/ (gitignored).
"""

import ctypes
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "variants"


def build_all(specs):
    """Compile every build's sources at once, then link each.  Returns
    ``{name: (library path, ptxas lines of the streaming route)}``."""
    from smooth_feedback_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    others = [s for s in _build._sources() if s.name != "admm_problem.cu"]
    nvcc, jobs = _build._nvcc(), []
    for name, src in specs:
        for s in [Path(src), *others]:
            cmd = [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(OUT / f"{name}_{s.stem}.o"), str(s)]
            jobs.append((name, s == Path(src), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = {}
    for name, variant, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on a source of {name}:\n{text}")
        if variant:
            logs[name] = text
    built = {}
    for name, src in specs:
        lib = OUT / f"lib_{name}.so"
        objs = [OUT / f"{name}_{s.stem}.o" for s in [Path(src), *others]]
        subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)], check=True)
        built[name] = (lib, streaming_ptxas(logs[name]))
    return built


def streaming_ptxas(log):
    """ptxas's lines for admm_problem_kernel<0> (the streaming route)."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "admm_problem_kernelILi0E" in line
        elif keep and ("registers" in line or "spill" in line):
            lines.append(line.split("info    :")[-1].strip())
    return "; ".join(lines)


def use(lib):
    from smooth_feedback_tpu_torch import _build

    _build._lib = _build._declare(ctypes.CDLL(str(lib)))


def loop(cs, p):
    """The first OF_KERNEL_STEPS steps of chip_smoke's output-feedback loop
    (its noise for OF_STEPS steps) on the build in use, kept as
    chip_smoke.output_feedback_phase keeps them."""
    x, est = cs.output_feedback_start(p)
    nm, nw = cs.output_feedback_noise(cs.OF_STEPS, p["kw"])
    mws, aws, kept = p["mws"], p["aws"], []
    for i in range(cs.OF_KERNEL_STEPS):
        x1, est1, est_upd, m, a = cs.output_feedback_step(p, i, x, est, mws, aws, nm[i], nw[i])
        kept.append((i, x, est, mws, aws, est_upd, m, a))
        x, est, mws, aws = x1, est1, m.warmstart, a.warmstart
    return kept


def mpc_inputs(cs, p, kept):
    """The MPC's QPs of the kept steps and their warm starts, as
    chip_smoke.output_feedback_kernel_phase builds them: ``(cold args,
    warm args, prm)``."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.qp import QPSolution, per_problem_kernel_args

    ts = torch.tensor([cs.OF_DT * k[0] for k in kept], **p["kw"])
    mq = vmap(p["mpc"].transcribe)(ts, torch.stack([k[5].g for k in kept]))
    ws = QPSolution(*(torch.stack(a) for a in zip(*(k[3] for k in kept))))
    prm = p["aprm"].qp
    return (per_problem_kernel_args(mq, None, None, prm),
            per_problem_kernel_args(mq, None, ws, prm), prm)


def smoke_checks(cs, p, dev, name):
    """chip_smoke's checks of the streaming route on the build in use, on the
    inputs that build's own closed loop gives (as the smoke would run it):
    the output-feedback kernel phase and the ocp-qp phase."""
    for what, run in (("output-feedback kernel", lambda: cs.output_feedback_kernel_phase(
                           p, loop(cs, p), dev)),
                      ("ocp-qp", lambda: cs.ocp_qp_phase(dev))):
        try:
            run()
            print(f"[checks] {name}: {what} passed", flush=True)
        except SystemExit as e:
            print(f"[checks] {name}: {what} {e}", flush=True)


def fixed(prm, iters):
    return dataclasses.replace(prm, eps_abs=0.0, eps_rel=0.0, eps_primal_inf=0.0,
                               eps_dual_inf=0.0, max_iter=iters)


def distances(cs, k, r, d):
    """Per vector: max |kernel - f64|, max |plain - f64|, max |kernel -
    plain| against chip_smoke's fixed-iteration bound, and the largest
    distances from f64 relative to each member's scale; then the kernel's
    worst of those against chip_smoke's float64 rule for the solve that runs
    to max_iter (``f64_distance_check``)."""
    rows = []
    rel_k, rel_r = cs.f64_distances(k, d), cs.f64_distances(r, d)
    for name, kt, rt, dt, rk, rr in zip("xzy", k[:3], r[:3], d[:3], rel_k, rel_r):
        kd = float((kt.double() - dt).abs().max())
        rd = float((rt.double() - dt).abs().max())
        kr = float((kt - rt).abs().max())
        scale = max(1.0, float(dt.abs().max()))
        bnd = cs.ITER_TOL * scale + 2 * rd
        rows.append(f"{name}: kernel-f64 {kd:.4e}, plain-f64 {rd:.4e}, kernel-plain {kr:.4e} "
                    f"(fixed-iteration bound {bnd:.4e}: {'ok' if kr <= bnd else 'FAILS'}); "
                    f"relative kernel-f64 {rk:.4e}, plain-f64 {rr:.4e}")
    rel_b = cs.f64_bound(rel_r)
    rows.append(f"float64 rule: the kernel's worst {max(rel_k):.4e} against {rel_b:.4e} "
                f"({'ok' if max(rel_k) <= rel_b else 'FAILS'})")
    return "; ".join(rows)


def main():
    import chip_smoke as cs
    from smooth_feedback_tpu_torch import _build
    from smooth_feedback_tpu_torch.convert import qp_from_numpy
    from smooth_feedback_tpu_torch.qp import (
        admm_iterate_cuda, admm_iterate_reference, per_problem_kernel_args,
    )

    specs = [a.split("=", 1) for a in sys.argv[1:]]
    if not specs or not all(len(s) == 2 and Path(s[1]).is_file() for s in specs):
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    built = build_all(specs)
    for name, (_, regs) in built.items():
        print(f"[build] {name}: streaming route {regs}", flush=True)

    _build.load()  # the checkout's own build runs the loop that makes the shared inputs
    p = cs.output_feedback_path(dev)
    cold, warm, prm = mpc_inputs(cs, p, loop(cs, p))
    one = tuple(a[-1:].contiguous() if a.dim() and a.shape[0] == cs.OF_KERNEL_STEPS else a
                for a in warm)
    ref = {}
    for label, args, iters in (("cold, 20 iterations", cold, 20),
                               (f"warm, {prm.max_iter} iterations", warm, prm.max_iter)):
        ref[label] = (admm_iterate_reference(fixed(prm, iters), *args),
                      admm_iterate_reference(fixed(prm, iters), *cs.f64(args)))
    sprm = cs.ocp_sweep_params("cuda").qp
    fam = per_problem_kernel_args(qp_from_numpy(cs.problem_family(147, 294, 64, 5), device=dev),
                                  prm=sprm)
    fr, fd = admm_iterate_reference(sprm, *fam), admm_iterate_reference(sprm, *cs.f64(fam))
    t_prm = fixed(sprm, 1200)
    tfam = per_problem_kernel_args(qp_from_numpy(cs.problem_family(133, 266, 64, 7), device=dev),
                                   prm=t_prm)
    torch.cuda.synchronize()
    n_r = (int((fr[3] == fd[3]).sum()), int((fr[4] == fd[4]).sum()))

    for name, (lib, _) in built.items():
        use(lib)
        for label, args, iters in (("cold, 20 iterations", cold, 20),
                                   (f"warm, {prm.max_iter} iterations", warm, prm.max_iter)):
            k = admm_iterate_cuda(fixed(prm, iters), *args)
            torch.cuda.synchronize()
            print(f"[mpc] {name} (262, 262) x {cs.OF_KERNEL_STEPS}, {label}: "
                  + distances(cs, k, *ref[label]), flush=True)
        smoke_checks(cs, p, dev, name)
        k = admm_iterate_cuda(sprm, *fam)
        torch.cuda.synchronize()
        print(f"[family] {name} (147, 294) B=64: statuses equal to f64's in "
              f"{int((k[3] == fd[3]).sum())} (plain {n_r[0]}), counts in "
              f"{int((k[4] == fd[4]).sum())} (plain {n_r[1]}), mean iterations "
              f"{float(k[4].float().mean()):.1f} (f64 {float(fd[4].float().mean()):.1f})",
              flush=True)

    cases = (("MPC (262, 262) B=1 warm", prm, one), ("(133, 266) B=64 1200 fixed", t_prm, tfam),
             ("(147, 294) B=64 solve", sprm, fam))
    names = list(built)
    for rnd, order in enumerate((names, names[::-1])):
        for label, p, args in cases:
            row = []
            for name in order:
                use(built[name][0])
                ms = cs.time_ms(lambda: admm_iterate_cuda(p, *args), 5)
                k = admm_iterate_cuda(p, *args)
                row.append(f"{name} {ms:.4f} ms ({float(k[4].float().mean()):.1f} iterations)")
            use(built[names[0]][0])
            bms, by = cs.bound(args, admm_iterate_cuda(p, *args), p)
            print(f"[time] round {rnd + 1}, {label}: " + ", ".join(row)
                  + f"; bound {bms:.6f} ms ({by})", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
