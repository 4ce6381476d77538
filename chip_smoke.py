#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

Drives the port's two paths, each through its hand-written ADMM kernel:

- the condensed double-integrator MPC fleet (K=50 horizon, n = m = 52 QP,
  B = 8192 controllers on one clock, float32, the bench.py configuration)
  through the shared-matrix kernel (csrc/admm_shared.cu);
- the README Quickstart's SE(2) vehicle fleet on per-member clocks (K=30,
  n = 163, m = 99 sparse QP, B = 1024, float32, every member transcribed and
  factorized on its own) through the per-problem kernel
  (csrc/admm_problem.cu).

Phases:

  1. device: refuses to run without a CUDA device; prints the card's name and
     power limit;
  2. build: compiles the CUDA sources with nvcc for sm_90a, one nvcc per
     source, in parallel;
  3. each kernel against its plain PyTorch version at its path's shapes: 20
     fixed iterations (iterates and returned residuals), one cold and one
     warm-started solve, every point the kernel calls Optimal re-checked in
     float64, both times, each as the mean of back-to-back calls and as the
     median of single launches (the shared
     kernel's also at B = 1024 and, cold, with the members sorted by their
     iteration counts); the layout each launch takes at its path's shape,
     where the per-problem kernel must keep Minv and As resident in shared
     memory; the per-problem kernel also on a numpy family whose members
     fire every certificate;
  4. each path: closed-loop fleet steps with every launch count set to 0
     just before and read just after, step time, the Optimal share, and the
     first steps again on the plain path;
  5. a JSON line of the kernels (with each one's bound on this card), the
     card's name and power limit, then the result line.

Run from the repository root:  python3 chip_smoke.py
Any failed phase exits non-zero.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

B = 8192
K = 50
DT = 0.05
STEPS = 200
SEED = 0

# the per-member-clock SE(2) vehicle fleet
FLEET_B = 1024
FLEET_K = 30  # benchmarks/asif_bench.py:73
FLEET_STEPS = 50
FLEET_PLAIN_STEPS = 3
TWIST = (0.5, 0.0, 0.3)

# the SE(2) x R^3 vehicle MPC + ASIF fleet (benchmarks/asif_bench.py:39-123)
ASIF_B = 256  # the bench's default fleet
ASIF_MPC_K = 30
ASIF_DT = 0.025
ASIF_WARM = 40
ASIF_STEPS = 40
ASIF_PLAIN_STEPS = 5
ASIF_T = 2.5

KERNELS = {
    "admm_shared": ("smooth_feedback_tpu_torch/csrc/admm_shared.cu",
                    "smooth_feedback_tpu/qp/pallas_kernel.py:234"),
    "admm_problem": ("smooth_feedback_tpu_torch/csrc/admm_problem.cu",
                     "smooth_feedback_tpu/qp/pallas_kernel.py:47"),
}
# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 rate outside the tensor
# cores (both kernels run IEEE f32 FMAs)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def require(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device (this script runs only on a GPU)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    phase("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}")
    return card


def build_phase():
    from smooth_feedback_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    phase("build", f"built and loaded in {time.perf_counter() - t0:.3f} s "
                   f"(nvcc {_build.build_seconds:.3f} s)")
    # ptxas's report, one line a kernel: its template arguments (admm_problem:
    # 32-column tiles a warp covers, 0 streams; admm_shared: entries a lane,
    # problems a warp), registers and spills
    name = "?"
    for line in _build.build_log.splitlines():
        found = re.search(r"\d(admm_[a-z]+_kernel)I((?:Li\d+E)+)", line)
        if found:
            name = found.group(1) + "<" + ", ".join(re.findall(r"Li(\d+)E", found.group(2))) + ">"
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            phase("build", f"{name}: {line.split(':', 1)[1].strip()}; {spills}")


def layout_phase():
    """The layout each launch takes at its path's shape, asked of the built
    library and held against the Python mirrors; the per-problem kernel must
    run resident at (163, 99)."""
    import ctypes

    from smooth_feedback_tpu_torch import _build
    from smooth_feedback_tpu_torch.qp import cuda_kernel as ck

    lib = _build.load()
    block = qp_params("cuda").kernel_block
    for b in (B, 1024):
        out = (ctypes.c_int * 4)()
        require(lib.admm_shared_plan(b, 52, 52, block, out) == 0,
                "admm_shared_plan refused the path's shape")
        phase("layout", f"admm_shared at B={b}, n=m=52, kernel_block={block}: {out[0]} problems a "
                        f"warp, {out[1]} problems and {out[2]} warps a block, {out[3]} bytes of "
                        f"shared memory a block")
        require(tuple(out) == ck.shared_plan(b, 52, 52, block),
                "shared_plan does not mirror the library")
    smem = ctypes.c_int(0)
    resident = lib.admm_problem_route(163, 99, ck.PROBLEM_WARPS, ctypes.byref(smem))
    route = "resident" if resident else "streaming"
    phase("layout", f"admm_problem at n=163, m=99: {route} route, {ck.PROBLEM_WARPS} warps and "
                    f"{smem.value} bytes of shared memory a block")
    require((route, smem.value) == ck.problem_route(163, 99),
            "problem_route does not mirror the library")
    require(resident == 1, "the per-problem kernel does not keep Minv and As resident at (163, 99)")
    streamed = lib.admm_problem_route(600, 600, ck.PROBLEM_WARPS, ctypes.byref(smem))
    require(streamed == 0 and ck.problem_route(600, 600)[0] == "streaming",
            "n = m = 600 is not streamed")


def make_main_path(backend, dev):
    """bench.py's configuration, rewritten in torch."""
    from smooth_feedback_tpu_torch.controllers import MPCParams, MPCWeights, make_mpc_step
    from smooth_feedback_tpu_torch.groups import Rn

    dt = torch.float32
    kw = dict(dtype=dt, device=dev)
    return make_mpc_step(
        Rn(2), Rn(1),
        lambda x, u: torch.stack([x[1], u[0]]),
        lambda t: torch.stack([-0.5 * torch.sin(0.3 * t), -0.15 * torch.cos(0.3 * t)]),
        lambda t: torch.zeros(1, **kw),
        weights=MPCWeights(Q=torch.eye(2, **kw), Qtf=0.1 * torch.eye(2, **kw),
                           R=0.1 * torch.eye(1, **kw)),
        params=MPCParams(
            K=K, tf=5.0, return_trajectories=False,
            qp=qp_params(backend),
        ),
        cr=lambda x, u: u, crl=[-0.5], cru=[0.5],
        dtype=dt, device=dev, reuse_factors=True, condense=True,
    )


def qp_params(backend):
    """bench.py's solver settings (bench.py:75-93) on a port backend."""
    from smooth_feedback_tpu_torch.qp import QPSolverParams

    return QPSolverParams(scaling=True, polish=False, rho=2.0, rho_eq_scale=15.0,
                          max_iter=100, stop_check_iter=10, backend=backend)


def initial_states(dev):
    xs = 0.5 * np.random.default_rng(SEED).standard_normal((B, 2))
    return torch.as_tensor(xs, dtype=torch.float32, device=dev)


def time_ms(fn, reps):
    """Mean device time of one call of ``fn`` in ms: one pair of events around
    ``reps`` back-to-back calls (after a warm-up).  Every time in the kernels
    line is taken this way.  Where the host needs longer to enqueue a call
    than the card to run it, this reads the host's pace: see
    :func:`time_single_ms`."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_single_ms(fn, reps):
    """Median device time of one call of ``fn`` in ms.  Each of ``reps``
    calls (after a warm-up) sits between its own pair of events, behind a
    spin kernel of about half a millisecond that keeps the card busy while
    the host enqueues the call: the events then bracket the call's device
    work alone, also when that is shorter than the host's own time to
    launch it."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # cycles
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
        torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in pairs]))


FIXED_ITERS = 20
# f32 kernel against f32 plain version, another summation order and FMA
# contraction: on a CPU the f32 plain version differs from its f64 run by
# 2e-5..7e-5 after 40 iterations of tests/test_torch_cuda.py's random 52x52
# family, and 20 iterations of the main path's better-scaled QPs stay below.
# is scaled by max(1, |v|_inf) of each vector.  On the sparse fleet path
# every row is an equality (rho = 100): each iteration adds 100 times the
# rounding of A x to y, and after 20 iterations the f32 plain version's y
# sits ~1e-3 from its f64 run (PERF.md).  So each vector may also
# differ by twice that measured floor: a kernel as close to the f64 run as
# the f32 plain version is lies within it.
ITER_TOL = 1e-4
PRIMAL_TOL = 1e-4
# The residuals a kernel returns (pres, dres of the last check) are f32
# max-norms of differences of products larger than themselves (A x - z;
# P x + q + A' y), so they carry those products' rounding: each may differ
# from the plain version's by 1e-3 + 1e-2 of its size, plus twice the f32
# plain version's own distance from its f64 run.
RES_ATOL, RES_RTOL = 1e-3, 1e-2


def f64(args):
    return tuple(a.double() if a.dtype == torch.float32 else a for a in args)


def wrappers():
    from smooth_feedback_tpu_torch.qp import admm_iterate_cuda, admm_iterate_cuda_shared

    return {"admm_shared": admm_iterate_cuda_shared, "admm_problem": admm_iterate_cuda}


def reset_counts():
    for w in wrappers().values():
        w.launches = 0


def read_counts():
    return {name: w.launches for name, w in wrappers().items()}


def n_checks(iters, k):
    """Stopping checks a member ran in ``iters`` iterations (it % k == 1 % k)."""
    first = 1 % k
    return torch.where(iters > first, torch.div(iters - 1 - first, k, rounding_mode="floor") + 1, 0)


def bound(args, out, prm):
    """The least time the card could take for one kernel call, in ms, and
    what sets it: every input read once and every output written once at the
    HBM rate, against the matrix-vector FMAs this call's members needed (3
    products an iteration, 6 more at each check) at the f32 rate."""
    n, m = args[1].shape[-1], args[1].shape[-2]
    moved = sum(a.numel() * a.element_size() for a in (*args, *out))
    iters = out[4].to(torch.int64)
    per_iter = 2 * (2 * m * n + n * n)
    per_check = 2 * (4 * m * n + 2 * n * n)
    flops = float((iters * per_iter + n_checks(iters, prm.stop_check_iter) * per_check).sum())
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def residual_slack(qps, args, out, prm):
    """Worst ratio, over the members the kernel calls Optimal, of each
    unscaled residual (re-evaluated in float64) to its stopping tolerance
    (plus 1e-4 for the kernel's own f32 evaluation).  ``qps`` holds P and A
    with a leading axis of 1 (shared) or B."""
    d = torch.float64
    sx, sy, c = (a.to(d) for a in args[7:10])
    c = c.reshape(-1, 1)
    q = qps.q.to(d)

    def mv(M, v):
        M = M.to(d)
        return v @ M[0].T if M.shape[0] == 1 else torch.einsum("bij,bj->bi", M, v)

    def mtv(M, v):
        M = M.to(d)
        return v @ M[0] if M.shape[0] == 1 else torch.einsum("bij,bi->bj", M, v)

    x = out[0].to(d) * sx
    z = out[1].to(d) / sy
    y = out[2].to(d) * sy / c
    Ax, Px, Aty = mv(qps.A, x), mv(qps.P, x), mtv(qps.A, y)
    ninf = lambda v: v.abs().amax(dim=1)
    pres = ninf(Ax - z)
    dres = ninf(Px + q + Aty)
    ptol = prm.eps_abs + prm.eps_rel * torch.maximum(ninf(Ax), ninf(z)) + 1e-4
    dtol = prm.eps_abs + prm.eps_rel * torch.maximum(ninf(Px), torch.maximum(ninf(q), ninf(Aty))) + 1e-4
    opt = out[3] == 0
    ratio = torch.maximum(pres / ptol, dres / dtol)[opt]
    return float(ratio.max()) if bool(opt.any()) else 0.0


def fixed_iteration_check(wrapper, args, qprm, start="cold inputs"):
    """All tolerances 0: no member can stop, so kernel and plain version run
    exactly FIXED_ITERS iterations and their iterates compare directly, each
    vector within ITER_TOL of its own scale plus twice the f32 plain
    version's distance from an f64 run (the rounding floor).  Returns the
    largest absolute difference."""
    from smooth_feedback_tpu_torch.qp import QPSolutionStatus, admm_iterate_reference

    MAX_ITER = int(QPSolutionStatus.MaxIterations)
    prm = dataclasses.replace(qprm, eps_abs=0.0, eps_rel=0.0, eps_primal_inf=0.0,
                              eps_dual_inf=0.0, max_iter=FIXED_ITERS)
    k = wrapper(prm, *args)
    r = admm_iterate_reference(prm, *args)
    d = admm_iterate_reference(prm, *f64(args))
    torch.cuda.synchronize()
    ran = bool((k[3] == MAX_ITER).all() and (r[3] == MAX_ITER).all()
               and (k[4] == FIXED_ITERS).all() and (r[4] == FIXED_ITERS).all())
    rows, worst, ok = [], 0.0, True
    for name, kt, rt, dt in zip("xzy", k[:3], r[:3], d[:3]):
        err = float((kt - rt).abs().max())
        floor = float((rt.double() - dt).abs().max())
        scale = max(1.0, float(dt.abs().max()))
        rows.append(f"{name} {err:.3e} (f32 plain - f64 {floor:.3e}, scale {scale:.3e})")
        worst = max(worst, err)
        ok = ok and err <= ITER_TOL * scale + 2 * floor
    phase("kernel", f"fixed {FIXED_ITERS} iterations, all tolerances 0, {start}: every "
                    f"member ran them in both: {ran}; max |kernel - plain| " + ", ".join(rows)
                    + f" (bound {ITER_TOL:g} x scale + 2 x floor)")
    require(ran, "with all tolerances 0 a member stopped before max_iter")
    require(ok, "fixed-iteration iterates differ beyond the bound")
    # the last check's residuals as returned, at the member where they differ most
    rows, res_ok = [], True
    for name, kt, rt, dt in zip(("pres", "dres"), k[5:], r[5:], d[5:]):
        diff = (kt - rt).abs()
        i = int(diff.argmax())
        floor = float((rt.double() - dt).abs().max())
        rows.append(f"{name} {float(diff[i]):.3e} at member {i} (kernel {float(kt[i]):.6e}, plain "
                    f"{float(rt[i]):.6e}; f32 plain - f64 {floor:.3e})")
        res_ok = res_ok and bool((diff <= RES_ATOL + RES_RTOL * rt.abs() + 2 * floor).all())
    phase("kernel", "the residuals of the last check, max |kernel - plain|: " + ", ".join(rows)
                    + f" (bound {RES_ATOL:g} + {RES_RTOL:g} x size + 2 x floor)")
    require(res_ok, "the returned residuals differ beyond the bound")
    return worst


def compare_with_plain(name, wrapper, prm, args, qps, min_optimal=None, exact_iters=False):
    """One solve through the kernel against the plain version in f32 and in
    f64 on the same inputs: statuses, iteration counts, the unscaled primal
    where the counts agree, and every point the kernel calls Optimal
    re-checked in f64.  Iteration counts must agree on 99.5 % of members,
    unless the f32 plain version itself splits from the f64 run more often:
    then the kernel must match the f64 run's counts at least as often as the
    f32 plain version does (within half a point).  ``min_optimal`` also
    requires that Optimal share from both versions alike; ``exact_iters``
    every count equal.  Returns the primal error where counts agree and the
    kernel's outputs."""
    from smooth_feedback_tpu_torch.qp import admm_iterate_reference

    k = wrapper(prm, *args)
    r = admm_iterate_reference(prm, *args)
    d = admm_iterate_reference(prm, *f64(args))
    torch.cuda.synchronize()
    share = lambda mask: float(mask.float().mean())
    agree = share(k[3] == r[3])
    k_opt, r_opt, d_opt = (share(o[3] == 0) for o in (k, r, d))
    eq_it = share(k[4] == r[4])
    eq_kd, eq_rd = share(k[4] == d[4]), share(r[4] == d[4])
    same_it = (k[3] == 0) & (r[3] == 0) & (k[4] == r[4])
    both = (k[3] == 0) & (r[3] == 0)
    # unscaled primal: what the controller applies
    dx = ((k[0] - r[0]) * args[7]).abs()
    err_same = float(dx[same_it].max()) if bool(same_it.any()) else float("inf")
    err_all = float(dx[both].max()) if bool(both.any()) else float("inf")
    slack = residual_slack(qps, args, k, prm)
    not_opt = lambda o: torch.nonzero(o[3] != 0).flatten().tolist()
    phase("kernel", f"{name}: status agreement {agree * 100:.3f}%, Optimal kernel "
                    f"{k_opt * 100:.3f}% plain {r_opt * 100:.3f}% plain-f64 "
                    f"{d_opt * 100:.3f}%, equal iters kernel/plain {eq_it * 100:.3f}% "
                    f"kernel/plain-f64 {eq_kd * 100:.3f}% plain/plain-f64 "
                    f"{eq_rd * 100:.3f}%, mean iters kernel "
                    f"{float(k[4].float().mean()):.2f} plain {float(r[4].float().mean()):.2f}, "
                    f"max |dprimal| equal-iters {err_same:.3e} all {err_all:.3e}, "
                    f"kernel's Optimal points re-checked in f64: worst residual / "
                    f"tolerance {slack:.4f}")
    phase("kernel", f"{name}: members not Optimal: kernel {not_opt(k)[:20]} plain "
                    f"{not_opt(r)[:20]} plain-f64 {not_opt(d)[:20]}")
    require(agree >= 0.999, f"{name}: kernel/plain status agreement {agree:.5f} < 0.999")
    if min_optimal is not None:
        require(k_opt == r_opt, f"{name}: kernel and plain Optimal shares differ")
        require(k_opt >= min_optimal, f"{name}: Optimal share {k_opt:.5f}")
    if exact_iters:
        require(eq_it == 1.0, f"{name}: equal iteration counts {eq_it:.5f}")
    else:
        require(eq_it >= 0.995 or (eq_rd < 0.995 and eq_kd >= eq_rd - 0.005),
                f"{name}: equal iteration counts kernel/plain {eq_it:.5f}, kernel/plain-f64 "
                f"{eq_kd:.5f}, plain/plain-f64 {eq_rd:.5f}")
    # Members with equal iteration counts ran the same iterations: only f32
    # rounding in another summation order separates them.  Members that
    # stopped at different checks are compared through their residuals
    # instead: re-evaluated in f64, every point the kernel calls Optimal
    # passes the stopping test (allowing 1e-4 for the f32 evaluation inside
    # the kernel).
    require(err_same <= PRIMAL_TOL, f"{name}: primal differs by {err_same:.3e} > {PRIMAL_TOL:g}")
    require(slack <= 1.0, f"{name}: an Optimal point fails the f64 residual test")
    return err_same, k


def kernel_phase(step, dev):
    """The shared-matrix kernel against the plain version on the condensed
    path's real inputs.  Returns the worst error, the warm solve's kernel and
    plain times and its bound."""
    from smooth_feedback_tpu_torch.qp import (
        admm_iterate_cuda_shared, admm_iterate_reference, shared_kernel_args, solve_qp_batch,
    )

    f = step.factors
    n, m = f.Minv.shape[0], f.As.shape[0]
    require((n, m) == (52, 52), f"main-path QP is {n}x{m}, expected 52x52")
    qprm = qp_params("cuda")
    xs = initial_states(dev)

    qps_cold = step.condensed_qp(0.0, xs)
    cold = shared_kernel_args(qps_cold, f)
    worst = fixed_iteration_check(admm_iterate_cuda_shared, cold, qprm)
    # warm start: the cold solution, one clock step later
    qps_warm = step.condensed_qp(DT, xs)
    warm = shared_kernel_args(qps_warm, f, solve_qp_batch(qps_cold, qprm, None, f))
    rows = {}
    for name, qps, args in (("cold", qps_cold, cold), ("warm", qps_warm, warm)):
        # a warm-started solve is the main path's regime: all Optimal, every
        # member at the same check.  From the cold start at std-0.5 states a
        # few members need more than max_iter = 100 iterations in either
        # version, and a member whose residual ends within f32 rounding of a
        # check's threshold may stop one check earlier or later.
        err, k = compare_with_plain(
            f"shared {name}", admm_iterate_cuda_shared, qprm, args, qps,
            min_optimal=1.0 if name == "warm" else 0.999, exact_iters=name == "warm",
        )
        worst = max(worst, err)
        rows[name] = (
            time_ms(lambda: admm_iterate_cuda_shared(qprm, *args), 20),
            time_ms(lambda: admm_iterate_reference(qprm, *args), 5),
            *bound(args, k, qprm),
        )
        single = time_single_ms(lambda: admm_iterate_cuda_shared(qprm, *args), 20)
        phase("kernel", f"shared {name}: kernel {rows[name][0]:.4f} ms, plain "
                        f"{rows[name][1]:.4f} ms per solve at B={B}, n=m={n} (means of "
                        f"back-to-back calls; median of single kernel launches {single:.4f} "
                        f"ms); bound {rows[name][2]:.4f} ms ({rows[name][3]})")
        # a small fleet (one problem a warp), the same members
        small = tuple(a[:1024].contiguous() if a.dim() and a.shape[0] == B else a for a in args)
        ks = admm_iterate_cuda_shared(qprm, *small)
        require(all(torch.equal(a, b[:1024]) for a, b in zip(ks, k)),
                f"shared {name}: a member's result depends on the batch around it")
        ms = time_ms(lambda: admm_iterate_cuda_shared(qprm, *small), 20)
        single = time_single_ms(lambda: admm_iterate_cuda_shared(qprm, *small), 20)
        bs, by = bound(small, ks, qprm)
        phase("kernel", f"shared {name} at B=1024: kernel {ms:.4f} ms back to back (no less "
                        f"than the host takes to enqueue a call), {single:.4f} ms median of "
                        f"single launches; bound {bs:.4f} ms ({by}), results equal the B={B} "
                        f"launch's")
        if name == "cold":
            # what sorting stragglers could gain at best: the members in the
            # order of the iteration counts this very solve gives them
            perm = torch.argsort(k[4], stable=True)
            srt = tuple(a[perm].contiguous() if a.dim() and a.shape[0] == B else a for a in args)
            ks = admm_iterate_cuda_shared(qprm, *srt)
            require(all(torch.equal(a, b[perm]) for a, b in zip(ks, k)),
                    "shared cold: sorting the members changed a result")
            ms = time_ms(lambda: admm_iterate_cuda_shared(qprm, *srt), 20)
            phase("kernel", f"shared cold, members sorted by their iteration counts: kernel "
                            f"{ms:.4f} ms (unsorted {rows[name][0]:.4f} ms)")
    return worst, rows["warm"]


def vehicle(dev):
    """The README Quickstart's kinematic SE(2) vehicle tracking a screw:
    ``(f, xdes, udes)`` in float32 on ``dev``."""
    from smooth_feedback_tpu_torch.groups import SE2

    twist = torch.tensor(TWIST, dtype=torch.float32, device=dev)
    f = lambda x, u: torch.stack([u[0], torch.zeros_like(u[0]), u[1]])
    xdes = lambda t: SE2.exp(t * twist)
    udes = lambda t: torch.stack([twist[0], twist[2]])
    return f, xdes, udes


def fleet_qp_params(backend):
    """The fleet's solver settings: the defaults (rho 0.1, rho_eq_scale 1e3,
    max_iter 4000) with polish off and a check every 10 iterations."""
    from smooth_feedback_tpu_torch.qp import QPSolverParams

    return QPSolverParams(polish=False, stop_check_iter=10, backend=backend)


def make_fleet_path(backend, dev):
    """The Quickstart vehicle at K=30, tf=3 (n = 163, m = 99), per-member
    transcription and factorization (reuse_factors=False, condense=False)."""
    from smooth_feedback_tpu_torch.controllers import MPCParams, MPCWeights, make_mpc_step
    from smooth_feedback_tpu_torch.groups import SE2, Rn

    kw = dict(dtype=torch.float32, device=dev)
    f, xdes, udes = vehicle(dev)
    return make_mpc_step(
        SE2, Rn(2), f, xdes, udes,
        weights=MPCWeights(Q=torch.eye(3, **kw), Qtf=5 * torch.eye(3, **kw),
                           R=0.1 * torch.eye(2, **kw)),
        params=MPCParams(K=FLEET_K, tf=3.0, return_trajectories=False,
                         qp=fleet_qp_params(backend)),
        **kw,
    )


def fleet_initial(dev):
    """Clocks ~ U(0, 10) and states SE2.rplus(xdes(t), 0.3 N(0, I3)), seed 0."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.groups import SE2

    rng = np.random.default_rng(SEED)
    kw = dict(dtype=torch.float32, device=dev)
    ts = torch.as_tensor(rng.uniform(0.0, 10.0, FLEET_B), **kw)
    noise = torch.as_tensor(0.3 * rng.standard_normal((FLEET_B, 3)), **kw)
    _, xdes, _ = vehicle(dev)
    return ts, vmap(SE2.rplus)(vmap(xdes)(ts), noise)


def plant(dev, xs, u):
    """One DT of the vehicle: x <- x (+) DT f(x, u)."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.groups import SE2

    f, _, _ = vehicle(dev)
    return vmap(SE2.rplus)(xs, DT * vmap(f)(xs, u))


def problem_family(n, m, B_, seed):
    """A numpy family of QPs, each with its own P and A: member 2 has a row
    unbounded above and one unbounded below, member 3 is primal infeasible
    (x0 >= 1 and x0 <= -1), member 4 dual infeasible (P = 0, A = 0, free
    rows, q != 0)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B_, n, n)) / np.sqrt(n)
    P = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(n)
    A = rng.standard_normal((B_, m, n)) / np.sqrt(n)
    center = np.einsum("bmn,bn->bm", A, rng.standard_normal((B_, n)))
    spread = np.abs(rng.standard_normal((B_, m))) + 0.1
    l, u = center - spread, center + spread
    q = rng.standard_normal((B_, n))
    u[2, 0], l[2, 1] = np.inf, -np.inf
    A[3, :2] = 0.0
    A[3, :2, 0] = 1.0
    l[3, 0], u[3, 0] = 1.0, np.inf
    l[3, 1], u[3, 1] = -np.inf, -1.0
    P[4], A[4], l[4], u[4] = 0.0, 0.0, -np.inf, np.inf
    return P, q, A, l, u


def problem_kernel_phase(step, dev):
    """The per-problem kernel against the plain version on the fleet path's
    real inputs (cold and warm), then on a numpy family that fires every
    certificate.  Returns the worst error, the warm solve's kernel and plain
    times and its bound."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.convert import qp_from_numpy
    from smooth_feedback_tpu_torch.qp import (
        QPSolutionStatus, admm_iterate_cuda, admm_iterate_reference, per_problem_kernel_args,
        solve_qp_batch,
    )

    qprm = fleet_qp_params("cuda")
    ts, xs = fleet_initial(dev)
    qps_cold = vmap(step.transcribe)(ts, xs)
    m, n = qps_cold.A.shape[-2:]
    require((n, m) == (163, 99), f"fleet QP is n={n}, m={m}, expected n=163, m=99")
    cold = per_problem_kernel_args(qps_cold, None, None, qprm)
    worst = fixed_iteration_check(admm_iterate_cuda, cold, qprm)
    # warm start: the cold solution, one clock step later
    qps_warm = vmap(step.transcribe)(ts + DT, xs)
    warm = per_problem_kernel_args(qps_warm, None, solve_qp_batch(qps_cold, qprm), qprm)
    rows = {}
    for name, qps, args in (("cold", qps_cold, cold), ("warm", qps_warm, warm)):
        err, k = compare_with_plain(f"per-problem {name}", admm_iterate_cuda, qprm, args, qps)
        worst = max(worst, err)
        rows[name] = (
            time_ms(lambda: admm_iterate_cuda(qprm, *args), 10),
            time_ms(lambda: admm_iterate_reference(qprm, *args), 3),
            *bound(args, k, qprm),
        )
        single = time_single_ms(lambda: admm_iterate_cuda(qprm, *args), 10)
        phase("kernel", f"per-problem {name}: kernel {rows[name][0]:.4f} ms, plain "
                        f"{rows[name][1]:.4f} ms per solve at B={FLEET_B}, n={n}, m={m} (means "
                        f"of back-to-back calls; median of single kernel launches {single:.4f} "
                        f"ms); bound {rows[name][2]:.4f} ms ({rows[name][3]})")

    # every certificate branch on the card: +-inf rows, a primal- and a
    # dual-infeasible member, a member that starts PrimalInfeasible
    # dual-infeasible member (eps_abs = eps_rel = 1e-3, the defaults)
    fam = qp_from_numpy(problem_family(64, 64, 256, SEED), device=dev)
    args = per_problem_kernel_args(fam, None, None, qprm)
    args[15][1] = int(QPSolutionStatus.PrimalInfeasible)
    err, k = compare_with_plain("per-problem family", admm_iterate_cuda, qprm, args, fam)
    st, it = k[3].tolist(), k[4].tolist()
    phase("kernel", f"per-problem family: members 1-4 status {st[1:5]} iters {it[1:5]}")
    require(st[1] == QPSolutionStatus.PrimalInfeasible and it[1] == 0,
            "the member that started PrimalInfeasible was touched")
    require(st[3] == QPSolutionStatus.PrimalInfeasible, "no primal-infeasibility certificate")
    require(st[4] == QPSolutionStatus.DualInfeasible, "no dual-infeasibility certificate")
    require(st[2] == QPSolutionStatus.Optimal, "the member with +-inf rows is not Optimal")
    return max(worst, err), rows["warm"]


def fleet_phase(step, ws0, dev):
    """FLEET_STEPS closed-loop steps of the per-member-clock fleet through
    the per-problem kernel.  Returns the launch counts and, for the first
    FLEET_PLAIN_STEPS steps, each step's clocks, states, warm start and
    result."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.qp import admm_iterate_cuda, per_problem_kernel_args, qp_factorize

    qprm = fleet_qp_params("cuda")
    ts, xs = fleet_initial(dev)
    ws = type(ws0)(*(a.expand((FLEET_B,) + a.shape).contiguous() for a in ws0))
    statuses, iters, us, step_s, kept = [], [], [], [], []
    reset_counts()
    for i in range(FLEET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = step.fleet(ws, ts, xs)
        if i < FLEET_PLAIN_STEPS:
            kept.append((ts, xs, ws, r))
        xs = plant(dev, xs, r.u)
        ts = ts + DT
        ws = r.warmstart
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        statuses.append(r.status)
        iters.append(ws.iters)
        us.append(r.u)
    counts = read_counts()
    st = torch.stack(statuses)
    u = torch.stack(us)
    opt = float((st == 0).float().mean())
    med = float(np.median(step_s))
    bad = torch.nonzero(st != 0).tolist()
    phase("fleet", f"{FLEET_STEPS} steps x B={FLEET_B} on per-member clocks: Optimal "
                   f"{opt * 100:.3f}%, launches {counts}, median step {med * 1e3:.3f} ms (min "
                   f"{min(step_s) * 1e3:.3f}, max {max(step_s) * 1e3:.3f}), {FLEET_B / med:.1f} "
                   f"solves/s, mean ADMM iters {float(torch.stack(iters).float().mean()):.3f}")
    phase("fleet", f"not Optimal (step, member): {bad[:50]} statuses "
                   f"{[int(st[i, j]) for i, j in bad[:50]]}")
    require(counts["admm_problem"] == FLEET_STEPS,
            f"per-problem kernel launched {counts['admm_problem']} times in {FLEET_STEPS} steps")
    require(opt >= 0.999, f"fleet Optimal {opt:.5f} < 0.999")
    require(bool(torch.isfinite(u).all()), "non-finite u")
    require(tuple(u.shape) == (FLEET_STEPS, FLEET_B, 2), f"u has shape {tuple(u.shape)}")

    # a synchronised split of the next step: its stages one after another,
    # then the whole step, five times over; medians of each
    stages = {
        "transcription": lambda _: vmap(step.transcribe)(ts, xs),
        "factorization": lambda qps: (qps, qp_factorize(qps, qprm)),
        "scaling and warm start": lambda qf: per_problem_kernel_args(*qf, ws, qprm),
        "kernel": lambda args: admm_iterate_cuda(qprm, *args),
        "whole step": lambda _: step.fleet(ws, ts, xs),
    }
    times = {name: [] for name in stages}
    for _ in range(5):
        out = None
        for name, fn in stages.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(out)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    med = {name: float(np.median(t)) for name, t in times.items()}
    rest = med["whole step"] - sum(v for k, v in med.items() if k != "whole step")
    phase("fleet", "one step, synchronised split (medians of 5): " + ", ".join(
        f"{name} {v:.3f} ms" for name, v in med.items()
    ) + f"; whole step minus the stages (solver and MPC finalize, and host timing "
        f"noise) {rest:.3f} ms")
    return counts, kept


def fleet_plain_phase(dev, kept):
    """The first fleet steps again on the plain path, each from the kernel
    path's clocks, states and warm start for that step."""
    step_p, _ = make_fleet_path("torch", dev)
    worst, agree = 0.0, 1.0
    for ts, xs, ws, rk in kept:
        r = step_p.fleet(ws, ts, xs)
        same = (r.status == 0) & (rk.status == 0) & (r.warmstart.iters == rk.warmstart.iters)
        du = (r.u - rk.u).abs().amax(dim=1)
        worst = max(worst, float(du[same].max()) if bool(same.any()) else float("inf"))
        agree = min(agree, float((r.status == rk.status).float().mean()))
    phase("fleet-plain", f"plain path, first {len(kept)} steps on the kernel path's clocks, "
                         f"states and warm starts: status agreement >= {agree * 100:.3f}%, max "
                         f"|du| equal-iters {worst:.3e}")
    require(agree >= 0.999, "plain and kernel fleet paths disagree on statuses")
    require(worst <= PRIMAL_TOL, f"u differs from the plain fleet path by {worst:.3e}")
    return worst


def main_path_phase(step, ws0, dev, keep=5):
    """200 closed-loop fleet steps through the shared-matrix kernel.  Returns
    the launch counts and, for the first ``keep`` steps, each step's states, warm start
    and result."""
    from smooth_feedback_tpu_torch.qp import admm_iterate_cuda_shared, shared_kernel_args

    xs = initial_states(dev)
    ws = type(ws0)(*(a.expand((B,) + a.shape).contiguous() for a in ws0))
    statuses, iters, us, step_s, kept = [], [], [], [], []
    reset_counts()
    for i in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = step.fleet_shared_t(ws, DT * i, xs)
        if i < keep:
            kept.append((xs, ws, r))
        xs = xs + DT * torch.stack([xs[:, 1], r.u[:, 0]], dim=1)
        ws = r.warmstart
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        statuses.append(r.status)
        iters.append(ws.iters)
        us.append(r.u)
    counts = read_counts()
    launches = counts["admm_shared"]
    st = torch.stack(statuses)
    it = torch.stack(iters).float()
    u = torch.stack(us)
    opt = float((st == 0).float().mean())
    med = float(np.median(step_s))

    # the kernel alone on the next step's inputs, warm-started from the carry
    args = shared_kernel_args(step.condensed_qp(DT * STEPS, xs), step.factors, ws)
    kern_ms = time_ms(lambda: admm_iterate_cuda_shared(qp_params("cuda"), *args), 20)
    share = kern_ms / (med * 1e3)
    phase("main", f"{STEPS} steps x B={B}: Optimal {opt * 100:.3f}%, launches "
                  f"{counts}, median step {med * 1e3:.3f} ms (min {min(step_s) * 1e3:.3f}, "
                  f"max {max(step_s) * 1e3:.3f}), {B / med:.1f} solves/s, mean ADMM iters "
                  f"{float(it.mean()):.3f}, kernel on a step's inputs {kern_ms:.4f} ms = "
                  f"{share * 100:.2f}% of the median step")
    require(opt >= 0.999, f"main path Optimal {opt:.5f} < 0.999")
    require(launches == STEPS, f"kernel launched {launches} times in {STEPS} steps")
    require(bool(torch.isfinite(u).all()), "non-finite u")
    # u may leave [-0.5, 0.5] by the ADMM primal tolerance
    # (eps_abs + eps_rel * 0.5 = 1.5e-3); allow 2e-3
    umax = float(u.abs().max())
    require(umax <= 0.5 + 2e-3, f"|u| reached {umax:.5f}")
    require(tuple(u.shape) == (STEPS, B, 1), f"u has shape {tuple(u.shape)}")
    return counts, kept


def reference_phase(dev, kept):
    """The first steps of the main path again on the plain loop, each from
    the kernel path's states and warm start for that step, so every step
    compares the two solvers on the same inputs."""
    step_p, _ = make_main_path("torch", dev)
    worst, agree, eq_it = 0.0, 1.0, 1.0
    for i, (xs, ws, rk) in enumerate(kept):
        r = step_p.fleet_shared_t(ws, DT * i, xs)
        same = (r.status == 0) & (rk.status == 0) & (r.warmstart.iters == rk.warmstart.iters)
        du = (r.u - rk.u).abs()[:, 0]
        worst = max(worst, float(du[same].max()) if bool(same.any()) else float("inf"))
        agree = min(agree, float((r.status == rk.status).float().mean()))
        eq_it = min(eq_it, float((r.warmstart.iters == rk.warmstart.iters).float().mean()))
    phase("reference", f"plain path, first {len(kept)} steps on the kernel path's states and "
                       f"warm starts: status agreement >= {agree * 100:.3f}%, equal iters >= "
                       f"{eq_it * 100:.3f}%, max |du| equal-iters {worst:.3e}")
    require(agree >= 0.999, "plain and kernel paths disagree on statuses")
    require(eq_it >= 0.995, f"plain and kernel paths agree on iterations for {eq_it:.5f}")
    require(worst <= PRIMAL_TOL, f"u differs from the plain path by {worst:.3e}")
    return worst


def vehicle_asif_path(mpc_backend, dev):
    """benchmarks/asif_bench.py:39-123 in torch: the SE(2) x R^3 vehicle's
    condensed MPC on one clock and the ASIF filter, float32 on ``dev``.
    Returns ``(X, f, h, mpc_step, mpc_ws, asif_step, asif_ws)``."""
    from smooth_feedback_tpu_torch.controllers import (
        ASIFilterParams, MPCParams, MPCWeights, make_asif_step, make_mpc_step,
    )
    from smooth_feedback_tpu_torch.groups import SE2, Bundle, Rn

    kw = dict(dtype=torch.float32, device=dev)
    X, U = Bundle(SE2, Rn(3)), Rn(2)
    vdes = torch.tensor([1.0, 0.0, 0.4], **kw)
    base = torch.tensor([2.5, 0.0, 0.0, 1.0], **kw)
    mpc, mws = make_mpc_step(
        X, U, vehicle_asif_f, lambda t: torch.cat([SE2.rplus(base, t * vdes), vdes]),
        lambda t: torch.zeros(2, **kw), dxdes=lambda t: torch.cat([vdes, torch.zeros(3, **kw)]),
        weights=MPCWeights(Q=torch.eye(6, **kw), Qtf=0.1 * torch.eye(6, **kw), R=torch.eye(2, **kw)),
        params=MPCParams(K=ASIF_MPC_K, tf=5.0, return_trajectories=False,
                         qp=asif_mpc_params(mpc_backend)),
        cr=lambda x, u: u, crl=[-0.5, -0.5], cru=[0.5, 0.5],
        reuse_factors=True, condense=True, static_reference=True, **kw,
    )
    fl = asif_filter(dev)
    asif, aws = make_asif_step(
        X, U, vehicle_asif_f, fl["h"], fl["bu"],
        params=ASIFilterParams(T=ASIF_T, asif=asif_to_qp_params(), qp=asif_qp_params("torch", True)),
        W_u=fl["W_u"], ulim=fl["ulim"], **kw,
    )
    return X, vehicle_asif_f, fl["h"], mpc, mws, asif, aws


def vehicle_asif_f(x, u):
    """The bench's vehicle: SE(2) pose with body velocity x[4:7], damped."""
    return torch.stack(
        [x[4], x[5], x[6], -0.2 * x[4] + u[0], torch.zeros_like(x[4]), -0.4 * x[6] + u[1]]
    )


def asif_filter(dev):
    """The bench's barrier (clearance of the obstacle at (0, -2.3)), backup
    law, input weights and input bounds, float32 on ``dev``."""
    from smooth_feedback_tpu_torch.utils import ManifoldBounds

    kw = dict(dtype=torch.float32, device=dev)
    obstacle = torch.tensor([0.0, -2.3], **kw)
    return dict(
        h=lambda t, x: torch.linalg.vector_norm(x[:2] - obstacle)[None] - 0.7,
        bu=lambda t, x: torch.stack([0.2 * x[4], torch.full_like(x[4], -0.5)]),
        W_u=torch.tensor([20.0, 1.0], **kw),
        ulim=ManifoldBounds(A=torch.eye(2, **kw), c=torch.zeros(2, **kw),
                            l=torch.tensor([-0.2, -0.5], **kw), u=torch.tensor([0.5, 0.5], **kw)),
    )


def asif_to_qp_params():
    """The bench's barrier rows: K = 50 constraint times over T = 2.5."""
    from smooth_feedback_tpu_torch.controllers import ASIFtoQPParams

    return ASIFtoQPParams(K=50, dt=0.05, alpha=2.0, relax_cost=1000.0)


def asif_mpc_params(backend):
    """The bench's MPC solver settings (asif_bench.py:74-77) on a port backend."""
    from smooth_feedback_tpu_torch.qp import QPSolverParams

    return QPSolverParams(polish=False, max_iter=200, stop_check_iter=10, backend=backend)


def asif_qp_params(backend, adaptive):
    """The bench's ASIF solver settings (asif_bench.py:112-115): the lane
    backend there, whose semantics the torch loop has."""
    from smooth_feedback_tpu_torch.qp import QPSolverParams

    return QPSolverParams(polish=False, max_iter=250, stop_check_iter=10, rho=0.02,
                          adaptive_rho=adaptive, backend=backend)


def asif_initial(X, dev):
    """X.rplus(identity, 0.2 N(0, I6)) for ASIF_B vehicles, seed 0."""
    from torch.func import vmap

    dx = torch.as_tensor(0.2 * np.random.default_rng(SEED).standard_normal((ASIF_B, 6)),
                         dtype=torch.float32, device=dev)
    return vmap(lambda d: X.rplus(X.identity(dtype=torch.float32, device=dev), d))(dx)


def batch_ws(ws, B_):
    return type(ws)(*(a.expand((B_,) + a.shape).contiguous() for a in ws))


def vehicle_asif_phase(parts, dev):
    """ASIF_WARM + ASIF_STEPS closed-loop steps of the bench's fleet: the MPC
    through the shared-matrix kernel, the ASIF on the torch loop with
    adaptive rho, the plant.  The barrier must stay positive at every
    post-step state; the kernel must launch once a step.  Returns the launch
    counts, the first ASIF_PLAIN_STEPS steps' inputs and results, and the
    state and carries after the run."""
    from torch.func import vmap

    X, f, h, mpc, mws0, asif, aws0 = parts
    xs = asif_initial(X, dev)
    mws, aws = batch_ws(mws0, ASIF_B), batch_ws(aws0, ASIF_B)
    steps = ASIF_WARM + ASIF_STEPS
    kept, step_s, m_st, a_st, a_it, hmins = [], [], [], [], [], []
    reset_counts()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = ASIF_DT * i
        m = mpc.fleet_shared_t(mws, t, xs)
        a = asif.fleet(aws, xs, m.u)
        if i < ASIF_PLAIN_STEPS:
            kept.append((t, xs, mws, aws, m, a))
        xs = vmap(lambda x, u: X.rplus(x, ASIF_DT * f(x, u)))(xs, a.u)
        hmin = vmap(lambda x: h(t, x)[0])(xs).min()
        mws, aws = m.warmstart, a.warmstart
        torch.cuda.synchronize()
        if i >= ASIF_WARM:
            step_s.append(time.perf_counter() - t0)
        m_st.append(m.status)
        a_st.append(a.status)
        a_it.append(a.warmstart.iters)
        hmins.append(hmin)
    counts = read_counts()
    m_opt = float((torch.stack(m_st) == 0).float().mean())
    a_opt = float((torch.stack(a_st) == 0).float().mean())
    h_min = float(torch.stack(hmins).min())
    med = float(np.median(step_s))
    phase("vehicle-asif", f"{steps} steps ({ASIF_WARM} warm-up, {ASIF_STEPS} timed) x B={ASIF_B}: "
                          f"MPC Optimal {m_opt * 100:.3f}%, ASIF Optimal {a_opt * 100:.3f}% (mean "
                          f"ASIF iters {float(torch.stack(a_it).float().mean()):.3f}), launches "
                          f"{counts}, min barrier {h_min:.6f}, median timed step {med * 1e3:.3f} ms "
                          f"(min {min(step_s) * 1e3:.3f}, max {max(step_s) * 1e3:.3f}), "
                          f"{ASIF_B / med:.1f} MPC+ASIF steps/s")
    require(h_min > 0.0, f"safety: min barrier {h_min} <= 0")
    require(counts["admm_shared"] == steps,
            f"shared kernel launched {counts['admm_shared']} times in {steps} steps")
    require(bool(torch.isfinite(xs).all()), "non-finite vehicle state")
    return counts, kept, (ASIF_DT * steps, xs, mws, aws)


def vehicle_asif_split(parts, carry, dev):
    """A synchronised split of one step at the carried state, five times
    over: MPC, ASIF transcription, ASIF solve, plant; medians."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.controllers import asif_to_qp_fleet
    from smooth_feedback_tpu_torch.qp import solve_qp_batch

    from smooth_feedback_tpu_torch.groups import Rn

    X, f, h, mpc, _, asif, _ = parts
    t, xs, mws, aws = carry
    fl = asif_filter(dev)
    stages = {
        "MPC": lambda _: mpc.fleet_shared_t(mws, t, xs),
        "ASIF transcription": lambda m: (m, asif_to_qp_fleet(
            X, Rn(2), asif_to_qp_params(), ASIF_T, xs, m.u, fl["W_u"], fl["ulim"], f, h, fl["bu"])),
        "ASIF solve": lambda mq: solve_qp_batch(mq[1], asif_qp_params("torch", True), aws),
        "plant": lambda sol: vmap(lambda x, u: X.rplus(x, ASIF_DT * f(x, u)))(xs, sol.primal[:, :2]),
    }
    times = {name: [] for name in list(stages) + ["whole step"]}
    for _ in range(5):
        out = None
        for name, fn in stages.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(out)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = mpc.fleet_shared_t(mws, t, xs)
        a = asif.fleet(aws, xs, m.u)
        vmap(lambda x, u: X.rplus(x, ASIF_DT * f(x, u)))(xs, a.u)
        torch.cuda.synchronize()
        times["whole step"].append((time.perf_counter() - t0) * 1e3)
    med = {name: float(np.median(v)) for name, v in times.items()}
    phase("vehicle-asif", "one step, synchronised split (medians of 5): " + ", ".join(
        f"{name} {v:.3f} ms" for name, v in med.items()))
    return med


# The vehicle MPC's u against the plain path: PR 1's bound (the kernel and
# the plain loop run the same f32 iterations in another summation order).
# The filtered u: the ASIF QP of a member differs between the two runs only
# through its input u_des (the MPC u), and its solution is the W_u-weighted
# projection of u_des onto the safe inputs, so |du| <= sqrt(20 / 1) |du_des|
# between exact solutions; a solve that stops at the same check adds the
# same f32 rounding as the MPC's.  So, where the ASIF iteration counts agree:
# |du_asif| <= PRIMAL_TOL + 5 max |du_mpc|.
ASIF_U_GAIN = 5.0


def vehicle_asif_plain_phase(dev, kept):
    """The first steps again with the MPC on the plain loop, each from the
    kernel path's state and carries for that step."""
    _, _, _, mpc_p, _, asif, _ = vehicle_asif_path("torch", dev)
    worst_m, worst_a, agree_m, agree_a = 0.0, 0.0, 1.0, 1.0
    for t, xs, mws, aws, mk, ak in kept:
        mp = mpc_p.fleet_shared_t(mws, t, xs)
        ap = asif.fleet(aws, xs, mp.u)
        same_m = (mp.status == 0) & (mk.status == 0) & (mp.warmstart.iters == mk.warmstart.iters)
        du_m = (mp.u - mk.u).abs().amax(dim=1)
        dm = float(du_m[same_m].max()) if bool(same_m.any()) else float("inf")
        same_a = (ap.status == ak.status) & (ap.warmstart.iters == ak.warmstart.iters)
        da = float((ap.u - ak.u).abs().amax(dim=1)[same_a].max()) if bool(same_a.any()) else 0.0
        require(da <= PRIMAL_TOL + ASIF_U_GAIN * float(du_m.max()),
                f"filtered u differs from the plain path by {da:.3e} at t={t:.3f}")
        worst_m, worst_a = max(worst_m, dm), max(worst_a, da)
        agree_m = min(agree_m, float((mp.status == mk.status).float().mean()))
        agree_a = min(agree_a, float(same_a.float().mean()))
    phase("vehicle-asif-plain", f"MPC on the plain loop, first {len(kept)} steps on the kernel "
                                f"path's states and carries: MPC status agreement >= "
                                f"{agree_m * 100:.3f}%, max |du| equal-iters {worst_m:.3e} (bound "
                                f"{PRIMAL_TOL:g}); ASIF statuses and iteration counts equal for >= "
                                f"{agree_a * 100:.3f}%, max |du| there {worst_a:.3e} (bound "
                                f"{PRIMAL_TOL:g} + {ASIF_U_GAIN:g} x max |du_mpc| of the step)")
    require(agree_m >= 0.999, "plain and kernel vehicle MPC disagree on statuses")
    require(worst_m <= PRIMAL_TOL, f"vehicle MPC u differs from the plain path by {worst_m:.3e}")
    require(agree_a >= 0.99, f"ASIF statuses or counts agree for only {agree_a:.4f}")
    return worst_m


def vehicle_kernel_phase(parts, kept, dev):
    """Both kernels at this path's shapes, against the plain version:
    admm_shared on one step's condensed vehicle QPs (n = m = 64, B = 256),
    admm_problem on one step's ASIF QPs (n = 3, m = 53, adaptive rho off),
    each cold and warm.  Returns each kernel's worst error and warm row."""
    from smooth_feedback_tpu_torch.controllers import asif_to_qp_fleet
    from smooth_feedback_tpu_torch.groups import Rn
    from smooth_feedback_tpu_torch.qp import (
        admm_iterate_cuda, admm_iterate_cuda_shared, admm_iterate_reference,
        per_problem_kernel_args, shared_kernel_args, solve_qp_batch,
    )

    X, f, h, mpc, _, asif, _ = parts
    t, xs, mws, aws, mk, ak = kept[-1]
    f_ = mpc.factors
    n, m = f_.Minv.shape[0], f_.As.shape[0]
    require((n, m) == (64, 64), f"vehicle MPC QP is {n}x{m}, expected 64x64")
    prm = asif_mpc_params("cuda")
    qps = mpc.condensed_qp(t, xs)
    cold = shared_kernel_args(qps, f_)
    worst_s = fixed_iteration_check(admm_iterate_cuda_shared, cold, prm)
    rows = {}
    for name, args in (("cold", cold), ("warm", shared_kernel_args(qps, f_, mws))):
        err, k = compare_with_plain(f"vehicle shared {name}", admm_iterate_cuda_shared, prm, args,
                                    qps)
        worst_s = max(worst_s, err)
        rows[name] = (time_ms(lambda: admm_iterate_cuda_shared(prm, *args), 20),
                      time_ms(lambda: admm_iterate_reference(prm, *args), 5), *bound(args, k, prm))
        phase("kernel", f"vehicle shared {name}: kernel {rows[name][0]:.4f} ms, plain "
                        f"{rows[name][1]:.4f} ms per solve at B={ASIF_B}, n=m={n} (means of "
                        f"back-to-back calls); bound {rows[name][2]:.4f} ms ({rows[name][3]})")
    shared_row = rows["warm"]

    fl = asif_filter(dev)
    aq = asif_to_qp_fleet(X, Rn(2), asif_to_qp_params(), ASIF_T, xs, mk.u, fl["W_u"], fl["ulim"],
                          f, h, fl["bu"])
    am, an = aq.A.shape[-2:]
    require((an, am) == (3, 53), f"ASIF QP is n={an}, m={am}, expected n=3, m=53")
    prm_k = asif_qp_params("cuda", False)
    cold = per_problem_kernel_args(aq, None, None, prm_k)
    # a member whose desired input is already safe has the cold start (0) as
    # its exact solution and stops at the first check even with every
    # tolerance 0: the fixed iterations start from a seeded random iterate
    rng = np.random.default_rng(SEED)
    noisy = list(cold)
    for i in (12, 13, 14):  # x0, z0, y0
        noisy[i] = torch.as_tensor(0.1 * rng.standard_normal(tuple(cold[i].shape)),
                                   dtype=torch.float32, device=dev)
    worst_p = fixed_iteration_check(admm_iterate_cuda, tuple(noisy), prm_k,
                                    "a seeded random start (std 0.1)")
    rows = {}
    for name, args in (("cold", cold), ("warm", per_problem_kernel_args(aq, None, aws, prm_k))):
        err, k = compare_with_plain(f"ASIF per-problem {name}", admm_iterate_cuda, prm_k, args, aq)
        worst_p = max(worst_p, err)
        rows[name] = (time_ms(lambda: admm_iterate_cuda(prm_k, *args), 20),
                      time_ms(lambda: admm_iterate_reference(prm_k, *args), 5), *bound(args, k, prm_k))
        phase("kernel", f"ASIF per-problem {name}: kernel {rows[name][0]:.4f} ms, plain "
                        f"{rows[name][1]:.4f} ms per solve at B={ASIF_B}, n={an}, m={am} (means of "
                        f"back-to-back calls); bound {rows[name][2]:.4f} ms ({rows[name][3]})")

    # the ASIF solve on both routes, warm-started from the carry
    for route, p in (("torch loop, adaptive rho", asif_qp_params("torch", True)),
                     ("kernel, static rho", prm_k)):
        ts, sol = [], None
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = solve_qp_batch(aq, p, aws)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        phase("kernel", f"ASIF solve ({route}): {float(np.median(ts)):.3f} ms (median of 5, "
                        f"solve_qp_batch), mean iters {float(sol.iters.float().mean()):.3f}, "
                        f"Optimal {float((sol.status == 0).float().mean()) * 100:.3f}%")
    return worst_s, shared_row, worst_p, rows["warm"]


def entry_points_phase(dev):
    """The user entry points with default solver parameters (polish on): the
    MPC class on the Quickstart vehicle (float64: polish by Cholesky) and
    the ASIFilter on one vehicle of the bench's configuration (float32:
    polish by LU), five calls each."""
    from collections import Counter

    from smooth_feedback_tpu_torch.controllers import MPC, ASIFilter, ASIFilterParams, MPCParams
    from smooth_feedback_tpu_torch.groups import SE2, Bundle, Rn

    ok = {0, 4}  # Optimal, MaxIterations
    k64 = dict(dtype=torch.float64, device=dev)
    twist = torch.tensor(TWIST, **k64)
    f = lambda x, u: torch.stack([u[0], torch.zeros_like(u[0]), u[1]])
    mpc = MPC(SE2, Rn(2), f, params=MPCParams(K=8, tf=3.0), **k64)
    mpc.set_xdes(lambda t: SE2.exp(t * twist), dxdes=lambda t: twist)
    mpc.set_udes(lambda t: torch.stack([twist[0], twist[2]]))
    x = SE2.exp(torch.tensor([0.2, -0.1, 0.1], **k64))
    stats, t0 = Counter(), time.perf_counter()
    for i in range(5):
        u, st = mpc(DT * i, x)
        require(bool(torch.isfinite(u).all()) and int(st) in ok, f"MPC call {i}: {st!r}, u {u}")
        stats[st.name] += 1
        x = SE2.rplus(x, DT * f(x, u))
    phase("entry-points", f"MPC class (Quickstart SE(2) vehicle, K=8, float64, default solver "
                          f"parameters: polish on, backend torch): 5 calls in "
                          f"{time.perf_counter() - t0:.3f} s, statuses {dict(stats)}, last u "
                          f"{[round(float(v), 6) for v in u]}")

    k32 = dict(dtype=torch.float32, device=dev)
    X, fl = Bundle(SE2, Rn(3)), asif_filter(dev)
    fil = ASIFilter(X, Rn(2), vehicle_asif_f, fl["h"], fl["bu"],
                    params=ASIFilterParams(T=ASIF_T, asif=asif_to_qp_params()),
                    W_u=fl["W_u"], ulim=fl["ulim"], **k32)
    x = X.rplus(X.identity(**k32), torch.tensor([0.0, -0.3, -1.2, 0.5, 0.0, 0.0], **k32))
    stats, t0 = Counter(), time.perf_counter()
    for i in range(5):
        u, st = fil(x, torch.tensor([0.3, 0.0], **k32))
        require(bool(torch.isfinite(u).all()) and int(st) in ok, f"ASIFilter call {i}: {st!r}, u {u}")
        stats[st.name] += 1
        x = X.rplus(x, ASIF_DT * vehicle_asif_f(x, u))
    phase("entry-points", f"ASIFilter (bench vehicle, K=50, T=2.5, float32, default solver "
                          f"parameters: polish on, backend torch): 5 calls in "
                          f"{time.perf_counter() - t0:.3f} s, statuses {dict(stats)}, last u "
                          f"{[round(float(v), 6) for v in u]}")


def main():
    card = device_phase()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    layout_phase()
    t0 = time.perf_counter()
    step, ws0 = make_main_path("cuda", dev)
    fleet, fws0 = make_fleet_path("cuda", dev)
    phase("setup", f"make_mpc_step, both paths (K={K} condensed, K={FLEET_K} sparse) "
                   f"{time.perf_counter() - t0:.3f} s")
    rows = {"admm_shared": kernel_phase(step, dev), "admm_problem": problem_kernel_phase(fleet, dev)}
    counts, kept = main_path_phase(step, ws0, dev)
    err = reference_phase(dev, kept)
    rows["admm_shared"] = (max(rows["admm_shared"][0], err), rows["admm_shared"][1])
    launches = {"admm_shared": counts["admm_shared"]}
    counts, kept = fleet_phase(fleet, fws0, dev)
    err = fleet_plain_phase(dev, kept)
    rows["admm_problem"] = (max(rows["admm_problem"][0], err), rows["admm_problem"][1])
    launches["admm_problem"] = counts["admm_problem"]

    vparts = vehicle_asif_path("cuda", dev)
    vcounts, vkept, vcarry = vehicle_asif_phase(vparts, dev)
    vehicle_asif_split(vparts, vcarry, dev)
    err = vehicle_asif_plain_phase(dev, vkept)
    worst_s, _, worst_p, _ = vehicle_kernel_phase(vparts, vkept, dev)
    rows["admm_shared"] = (max(rows["admm_shared"][0], err, worst_s), rows["admm_shared"][1])
    rows["admm_problem"] = (max(rows["admm_problem"][0], worst_p), rows["admm_problem"][1])
    phase("launches", f"per path (counts set to 0 before each, read after): condensed "
                      f"{launches['admm_shared']} admm_shared in {STEPS} steps; per-member fleet "
                      f"{launches['admm_problem']} admm_problem in {FLEET_STEPS} steps; vehicle-asif "
                      f"{vcounts} in {ASIF_WARM + ASIF_STEPS} steps")
    entry_points_phase(dev)
    kernels = []
    for name, (max_err, (ms, plain_ms, bound_ms, bound_by)) in rows.items():
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call runs a whole ADMM solve
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
