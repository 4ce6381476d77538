#!/usr/bin/env python3
"""What one iteration and one stopping check of each ADMM kernel cost, on one
CUDA GPU.

Builds chip_smoke.py's two paths and takes each kernel's real inputs at its
path's shapes (shared: n = m = 52; per-problem: n = 163, m = 99, B = 1024).
With every tolerance 0 no member can stop, so a launch runs exactly max_iter
iterations; from launches of different lengths and check cadences it reports

  - the time per iteration: (T(2 N iterations) - T(N iterations)) / N, no
    check in either;
  - the time per check: (T(N iterations, a check every iteration) -
    T(N iterations, no check)) / N;
  - the time of a launch of one iteration (set-up, loads and stores);
  - the warm and the cold solve;

for the shared kernel at B = 8192, 4096, 2048 and 1024 and for the per-problem
kernel.  All times are medians of event pairs around single launches
(chip_smoke.time_single_ms), for the whole fleet.

Run from the repository root:  python3 profile_kernels.py
"""

import dataclasses
import os
import sys

import torch


def fixed(prm, iters, every):
    """``prm`` with every tolerance 0, ``iters`` iterations and a check every
    ``every`` iterations."""
    return dataclasses.replace(prm, eps_abs=0.0, eps_rel=0.0, eps_primal_inf=0.0,
                               eps_dual_inf=0.0, max_iter=iters, stop_check_iter=every)


def slopes(cs, wrapper, prm, args, n_iter, reps):
    """Per-iteration and per-check time and the one-iteration launch, in us."""
    t = {}
    for iters, every in ((1, 10 * n_iter), (n_iter, 10 * n_iter), (2 * n_iter, 10 * n_iter),
                         (n_iter, 1)):
        p = fixed(prm, iters, every)
        t[(iters, every)] = cs.time_single_ms(lambda: wrapper(p, *args), reps)
    per_it = (t[(2 * n_iter, 10 * n_iter)] - t[(n_iter, 10 * n_iter)]) / n_iter
    per_check = (t[(n_iter, 1)] - t[(n_iter, 10 * n_iter)]) / n_iter
    return per_it * 1e3, per_check * 1e3, t[(1, 10 * n_iter)] * 1e3


def problem_inputs(cs, dev):
    """The per-problem kernel's cold and warm inputs on the fleet path."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.qp import per_problem_kernel_args, solve_qp_batch

    fleet, _ = cs.make_fleet_path("cuda", dev)
    fprm = cs.fleet_qp_params("cuda")
    ts, xs = cs.fleet_initial(dev)
    qc = vmap(fleet.transcribe)(ts, xs)
    pcold = per_problem_kernel_args(qc, None, None, fprm)
    pwarm = per_problem_kernel_args(vmap(fleet.transcribe)(ts + cs.DT, xs), None,
                                    solve_qp_batch(qc, fprm), fprm)
    return fprm, pcold, pwarm


def main():
    import chip_smoke as cs

    print(cs.device_phase())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.build_phase()
    from smooth_feedback_tpu_torch.qp import (
        admm_iterate_cuda, admm_iterate_cuda_shared, shared_kernel_args, solve_qp_batch,
    )
    from smooth_feedback_tpu_torch.qp.cuda_kernel import shared_plan

    step, _ = cs.make_main_path("cuda", dev)
    f = step.factors
    qprm = cs.qp_params("cuda")
    xs = cs.initial_states(dev)
    qps_cold = step.condensed_qp(0.0, xs)
    cold = shared_kernel_args(qps_cold, f)
    warm = shared_kernel_args(step.condensed_qp(cs.DT, xs), f, solve_qp_batch(qps_cold, qprm, None, f))
    cut = lambda args, B: tuple(a[:B].contiguous() if a.dim() and a.shape[0] == cs.B else a
                                for a in args)
    for B in (8192, 4096, 2048, 1024):
        w, c = cut(warm, B), cut(cold, B)
        t_warm = cs.time_single_ms(lambda: admm_iterate_cuda_shared(qprm, *w), 20)
        t_cold = cs.time_single_ms(lambda: admm_iterate_cuda_shared(qprm, *c), 20)
        per_it, per_check, one = slopes(cs, admm_iterate_cuda_shared, qprm, c, 200, 5)
        P, pb, warps, smem = shared_plan(B, 52, 52, qprm.kernel_block)
        cs.phase("shared", f"B={B} ({P} problems a warp, {pb} problems and {warps} warps a "
                           f"block, {smem} bytes): warm {t_warm:.4f} ms, cold {t_cold:.4f} ms, "
                           f"iteration {per_it:.3f} us, check {per_check:.3f} us, one-iteration "
                           f"launch {one:.3f} us")

    fprm, pcold, pwarm = problem_inputs(cs, dev)
    t_warm = cs.time_single_ms(lambda: admm_iterate_cuda(fprm, *pwarm), 10)
    t_cold = cs.time_single_ms(lambda: admm_iterate_cuda(fprm, *pcold), 10)
    per_it, per_check, one = slopes(cs, admm_iterate_cuda, fprm, pcold, 20, 5)
    cs.phase("per-problem", f"B={cs.FLEET_B}, n=163, m=99: warm {t_warm:.4f} ms, cold {t_cold:.4f} "
                            f"ms, iteration {per_it:.3f} us, check {per_check:.3f} us, "
                            f"one-iteration launch {one:.3f} us (the fleet's 1024 blocks, one "
                            f"block an SM at a time)")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
