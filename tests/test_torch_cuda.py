"""The CUDA kernels (shared-matrix and per-problem ADMM, the lane backend's
whole solve) against their plain PyTorch version, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip.  They import no
JAX, so they also run where only the port's dependencies are installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import lane_family, problem_family
from smooth_feedback_tpu_torch.convert import qp_from_numpy
from smooth_feedback_tpu_torch.qp import (
    QPSolutionStatus,
    QPSolverParams,
    admm_iterate_cuda,
    admm_iterate_cuda_shared,
    admm_iterate_reference,
    per_problem_kernel_args,
    qp_factorize,
    solve_qp_batch,
)
from smooth_feedback_tpu_torch.qp.cuda_kernel import problem_route, shared_plan

torch.set_num_threads(1)

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(n, m, B, seed, dev):
    """Scaled kernel inputs for a shared random QP family, built in f64 with
    the port's own factorization and cast to f32; member 1 starts
    PrimalInfeasible, member 2 has a row unbounded on each side."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) / np.sqrt(n)
    P = M @ M.T + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    center = A @ rng.standard_normal((B, n)).T
    spread = np.abs(rng.standard_normal((m, 1))) + 0.1
    l, u = (center - spread).T, (center + spread).T
    l[2, 0], u[2, 1] = -np.inf, np.inf
    q = rng.standard_normal((B, n))
    prm = QPSolverParams(polish=False, rho=2.0, rho_eq_scale=15.0)
    f = qp_factorize(qp_from_numpy((P[None], q[:1], A[None], l[:1], u[:1]), device="cpu"), prm)
    f = [a[0] for a in f]
    c, sx, sy, rho, Ps, As, _, Minv, _ = f
    f32 = lambda t: torch.as_tensor(t, dtype=torch.float32).to(dev).contiguous()
    ql, ll, ul = (torch.as_tensor(a) for a in (q, l, u))
    status0 = torch.full((B,), -1, dtype=torch.int32)
    status0[1] = int(QPSolutionStatus.PrimalInfeasible)
    return [
        f32(Minv), f32(As), f32(Ps), f32(c * sx * ql), f32(sy * ll), f32(sy * ul),
        f32(rho), f32(sx), f32(sy), f32(c), f32(ll), f32(ul),
        f32(torch.zeros(B, n)), f32(torch.zeros(B, m)), f32(torch.zeros(B, m)),
        status0.to(dev),
    ]


SHAPES = [
    (7, 9, 8),  # one entry per lane
    (52, 52, 8),  # the main path's shape
    (52, 52, 1),  # one problem per block
    (70, 90, 2),  # three entries per lane, > 48 KB shared memory
    (128, 100, 4),  # four entries per lane
]


@pytest.mark.parametrize("n,m,block", SHAPES)
def test_kernel_iterates_match_plain_version(dev, n, m, block):
    """With stopping disabled (all tolerances 0) both run exactly 40
    iterations, so the iterates compare directly: within 1e-3 (f32 with
    another summation order and FMA contraction, over 40 iterations)."""
    args = _inputs(n, m, 1000, seed=n + m, dev=dev)
    prm = QPSolverParams(polish=False, rho=2.0, rho_eq_scale=15.0, max_iter=40,
                         stop_check_iter=10, eps_abs=0.0, eps_rel=0.0, eps_primal_inf=0.0,
                         eps_dual_inf=0.0, backend="cuda", kernel_block=block)
    k = admm_iterate_cuda_shared(prm, *args)
    r = admm_iterate_reference(prm, *args)
    torch.cuda.synchronize()
    assert torch.equal(k[3], r[3]) and torch.equal(k[4], r[4])
    assert int((k[3] == QPSolutionStatus.MaxIterations).sum()) == 999
    for kt, rt in zip(k, r):
        if kt.dtype == torch.float32:
            torch.testing.assert_close(kt, rt, atol=1e-3, rtol=1e-3)


# least share of members on which kernel and f32 plain version agree on the
# iteration count, per (n, m, stop_check_iter): five points under the
# readings on an H100 80GB HBM3 at 700 W (0.994, 0.998, 0.737, 0.966, 0.611,
# 0.951, 0.192, 0.666 in this order), where the f64 run sided with the kernel
# and with the plain version about equally often on the members they split
ITER_FLOOR = {
    (7, 9, 1): 0.94, (7, 9, 10): 0.94,
    (52, 52, 1): 0.68, (52, 52, 10): 0.91,
    (70, 90, 1): 0.56, (70, 90, 10): 0.90,
    (128, 100, 1): 0.14, (128, 100, 10): 0.61,
}


@pytest.mark.parametrize("n,m,block", SHAPES)
@pytest.mark.parametrize("stop_check_iter", [1, 10])
def test_kernel_statuses_match_plain_version(dev, n, m, block, stop_check_iter):
    """With the stopping check on: statuses agree for all but 0.1% of
    members and mean iteration counts within 2%; where iteration counts
    agree the iterates are within 1e-3; the member that started
    PrimalInfeasible comes back untouched; the kernel launched once.

    These families need 40-300 iterations, and a member whose residual ends
    within f32 rounding of a check's threshold stops one check earlier or
    later: the f32 plain version itself matches its own f64 run on only
    19-100% of iteration counts, depending on the shape.  So the kernel is
    held to that noise: it matches the f64 run's iteration counts within 5
    points as often as the f32 plain version does, and the f32 plain
    version's counts at least ITER_FLOOR as often."""
    args = _inputs(n, m, 1000, seed=n + m, dev=dev)
    prm = QPSolverParams(polish=False, rho=2.0, rho_eq_scale=15.0, max_iter=1500,
                         stop_check_iter=stop_check_iter, backend="cuda", kernel_block=block)
    admm_iterate_cuda_shared.launches = 0
    k = admm_iterate_cuda_shared(prm, *args)
    assert admm_iterate_cuda_shared.launches == 1
    r = admm_iterate_reference(prm, *args)
    d = admm_iterate_reference(prm, *(a.double() if a.is_floating_point() else a for a in args))
    torch.cuda.synchronize()
    assert float((k[3] == r[3]).float().mean()) >= 0.999
    ki, ri = float(k[4].float().mean()), float(r[4].float().mean())
    assert abs(ki - ri) <= 0.02 * ri
    eq_iters = lambda a, b: float((a[4] == b[4]).float().mean())
    assert eq_iters(k, d) >= eq_iters(r, d) - 0.05
    assert eq_iters(k, r) >= ITER_FLOOR[(n, m, stop_check_iter)]
    same = (k[3] == r[3]) & (k[4] == r[4])
    for kt, rt in zip(k[:3], r[:3]):
        torch.testing.assert_close(kt[same], rt[same], atol=1e-3, rtol=0)
    assert int(k[3][1]) == QPSolutionStatus.PrimalInfeasible and int(k[4][1]) == 0
    assert torch.equal(k[0][1], args[12][1]) and float(k[5][1]) == float("inf")
    assert float((k[3] == QPSolutionStatus.Optimal).float().mean()) >= 0.99


def test_kernel_refuses_what_it_cannot_hold(dev):
    """Shapes beyond one block's shared memory, blocks beyond 8 problems and
    tensors on different devices raise before any launch."""
    args = _inputs(7, 9, 4, seed=0, dev=dev)
    prm = QPSolverParams(polish=False, backend="cuda")
    admm_iterate_cuda_shared.launches = 0
    mixed = list(args)
    mixed[3] = mixed[3].cpu()
    with pytest.raises(ValueError):
        admm_iterate_cuda_shared(prm, *mixed)
    with pytest.raises(ValueError, match="kernel_block"):
        admm_iterate_cuda_shared(QPSolverParams(polish=False, kernel_block=9), *args)
    n = m = 160
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    big = [z(n, n), z(m, n), z(n, n), z(2, n), z(2, m), z(2, m), z(m), z(n), z(m), z(),
           z(2, m), z(2, m), z(2, n), z(2, m), z(2, m),
           torch.zeros(2, dtype=torch.int32, device=dev)]
    with pytest.raises(ValueError, match="cannot hold"):
        admm_iterate_cuda_shared(prm, *big)
    assert admm_iterate_cuda_shared.launches == 0


# pres and dres, the last check's unscaled residuals as the kernels return
# them, against the plain version's: each is an f32 max-norm of a difference
# of products (A x - z; P x + q + A' y) whose terms are larger than it, so it
# carries their rounding and not its own.  Untouched members hold inf in both.
RES_ATOL, RES_RTOL = 1e-3, 1e-2


@pytest.mark.parametrize("n,m,block", SHAPES)
def test_kernel_groups_freeze_members_and_mask_a_ragged_tail(dev, n, m, block):
    """A fleet large enough for the widest group a block of ``block``
    problems allows (2 problems a warp), with B
    not a multiple of the group and two members of one group starting
    stopped: with stopping disabled the iterates match the plain version
    within 1e-3 after 40 iterations (the bound of the test above) and the
    returned residuals within RES_ATOL + RES_RTOL of their size, the
    stopped members come back untouched and the last, partial group is
    right; with stopping on, statuses agree for all but 0.1% of members."""
    B = 4099
    P = shared_plan(B, n, m, block)[0]
    assert P == min(block, 2)
    args = _inputs(n, m, B, seed=n + m, dev=dev)
    stopped = [20, 21]  # one group
    for s in stopped:
        args[15][s] = int(QPSolutionStatus.DualInfeasible)
        args[12][s] = 3.0
    kw = dict(polish=False, rho=2.0, rho_eq_scale=15.0, stop_check_iter=10, backend="cuda",
              kernel_block=block)
    prm = QPSolverParams(max_iter=40, eps_abs=0.0, eps_rel=0.0, eps_primal_inf=0.0,
                         eps_dual_inf=0.0, **kw)
    k = admm_iterate_cuda_shared(prm, *args)
    r = admm_iterate_reference(prm, *args)
    torch.cuda.synchronize()
    assert torch.equal(k[3], r[3]) and torch.equal(k[4], r[4])
    assert int((k[3] == QPSolutionStatus.MaxIterations).sum()) == B - 3
    for kt, rt in zip(k[:3], r[:3]):
        torch.testing.assert_close(kt, rt, atol=1e-3, rtol=1e-3)
    for kt, rt in zip(k[5:], r[5:]):
        torch.testing.assert_close(kt, rt, atol=RES_ATOL, rtol=RES_RTOL)
    for s in stopped + [1]:
        assert int(k[4][s]) == 0 and float(k[5][s]) == float("inf")
        for out, start in zip(k[:3], args[12:15]):
            assert torch.equal(out[s], start[s])
    prm = QPSolverParams(max_iter=1500, **kw)
    k = admm_iterate_cuda_shared(prm, *args)
    r = admm_iterate_reference(prm, *args)
    torch.cuda.synchronize()
    assert float((k[3] == r[3]).float().mean()) >= 0.999
    assert int(k[3][B - 1]) == int(r[3][B - 1])
    ki, ri = float(k[4].float().mean()), float(r[4].float().mean())
    assert abs(ki - ri) <= 0.02 * ri


def test_solver_cuda_backend_goes_through_kernel(dev):
    """solve_qp_batch on backend="cuda" with shared factors launches the
    kernel once and agrees with backend="torch" on statuses."""
    rng = np.random.default_rng(3)
    n, m, B = 20, 20, 256
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + np.eye(n)
    A = np.eye(m, n)
    q = rng.standard_normal((B, n))
    l, u = -np.ones((B, m)), np.ones((B, m))
    kw = dict(device=dev, dtype=torch.float32)
    qps = qp_from_numpy((P[None], q, A[None], l, u), **kw)
    prm_c = QPSolverParams(polish=False, backend="cuda", max_iter=500)
    prm_t = QPSolverParams(polish=False, backend="torch", max_iter=500)
    f = qp_factorize(qp_from_numpy((P[None], q[:1], A[None], l[:1], u[:1]), **kw), prm_c)
    f = type(f)(*(a[0] for a in f))
    admm_iterate_cuda_shared.launches = 0
    sc = solve_qp_batch(qps, prm_c, None, f)
    st = solve_qp_batch(qps, prm_t, None, f)
    assert admm_iterate_cuda_shared.launches == 1
    assert float((sc.status == st.status).float().mean()) >= 0.99
    assert bool((sc.status == 0).all())


# ------------------------------------------------------ per-problem kernel


def _problem_inputs(n, m, B, seed, dev, prm):
    """Per-problem kernel inputs for problem_family, scaled and factorized
    in f64 by the port on the CPU and cast to f32; member 1 starts
    PrimalInfeasible."""
    qp = qp_from_numpy(problem_family(n, m, B, seed), device="cpu")
    args = [a.to(dev) for a in per_problem_kernel_args(qp, prm=prm)]
    args[15][1] = int(QPSolutionStatus.PrimalInfeasible)
    return args


PROBLEM_SHAPES = [
    (7, 9, 500),  # fewer rows and columns than a warp
    (64, 64, 256),
    (163, 99, 256),  # the per-member-clock vehicle fleet's QP
    (600, 600, 8),  # streamed from device memory; vectors beyond 48 KB of shared memory
    (218, 20, 16),  # the largest n at m = 20 that stays resident in shared memory
    (219, 20, 16),  # one more column: streamed
]


@pytest.mark.parametrize("n,m,B", PROBLEM_SHAPES)
def test_problem_kernel_iterates_match_plain_version(dev, n, m, B):
    """With stopping disabled (all tolerances 0) both run exactly 20
    iterations, so the iterates compare directly: within 1e-3 (f32 with
    another summation order and FMA contraction), and so do the residuals
    of the last check (within RES_ATOL + RES_RTOL of their size).  The
    shapes lie on both sides of the residency limit."""
    assert problem_route(n, m)[0] == ("resident" if n <= 218 else "streaming")
    prm = QPSolverParams(polish=False, max_iter=20, stop_check_iter=10, eps_abs=0.0,
                         eps_rel=0.0, eps_primal_inf=0.0, eps_dual_inf=0.0, backend="cuda")
    args = _problem_inputs(n, m, B, seed=n + m, dev=dev, prm=prm)
    # the dual-infeasible member's certificate holds even at tolerance 0
    args[15][4] = int(QPSolutionStatus.DualInfeasible)
    k = admm_iterate_cuda(prm, *args)
    r = admm_iterate_reference(prm, *args)
    torch.cuda.synchronize()
    assert torch.equal(k[3], r[3]) and torch.equal(k[4], r[4])
    run = torch.ones(B, dtype=torch.bool, device=dev)
    run[[1, 4]] = False
    assert bool((k[3][run] == QPSolutionStatus.MaxIterations).all())
    for kt, rt in zip(k[:3], r[:3]):
        torch.testing.assert_close(kt[run], rt[run], atol=1e-3, rtol=1e-3)
    for kt, rt in zip(k[5:], r[5:]):
        torch.testing.assert_close(kt, rt, atol=RES_ATOL, rtol=RES_RTOL)


@pytest.mark.parametrize("n,m,B", PROBLEM_SHAPES[:3])
@pytest.mark.parametrize("stop_check_iter", [1, 10])
def test_problem_kernel_statuses_match_plain_version(dev, n, m, B, stop_check_iter):
    """With the stopping check on: statuses agree for all but 0.1% of
    members (all members when B < 1000; at 600x600 even the f32 and f64
    plain versions split on the primal-infeasible member, so that shape
    runs only the fixed-iteration test), mean iteration counts within 2%,
    the kernel matches an f64 plain run's iteration counts within 5 points
    as often as the f32 plain version does (the bound of the shared kernel's
    test, for the same f32 rounding at a check's threshold); where iteration
    counts agree the iterates of members with a bounded solution are within
    1e-3; every certificate fires on
    its member; the member that started PrimalInfeasible comes back
    untouched; the kernel launched once."""
    prm = QPSolverParams(polish=False, max_iter=1500, stop_check_iter=stop_check_iter,
                         backend="cuda")
    args = _problem_inputs(n, m, B, seed=n + m, dev=dev, prm=prm)
    admm_iterate_cuda.launches = 0
    k = admm_iterate_cuda(prm, *args)
    assert admm_iterate_cuda.launches == 1
    r = admm_iterate_reference(prm, *args)
    d = admm_iterate_reference(prm, *(a.double() if a.is_floating_point() else a for a in args))
    torch.cuda.synchronize()
    assert int((k[3] != r[3]).sum()) <= int(0.001 * B)
    ki, ri = float(k[4].float().mean()), float(r[4].float().mean())
    assert abs(ki - ri) <= 0.02 * ri
    eq_iters = lambda a, b: float((a[4] == b[4]).float().mean())
    assert eq_iters(k, d) >= eq_iters(r, d) - 0.05
    # a dual-infeasible member's iterates run off along a ray (|x| ~ 1e6
    # here), where f32 rounding alone exceeds any absolute bound
    same = (k[3] == r[3]) & (k[4] == r[4]) & (k[3] != QPSolutionStatus.DualInfeasible)
    for kt, rt in zip(k[:3], r[:3]):
        torch.testing.assert_close(kt[same], rt[same], atol=1e-3, rtol=0)
    st = k[3].tolist()
    assert st[1] == QPSolutionStatus.PrimalInfeasible and int(k[4][1]) == 0
    assert torch.equal(k[0][1], args[12][1]) and float(k[5][1]) == float("inf")
    assert st[3] == QPSolutionStatus.PrimalInfeasible and int(k[4][3]) > 0
    assert st[4] == QPSolutionStatus.DualInfeasible
    assert float((k[3] == QPSolutionStatus.Optimal).float().mean()) >= 0.95


def test_problem_kernel_refuses_bad_inputs(dev):
    """Wrong dtype, shape, device or contiguity, and vectors beyond one
    block's shared memory, raise before any launch."""
    prm = QPSolverParams(polish=False, backend="cuda")
    args = _problem_inputs(7, 9, 6, seed=0, dev=dev, prm=prm)
    admm_iterate_cuda.launches = 0
    for i, bad in ((3, args[3].double()), (0, args[0][:, :, :-1]), (3, args[3].cpu()),
                   (1, args[1].transpose(1, 2).contiguous().transpose(1, 2)),
                   (9, args[9][:1])):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises((TypeError, ValueError)):
            admm_iterate_cuda(prm, *wrong)
    with pytest.raises(ValueError):  # per-problem matrices to the shared kernel
        admm_iterate_cuda_shared(prm, *args)
    n = m = 3000  # 252 KB of vectors
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    big = [z(1, n, n), z(1, m, n), z(1, n, n), z(1, n), z(1, m), z(1, m), z(1, m), z(1, n),
           z(1, m), z(1), z(1, m), z(1, m), z(1, n), z(1, m), z(1, m),
           torch.zeros(1, dtype=torch.int32, device=dev)]
    with pytest.raises(ValueError, match="cannot hold"):
        admm_iterate_cuda(prm, *big)
    assert admm_iterate_cuda.launches == 0


def test_solver_per_problem_route_goes_through_kernel(dev):
    """solve_qp_batch on backend="cuda" without factors (and with
    per-problem factors) launches the per-problem kernel once and agrees
    with backend="torch" on statuses; per_problem_kernel_args hands the
    kernel what the solver does."""
    qp = qp_from_numpy(problem_family(20, 15, 256, seed=9), device=dev, dtype=torch.float32)
    prm_c = QPSolverParams(polish=False, backend="cuda", max_iter=1000)
    prm_t = QPSolverParams(polish=False, backend="torch", max_iter=1000)
    admm_iterate_cuda.launches = 0
    sc = solve_qp_batch(qp, prm_c)
    assert admm_iterate_cuda.launches == 1
    st = solve_qp_batch(qp, prm_t)
    assert float((sc.status == st.status).float().mean()) >= 0.99
    f = qp_factorize(qp, prm_c)
    sf = solve_qp_batch(qp, prm_c, None, f)
    assert admm_iterate_cuda.launches == 2
    assert torch.equal(sf.status, sc.status) and torch.equal(sf.iters, sc.iters)
    k = admm_iterate_cuda(prm_c, *per_problem_kernel_args(qp, f, None, prm_c))
    torch.cuda.synchronize()
    assert torch.equal(k[3], sc.status) and torch.equal(k[4], sc.iters)
    torch.testing.assert_close(f.sx * k[0], sc.primal, rtol=0, atol=0)


# ------------------------------------------ the state-estimation slice


@pytest.mark.parametrize("name", ["SE(2)", "SO(3)"])
def test_ekf_fleet_forms_on_card_match_cpu_f64(dev, name):
    """benchmarks/ekf_bench.py's fleets on the card (B = 4096, float32): 3
    chained predict + update steps of the fleet, the square-root fleet and
    the vmap layout from the same states and noise stay within
    chip_smoke.EKF_TOL of the CPU float64 port (g through rminus, and P)."""
    from torch.func import vmap

    from chip_smoke import EKF_B, EKF_TOL, ekf_diff, ekf_layouts, ekf_problem

    lay = ekf_layouts(*ekf_problem(name, dev))
    lay_c = ekf_layouts(*ekf_problem(name, "cpu", torch.float64))
    G = ekf_problem(name, "cpu", torch.float64)[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    g0 = vmap(G.exp)(0.2 * torch.randn((EKF_B, G.ndof), generator=gen, device=dev))
    noise = 0.05 * torch.randn((3, EKF_B, G.ndof), generator=gen, device=dev)
    for lname, (reset, step, cov) in lay.items():
        reset_c, step_c, cov_c = lay_c[lname]
        s, sc = reset(g0), reset_c(g0.double().cpu())
        for k in range(3):
            s, sc = step(s, noise[k]), step_c(sc, noise[k].double().cpu())
        torch.cuda.synchronize()
        card = type(s)(*(a.double().cpu() for a in s))
        dg, dP = ekf_diff(G, card, sc, cov_c, cov_c)
        assert dg <= EKF_TOL and dP <= EKF_TOL, (lname, dg, dP)


def test_problem_kernel_at_output_feedback_shapes(dev):
    """The per-problem kernel at the output-feedback loop's shapes, B = 1:
    the MPC QP (sparse, K = 30, n = m = 262, streamed) and the ASIF QP
    (n = 3, m = 53), transcribed on the card at the loop's start.  With
    every tolerance 0, 20 iterations of kernel and plain version agree
    within chip_smoke's fixed-iteration bound (ITER_TOL of each vector's
    scale plus twice the f32 plain version's distance from an f64 run: the
    MPC's dynamics rows are equalities at rho = 100, so y carries ~3e-3 of
    f32 rounding after 20 iterations; the ASIF from a seeded random
    iterate, since its cold start can be exact); with the loop's
    settings both return the same status after the same count, and the
    kernel launched once a solve."""
    import dataclasses

    from chip_smoke import ITER_TOL, OF_DT, output_feedback_path, output_feedback_start
    from smooth_feedback_tpu_torch.controllers import asif_to_qp
    from smooth_feedback_tpu_torch.qp import QuadraticProgram

    p = output_feedback_path(dev)
    _, est = output_feedback_start(p)
    mq = p["mpc"].transcribe(torch.tensor(OF_DT, device=dev), est.g)
    aprm, fl = p["aprm"], p["fl"]
    aq = asif_to_qp(p["X"], p["U"], aprm.asif, aprm.T, est.g,
                    torch.tensor([0.3, -0.4], device=dev), fl["W_u"], fl["ulim"], p["f"],
                    fl["h"], fl["bu"])
    prm = aprm.qp
    zero = dataclasses.replace(prm, eps_abs=0.0, eps_rel=0.0, eps_primal_inf=0.0,
                               eps_dual_inf=0.0, max_iter=20)
    for (n, m), qp in (((262, 262), mq), ((3, 53), aq)):
        qps = QuadraticProgram(*(a[None] for a in qp))
        assert tuple(qps.A.shape[1:]) == (m, n)
        args = list(per_problem_kernel_args(qps, None, None, prm))
        admm_iterate_cuda.launches = 0
        k, r = admm_iterate_cuda(prm, *args), admm_iterate_reference(prm, *args)
        torch.cuda.synchronize()
        assert admm_iterate_cuda.launches == 1
        assert torch.equal(k[3], r[3]) and torch.equal(k[4], r[4])
        if n == 3:
            rng = np.random.default_rng(0)
            for i in (12, 13, 14):
                args[i] = torch.as_tensor(0.1 * rng.standard_normal(tuple(args[i].shape)),
                                          dtype=torch.float32, device=dev)
        k, r = admm_iterate_cuda(zero, *args), admm_iterate_reference(zero, *args)
        d = admm_iterate_reference(zero, *(a.double() if a.is_floating_point() else a
                                           for a in args))
        torch.cuda.synchronize()
        assert int(k[4][0]) == int(r[4][0]) == 20
        for kt, rt, dt in zip(k[:3], r[:3], d[:3]):
            floor = float((rt.double() - dt).abs().max())
            scale = max(1.0, float(dt.abs().max()))
            assert float((kt - rt).abs().max()) <= ITER_TOL * scale + 2 * floor


def test_problem_kernel_at_ocp_sweep_shape(dev):
    """The per-problem kernel at the SE(2) OCP sweep's subproblem shape
    (n = 112, m = 224, B = 64; resident in shared memory) on
    problem_family: 20 fixed iterations within chip_smoke's bound (ITER_TOL
    of each vector's scale plus twice the f32 plain version's distance from
    an f64 run), then a solve with the sweep's inner settings where both
    return the same statuses and the kernel matches an f64 run's counts at
    least as often as the f32 plain version does, less half a point
    (chip_smoke.compare_with_plain's rule: at eps 1e-6 an f32 solve stops
    at whichever check its rounding passes first)."""
    import dataclasses

    from chip_smoke import ITER_TOL, OCP_QP_SHAPE, ocp_sweep_params

    n, m = OCP_QP_SHAPE
    assert problem_route(n, m)[0] == "resident"
    prm = ocp_sweep_params("cuda").qp
    args = _problem_inputs(n, m, 64, seed=3, dev=dev, prm=prm)
    zero = dataclasses.replace(prm, eps_abs=0.0, eps_rel=0.0, eps_primal_inf=0.0,
                               eps_dual_inf=0.0, max_iter=20)
    # the dual-infeasible member's certificate holds even at tolerance 0
    args[15][4] = int(QPSolutionStatus.DualInfeasible)
    run = torch.ones(64, dtype=torch.bool, device=dev)
    run[[1, 4]] = False
    k, r = admm_iterate_cuda(zero, *args), admm_iterate_reference(zero, *args)
    d = admm_iterate_reference(zero, *(a.double() if a.is_floating_point() else a for a in args))
    torch.cuda.synchronize()
    assert bool((k[4][run] == 20).all()) and bool((r[4][run] == 20).all())
    for kt, rt, dt in zip(k[:3], r[:3], d[:3]):
        floor = float((rt.double() - dt).abs().max())
        scale = max(1.0, float(dt.abs().max()))
        assert float((kt - rt).abs().max()) <= ITER_TOL * scale + 2 * floor
    k, r = admm_iterate_cuda(prm, *args), admm_iterate_reference(prm, *args)
    d = admm_iterate_reference(prm, *(a.double() if a.is_floating_point() else a for a in args))
    torch.cuda.synchronize()
    assert torch.equal(k[3], r[3])
    share = lambda a, b: float((a[4] == b[4]).float().mean())
    assert share(k, r) >= 0.995 or share(k, d) >= share(r, d) - 0.005


def test_problem_kernel_at_refined_ocp_shape(dev):
    """The per-problem kernel at the refinement fleet's second-pass
    subproblem shape (chip_smoke.OCP_REFINED_QP_SHAPE, B = 64; streamed
    from device memory) on problem_family, under the same rules as at the
    sweep's shape: 20 fixed iterations within chip_smoke's bound, then a
    solve with the sweep's inner settings where both return the same
    statuses and counts match an f64 run's in as many members as the f32
    plain version's do, less max(1, B / 32) (chip_smoke.compare_with_plain's
    rule for such solves: at eps 1e-6 an f32 solve stops at whichever check
    its rounding passes first, and at this shape the statuses split too)."""
    import dataclasses

    from chip_smoke import ITER_TOL, OCP_REFINED_QP_SHAPE, ocp_sweep_params

    n, m = OCP_REFINED_QP_SHAPE
    assert problem_route(n, m)[0] == "streaming"
    prm = ocp_sweep_params("cuda").qp
    args = _problem_inputs(n, m, 64, seed=5, dev=dev, prm=prm)
    zero = dataclasses.replace(prm, eps_abs=0.0, eps_rel=0.0, eps_primal_inf=0.0,
                               eps_dual_inf=0.0, max_iter=20)
    args[15][4] = int(QPSolutionStatus.DualInfeasible)
    run = torch.ones(64, dtype=torch.bool, device=dev)
    run[[1, 4]] = False
    admm_iterate_cuda.launches = 0
    k, r = admm_iterate_cuda(zero, *args), admm_iterate_reference(zero, *args)
    d = admm_iterate_reference(zero, *(a.double() if a.is_floating_point() else a for a in args))
    torch.cuda.synchronize()
    assert admm_iterate_cuda.launches == 1
    assert bool((k[4][run] == 20).all()) and bool((r[4][run] == 20).all())
    for kt, rt, dt in zip(k[:3], r[:3], d[:3]):
        floor = float((rt.double() - dt).abs().max())
        scale = max(1.0, float(dt.abs().max()))
        assert float((kt - rt).abs().max()) <= ITER_TOL * scale + 2 * floor
    k, r = admm_iterate_cuda(prm, *args), admm_iterate_reference(prm, *args)
    d = admm_iterate_reference(prm, *(a.double() if a.is_floating_point() else a for a in args))
    torch.cuda.synchronize()
    same = lambda a, b, i: int((a[i] == b[i]).sum())
    allow = max(1, 64 // 32)
    what = (f"statuses kernel {k[3].tolist()}, plain {r[3].tolist()}, f64 {d[3].tolist()}; iters "
            f"kernel {k[4].tolist()}, plain {r[4].tolist()}, f64 {d[4].tolist()}")
    assert same(k, d, 3) >= same(r, d, 3) - allow, what
    assert same(k, d, 4) >= same(r, d, 4) - allow, what


def test_ocp_qp_round_trip_on_card(dev):
    """examples/ocp_se2_qp.py's round trip (chip_smoke.ocp_qp_run: ocp_to_qp,
    solve_qp with the example's parameters, qpsol_to_ocpsol) on the card:
    Optimal through one admm_problem launch, x(t) at the 6 sample times
    within 1e-4 of its scale plus twice the f32 noise of the torch route."""
    from chip_smoke import ocp_qp_run

    admm_iterate_cuda.launches = 0
    sol, xs, _ = ocp_qp_run(dev, "cuda")
    torch.cuda.synchronize()
    assert admm_iterate_cuda.launches == 1 and int(sol.status) == 0
    sol_t, xs_t, _ = ocp_qp_run(dev, "torch")
    sol_d, xs_d, _ = ocp_qp_run(dev, "torch", torch.float64)
    assert int(sol_t.status) == 0 and int(sol_d.status) == 0
    floor = float((xs_t.double() - xs_d).abs().max())
    scale = max(1.0, float(xs_d.abs().max()))
    assert float((xs - xs_t).abs().max()) <= 1e-4 * scale + 2 * floor


def test_shared_factors_past_the_kernel_run_the_torch_loop(dev):
    """Shared factors at n = m = 160 (past the shared kernel's MAX_DIM) on
    backend "cuda" with CUDA tensors: the torch shared loop runs on the
    card, nothing is launched, and statuses and iteration counts equal
    backend "torch"'s."""
    from chip_smoke import shared_route_problem
    from smooth_feedback_tpu_torch.qp import solver as qsolver
    from smooth_feedback_tpu_torch.qp.cuda_kernel import shared_kernel_fits

    qp = qp_from_numpy(shared_route_problem(), dev, torch.float32)
    assert not shared_kernel_fits(160, 160, 8)
    f = qp_factorize(qp._replace(q=qp.q[:1], l=qp.l[:1], u=qp.u[:1]))
    f = type(f)(*(a[0] for a in f))
    admm_iterate_cuda.launches = admm_iterate_cuda_shared.launches = 0
    falls = qsolver.shared_fallthroughs
    k = solve_qp_batch(qp, QPSolverParams(backend="cuda", polish=False), factors=f)
    assert admm_iterate_cuda.launches == admm_iterate_cuda_shared.launches == 0
    assert qsolver.shared_fallthroughs == falls + 1
    r = solve_qp_batch(qp, QPSolverParams(backend="torch", polish=False), factors=f)
    assert torch.equal(k.status, r.status) and torch.equal(k.iters, r.iters)
    assert bool((k.status == 0).all())


# ------------------------------------------------------------ the lane kernel


def _lane_args(n, m, B, dev, seed=0):
    """The lane kernel's float32 operands for B of benchmarks/qp_bench.py's
    random QPs (chip_smoke.lane_family, density 0.3), as solve_qp_batch on
    "lane" hands them over (the kernel scales and factorizes)."""
    from chip_smoke import lane_family
    from smooth_feedback_tpu_torch.qp import lane_kernel_args

    qp = qp_from_numpy(lane_family(n, m, B, 0.3, seed), device=dev, dtype=torch.float32)
    return qp, lane_kernel_args(qp)


def _f64(args):
    return tuple(a.double() if a is not None and a.dtype == torch.float32 else a for a in args)


def test_lane_kernel_fixed_iterations_match_plain_version(dev):
    """admm_lane at the ASIF's (3, 53), B = 256, adaptive rho off, every
    tolerance 0, 20 iterations from a seeded random warm start: every member
    runs them in both, the Ruiz sweeps equal; each scaled iterate within
    1e-4 of its scale plus twice the f32 plain version's distance from its
    f64 run (chip_smoke's bound), and so are the scalings."""
    from smooth_feedback_tpu_torch.qp import admm_solve_cuda_lane, admm_solve_lane_reference

    prm = QPSolverParams(polish=False, rho=0.02, max_iter=20, stop_check_iter=10, eps_abs=0.0,
                         eps_rel=0.0, eps_primal_inf=0.0, eps_dual_inf=0.0, backend="lane")
    _, args = _lane_args(3, 53, 256, dev)
    args = list(args)
    rng = np.random.default_rng(1)
    for i, k in ((5, 3), (6, 53)):  # the unscaled warm start
        args[i] = torch.as_tensor(0.1 * rng.standard_normal((256, k)), dtype=torch.float32,
                                  device=dev)
    admm_solve_cuda_lane.launches = 0
    k = admm_solve_cuda_lane(prm, *args, scaled=True)
    torch.cuda.synchronize()
    assert admm_solve_cuda_lane.launches == 1
    r = admm_solve_lane_reference(prm, *args)
    d = admm_solve_lane_reference(prm, *_f64(args))
    for o in (k, r):
        assert bool((o.status == QPSolutionStatus.MaxIterations).all() and (o.iters == 20).all())
    assert torch.equal(k.sweeps.cpu(), r.sweeps.cpu())
    for name in ("x", "z", "y", "c", "sx", "sy", "primal", "dual"):
        kt, rt, dt = getattr(k, name), getattr(r, name), getattr(d, name)
        floor = float((rt.double() - dt).abs().max())
        scale = max(1.0, float(dt.abs().max()))
        assert float((kt - rt).abs().max()) <= 1e-4 * scale + 2 * floor, name


@pytest.mark.parametrize("n,m,B,opts", [
    (3, 53, 256, dict(adaptive_rho=True, rho=0.02, max_iter=250, stop_check_iter=10)),  # the ASIF's
    (32, 256, 64, dict(adaptive_rho=True, max_iter=1000)),  # refactorizations at n = 32
    (96, 96, 64, dict(compensated_check=True, max_iter=4000)),
])
def test_lane_kernel_solves_match_plain_version(dev, n, m, B, opts):
    """Whole solves through admm_lane (scaling, factorization, loop and
    unscaling in one launch) against its plain version (f32, refactorizing
    the adapting members alone, as the kernel does) and its f64 run, by
    chip_smoke.lane_compare's rule: statuses equal to the f64 run's on as
    many members as the f32 plain version's, less max(1, B / 128).  Static
    rho: iteration counts equal to the f32 plain version's on 99.5 % of
    members, or as often equal to the f64 run's as the f32 plain version's
    (within half a point), and where they agree the unscaled primal within
    1e-4 of each member's scale plus twice the plain version's distance from
    f64.  Adaptive rho (discrete decisions from f32 residuals: two f32 runs
    take other rho paths to other points within eps): iteration and
    refactorization counts equal to the f64 run's on as many members as the
    f32 plain version's, less max(1, B / 32), and the kernel refactorized.
    Every member the kernel calls Optimal satisfies the stopping test in f64
    (1e-4 slack)."""
    from smooth_feedback_tpu_torch.qp import admm_solve_cuda_lane, admm_solve_lane_reference

    prm = QPSolverParams(polish=False, backend="lane", **opts)
    _, args = _lane_args(n, m, B, dev, seed=n + m)
    admm_solve_cuda_lane.launches = 0
    k = admm_solve_cuda_lane(prm, *args, scaled=True)
    torch.cuda.synchronize()
    assert admm_solve_cuda_lane.launches == 1
    r = admm_solve_lane_reference(prm, *args, member_refactor=True)
    d = admm_solve_lane_reference(prm, *_f64(args), member_refactor=True)
    assert int((k.status == d.status).sum()) >= int((r.status == d.status).sum()) - max(1, B // 128)
    share = lambda mask: float(mask.float().mean())
    if opts.get("adaptive_rho"):
        for name in ("iters", "refactors"):
            ko, ro, do = getattr(k, name), getattr(r, name), getattr(d, name)
            assert int((ko == do).sum()) >= int((ro == do).sum()) - max(1, B // 32), name
        assert int(k.refactors.sum()) > 0  # the kernel refactorized
    else:
        kr, kd, rd = share(k.iters == r.iters), share(k.iters == d.iters), share(r.iters == d.iters)
        assert kr >= 0.995 or (rd < 0.995 and kd >= rd - 0.005), (kr, kd, rd)
        xk, xr, xd = (o.primal.double() for o in (k, r, d))
        bound = 1e-4 * xd.abs().amax(dim=1).clamp(min=1.0) + 2 * (xr - xd).abs().amax(dim=1)
        assert bool(((xk - xr).abs().amax(dim=1) <= bound)[k.iters == r.iters].all())
    # the kernel's Optimal points (its own z, unscaled), re-checked in f64
    # on the unscaled data
    P, q, A = (a.double() for a in args[:3])
    x, z, y = k.primal.double(), k.z.double() / k.sy.double(), k.dual.double()
    Ax = torch.einsum("bmn,bn->bm", A, x)
    Px = torch.einsum("bij,bj->bi", P, x)
    Aty = torch.einsum("bmn,bm->bn", A, y)
    ninf = lambda v: v.abs().amax(dim=1)
    pres, dres = ninf(Ax - z), ninf(Px + q + Aty)
    ptol = prm.eps_abs + prm.eps_rel * torch.maximum(ninf(Ax), ninf(z)) + 1e-4
    dtol = prm.eps_abs + prm.eps_rel * torch.maximum(ninf(Px), torch.maximum(ninf(q), ninf(Aty))) + 1e-4
    opt = k.status == QPSolutionStatus.Optimal
    assert bool(opt.any()) and bool(((pres <= ptol) & (dres <= dtol))[opt].all())


def test_lane_plan_matches_the_library(dev):
    """lane_plan mirrors admm_lane_plan of the built library at the smoke's
    shapes and the boundary shapes, and n = m = 128 fits neither."""
    import ctypes

    from smooth_feedback_tpu_torch import _build
    from smooth_feedback_tpu_torch.qp.cuda_kernel import lane_fits, lane_plan

    lib = _build.load()
    out = (ctypes.c_int * 4)()
    for B, n, m in [(256, 3, 53), (256, 8, 8), (256, 32, 32), (256, 96, 96), (256, 3, 24),
                    (64, 32, 256), (1, 3, 53), (1, 2, 32), (4096, 3, 53), (4, 32, 1140),
                    (4, 105, 105), (4, 3, 3413)]:
        assert lib.admm_lane_plan(B, n, m, out) == 1
        assert tuple(out) == lane_plan(B, n, m)
    assert lib.admm_lane_plan(4, 128, 128, out) == 0 and not lane_fits(128, 128)


def test_lane_route_on_card(dev):
    """solve_qp_batch on "lane" with CUDA tensors: exactly one admm_lane
    launch and no Ruiz sweep in torch for a shape the kernel holds, cold,
    warm-started and from given factors, with polish off (the solution is
    the kernel's) and on (polish after the kernel's scaled iterates); the
    statuses and counts of that launch; for n = m = 128 the plain lane solve
    on the card, one lane_fallthroughs, nothing launched."""
    from smooth_feedback_tpu_torch.qp import admm_solve_cuda_lane, lane_kernel_args
    from smooth_feedback_tpu_torch.qp import solver as qsolver

    prm = QPSolverParams(max_iter=4000, polish=False, adaptive_rho=True, backend="lane")
    qp, args = _lane_args(3, 24, 256, dev, seed=5)
    sweeps = qsolver.lane_ruiz_sweeps
    admm_solve_cuda_lane.launches = 0
    sol = solve_qp_batch(qp, prm)
    torch.cuda.synchronize()
    assert admm_solve_cuda_lane.launches == 1 and qsolver.lane_ruiz_sweeps == sweeps
    k = admm_solve_cuda_lane(prm, *args)
    torch.cuda.synchronize()
    assert torch.equal(sol.status, k.status) and torch.equal(sol.iters, k.iters)
    assert torch.equal(sol.primal, k.primal) and torch.equal(sol.objective, k.objective)
    warm = solve_qp_batch(qp, prm, sol)
    fac = qp_factorize(qp, prm)
    given = solve_qp_batch(qp, dataclasses.replace(prm, adaptive_rho=False), None, fac)
    polished = solve_qp_batch(qp, dataclasses.replace(prm, polish=True))
    torch.cuda.synchronize()
    assert admm_solve_cuda_lane.launches == 5 and qsolver.lane_ruiz_sweeps == sweeps
    assert bool((warm.iters <= sol.iters).all()) and float((warm.status == 0).float().mean()) >= 0.99
    assert float((given.status == 0).float().mean()) >= 0.99
    assert float((polished.status == 0).float().mean()) >= 0.99
    assert admm_solve_cuda_lane(prm, *lane_kernel_args(qp, fac)).sweeps.eq(0).all()

    # a float64 batch runs the same float32 launch: the statuses and
    # iteration counts are the float32 solve's, polished or not
    qp64 = qp_from_numpy(lane_family(3, 24, 256, 0.3, 5), device=dev, dtype=torch.float64)
    admm_solve_cuda_lane.launches = 0
    sol64 = solve_qp_batch(qp64, prm)
    polished64 = solve_qp_batch(qp64, dataclasses.replace(prm, polish=True))
    torch.cuda.synchronize()
    assert admm_solve_cuda_lane.launches == 2 and qsolver.lane_ruiz_sweeps == sweeps
    assert sol64.primal.dtype == torch.float64
    assert torch.equal(sol64.status, sol.status) and torch.equal(sol64.iters, sol.iters)
    assert torch.equal(sol64.primal, sol.primal.double())
    assert torch.equal(polished64.iters, polished.iters)
    assert float((polished64.status == 0).float().mean()) >= 0.99

    qp = qp_from_numpy(lane_family(128, 128, 4, 0.3, 6), device=dev, dtype=torch.float32)
    falls = qsolver.lane_fallthroughs
    admm_solve_cuda_lane.launches = admm_iterate_cuda.launches = admm_iterate_cuda_shared.launches = 0
    sol = solve_qp_batch(qp, QPSolverParams(max_iter=4000, polish=False, backend="lane"))
    torch.cuda.synchronize()
    assert admm_solve_cuda_lane.launches == admm_iterate_cuda.launches == 0
    assert admm_iterate_cuda_shared.launches == 0
    assert qsolver.lane_fallthroughs == falls + 1
    assert bool(torch.isfinite(sol.primal).all())


def test_lane_kernel_clock_split(dev):
    """admm_lane's clock buffer: the member asked for writes its phase sums
    (every phase of a solve that factorizes, iterates, checks and adapts is
    non-negative and the loop's are positive) and its two iteration counts,
    which add up to its iterations and its checks."""
    from chip_smoke import n_checks
    from smooth_feedback_tpu_torch.qp import admm_solve_cuda_lane

    prm = QPSolverParams(max_iter=4000, polish=False, adaptive_rho=True, compensated_check=True,
                         backend="lane")
    _, args = _lane_args(3, 24, 256, dev, seed=5)
    k = admm_solve_cuda_lane(prm, *args)
    member = int(torch.argmax(k.iters))
    clocks = torch.zeros(8, dtype=torch.int64, device=dev)
    admm_solve_cuda_lane(prm, *args, clocks=clocks, clock_member=member)
    c = clocks.tolist()
    assert all(v >= 0 for v in c) and c[0] > 0 and c[1] > 0 and c[2] > 0 and c[3] > 0
    assert c[6] + c[7] == int(k.iters[member])
    assert c[7] == int(n_checks(k.iters[member:member + 1].cpu(), prm.stop_check_iter)[0])


def _sharded_lane_check(mesh, dev):
    """The lane backend's (3, 24) family with adaptive rho through
    _shard_map of solve_qp_batch: one admm_lane launch per shard, statuses,
    iteration counts and primal bit-equal to one unsharded launch (a warp
    owns a problem)."""
    from smooth_feedback_tpu_torch.parallel.mesh_utils import _shard_map
    from smooth_feedback_tpu_torch.qp import admm_solve_cuda_lane

    prm = QPSolverParams(max_iter=4000, polish=False, adaptive_rho=True, backend="lane")
    qp = qp_from_numpy(lane_family(3, 24, 256, 0.3, 5), device=dev, dtype=torch.float32)
    admm_solve_cuda_lane.launches = 0
    one = solve_qp_batch(qp, prm)
    sharded = _shard_map(lambda q: solve_qp_batch(q, prm), mesh, (0,), 0)(qp)
    torch.cuda.synchronize()
    assert admm_solve_cuda_lane.launches == 1 + mesh.size
    assert [p.device for p in sharded.primal.parts] == list(mesh.devices)
    for name in ("status", "iters", "primal"):
        assert torch.equal(getattr(sharded, name).gather(dev), getattr(one, name)), name


def _sharded_fleet_check(mesh, dev, B=512, steps=3):
    """The condensed main path (K = 50, bench.py's solver settings) at a
    small B through make_sharded_fleet_step, one step built on each mesh
    device, ``steps`` closed-loop steps from a warm start (one unsharded
    step from the cold start first), the sharded warm start carried: one
    admm_shared launch per shard per step; statuses equal to the unsharded
    steps', iteration counts on at least 99 % of members (the transcription's
    f32 products at another batch size may round a member's residual to the
    other side of a check's threshold), u within chip_smoke's PRIMAL_TOL
    where the counts agree."""
    from chip_smoke import PRIMAL_TOL, make_main_path
    from smooth_feedback_tpu_torch.parallel import (
        make_sharded_fleet_step, shard_batch, shard_pytree,
    )
    from smooth_feedback_tpu_torch.parallel.mesh_utils import _shard_map

    built = {}
    for d in mesh.devices:
        if d not in built:
            built[d] = make_main_path("cuda", d)
    step, ws0 = built[dev]
    sharded_step = make_sharded_fleet_step([built[d][0].fleet_shared_t for d in mesh.devices],
                                           mesh)
    plant = lambda x, u: x + 0.05 * torch.stack([x[:, 1], u[:, 0]], dim=1)
    move = _shard_map(plant, mesh, (0, 0), 0)
    xs = torch.as_tensor(0.5 * np.random.default_rng(3).standard_normal((B, 2)),
                         dtype=torch.float32, device=dev)
    ws = type(ws0)(*(a.expand((B,) + a.shape).contiguous() for a in ws0))
    r = step.fleet_shared_t(ws, 0.0, xs)
    xs, ws = plant(xs, r.u), r.warmstart
    xs_s, ws_s = shard_batch(xs, mesh), shard_pytree(ws, mesh)
    for i in range(1, steps + 1):
        r = step.fleet_shared_t(ws, 0.05 * i, xs)
        admm_iterate_cuda_shared.launches = 0
        rs = sharded_step(ws_s, 0.05 * i, xs_s)
        torch.cuda.synchronize()
        assert admm_iterate_cuda_shared.launches == mesh.size
        assert torch.equal(rs.status.gather(dev), r.status)
        same = rs.warmstart.iters.gather(dev) == r.warmstart.iters
        assert float(same.float().mean()) >= 0.99
        assert float((rs.u.gather(dev) - r.u).abs()[same].max()) <= PRIMAL_TOL
        xs, ws = plant(xs, r.u), r.warmstart
        xs_s, ws_s = move(xs_s, rs.u), rs.warmstart


def test_sharded_lane_solve_on_one_card(dev):
    """Four shards of a lane solve on one card, each on its own stream."""
    from smooth_feedback_tpu_torch.parallel import dp_mesh

    mesh = dp_mesh([dev] * 4)
    assert len(set(mesh.streams)) == 4
    _sharded_lane_check(mesh, dev)


def test_sharded_fleet_step_on_one_card(dev):
    """Four shards of the condensed fleet on one card, each on its own
    stream."""
    from smooth_feedback_tpu_torch.parallel import dp_mesh

    _sharded_fleet_check(dp_mesh([dev] * 4), dev)


def test_sharded_lane_and_fleet_on_two_cards(dev):
    """One shard on each of two cards, the fleet step built on each."""
    from smooth_feedback_tpu_torch.parallel import dp_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    mesh = dp_mesh([torch.device("cuda", 0), torch.device("cuda", 1)])
    _sharded_lane_check(mesh, dev)
    _sharded_fleet_check(mesh, dev)
