"""The PyTorch port's per-problem ADMM route against the JAX package, on the CPU.

The per-problem kernel (``csrc/admm_problem.cu``) runs only on the card; here
its plain version ``admm_iterate_reference`` (what ``admm_iterate_cuda`` runs
on CPU tensors) is held against the TPU kernel ``admm_iterate_pallas`` in
interpret mode, on the same float32 inputs made with numpy from a seed.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import problem_family
from smooth_feedback_tpu.qp import QPSolverParams as JParams
from smooth_feedback_tpu.qp import QuadraticProgram as JQP
from smooth_feedback_tpu.qp import solve_qp_batch as j_solve
from smooth_feedback_tpu.qp.pallas_kernel import admm_iterate_pallas
from smooth_feedback_tpu_torch import convert
from smooth_feedback_tpu_torch.qp import (
    QPSolutionStatus,
    QPSolverParams,
    admm_iterate_cuda,
    admm_iterate_reference,
    per_problem_kernel_args,
    qp_factorize,
    solve_qp_batch,
)

torch.set_num_threads(1)

# the port's entry points default to the card; these tests run on the CPU
qp_from_numpy = functools.partial(convert.qp_from_numpy, device="cpu")

PI = int(QPSolutionStatus.PrimalInfeasible)
DI = int(QPSolutionStatus.DualInfeasible)


def _family(seed):
    """chip_smoke.problem_family at n = 7, m = 9, B = 6: member 2 has a row
    unbounded above and one unbounded below, member 3 is primal infeasible,
    member 4 dual infeasible."""
    return problem_family(7, 9, 6, seed)


@pytest.mark.parametrize("stop_check_iter,max_iter", [(1, 300), (10, 300), (10, 12)])
def test_reference_matches_pallas_kernel(stop_check_iter, max_iter):
    """admm_iterate_reference (f32) against the Pallas per-problem kernel in
    interpret mode on the same f32 inputs: statuses and iterations equal;
    x, z, y within 1e-4 (f32 with another summation order) on every member
    with a bounded solution; each certificate fires; a member that starts
    PrimalInfeasible comes back untouched; the CUDA wrapper on CPU tensors
    gives the same result and launches nothing."""
    prm = QPSolverParams(polish=False, max_iter=max_iter, stop_check_iter=stop_check_iter,
                         backend="cuda")
    jprm = JParams(polish=False, max_iter=max_iter, stop_check_iter=stop_check_iter,
                   backend="pallas")
    qp = qp_from_numpy(_family(1))
    args = list(per_problem_kernel_args(qp, prm=prm))
    args[15][1] = PI  # comes back untouched
    jout = admm_iterate_pallas(jprm, *(jnp.asarray(a.numpy()) for a in args), interpret=True)
    tout = admm_iterate_reference(prm, *args)
    status = tout[3].numpy()
    np.testing.assert_array_equal(status, np.asarray(jout[3]))
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
    bounded = status != DI  # a dual-infeasible member's iterates run off along a ray
    for t, j in zip(tout[:3], jout[:3]):
        np.testing.assert_allclose(t.numpy()[bounded], np.asarray(j)[bounded], atol=1e-4, rtol=0)
    assert status[1] == PI and tout[4][1] == 0
    np.testing.assert_array_equal(tout[0][1].numpy(), args[12][1].numpy())
    if max_iter == 12:
        assert np.all(status[[0, 2, 5]] == QPSolutionStatus.MaxIterations)
    else:
        assert status[3] == PI and status[4] == DI
        assert np.all(status[[0, 2, 5]] == QPSolutionStatus.Optimal)

    admm_iterate_cuda.launches = 0
    wout = admm_iterate_cuda(prm, *args)
    assert admm_iterate_cuda.launches == 0
    for w, t in zip(wout, tout):
        torch.testing.assert_close(w, t, rtol=0, atol=0)


def test_solver_cuda_backend_matches_jax_pallas():
    """solve_qp_batch on backend="cuda" without factors (every member scaled
    and factorized in f64, the iterations in the kernel's plain version on
    CPU tensors) against the JAX package's backend="pallas" (the Pallas
    kernel in interpret mode): statuses and iterations equal, primal and dual
    within 1e-4 on members with a bounded solution, cold and warm-started."""
    arrs = _family(2)
    prm = QPSolverParams(polish=False, max_iter=500, stop_check_iter=5, backend="cuda")
    jprm = JParams(polish=False, max_iter=500, stop_check_iter=5, backend="pallas")
    jqp = JQP(*(jnp.asarray(a) for a in arrs))
    js = j_solve(jqp, jprm)
    ts = solve_qp_batch(qp_from_numpy(arrs), prm)
    js2 = j_solve(jqp, jprm, js)
    ts2 = solve_qp_batch(qp_from_numpy(arrs), prm, ts)
    for j, t in ((js, ts), (js2, ts2)):
        status = t.status.numpy()
        np.testing.assert_array_equal(status, np.asarray(j.status))
        np.testing.assert_array_equal(t.iters.numpy(), np.asarray(j.iters))
        ok = status == QPSolutionStatus.Optimal
        assert ok.sum() >= 4
        for a, b in ((t.primal, j.primal), (t.dual, j.dual)):
            np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], atol=1e-4, rtol=0)
    assert ts.status[3] == PI and ts.status[4] == DI


def test_per_problem_kernel_args_are_what_the_solver_hands_the_kernel():
    """per_problem_kernel_args, with or without factors and warm start, gives
    the kernel what solve_qp_batch on backend="cuda" gives it: the plain
    version on those arguments, unscaled, equals the solver's solution
    exactly (CPU tensors); shared factors are refused."""
    qp = qp_from_numpy(_family(4), dtype=torch.float32)
    prm = QPSolverParams(polish=False, max_iter=300, backend="cuda")
    f = qp_factorize(qp, prm)
    cold = solve_qp_batch(qp, prm)
    for factors, ws in ((None, None), (f, None), (None, cold), (f, cold)):
        sol = solve_qp_batch(qp, prm, ws, factors)
        x, z, y, status, iters, pres, dres = admm_iterate_reference(
            prm, *per_problem_kernel_args(qp, factors, ws, prm)
        )
        torch.testing.assert_close(sol.primal, f.sx * x, rtol=0, atol=0)
        torch.testing.assert_close(sol.dual, f.sy * y / f.c[:, None], rtol=0, atol=0)
        assert torch.equal(sol.status, status) and torch.equal(sol.iters, iters)
    shared = type(f)(*(a[0] for a in f))
    with pytest.raises(ValueError, match="per-problem"):
        per_problem_kernel_args(type(qp)(*(a[:1] for a in qp)), shared)


@pytest.mark.parametrize(
    "n,m,route",
    [
        (163, 99, "resident"),  # the per-member-clock vehicle fleet's QP
        (64, 64, "resident"),
        (218, 20, "resident"),  # the largest n at m = 20 that fits
        (219, 20, "streaming"),
        (600, 600, "streaming"),
    ],
)
def test_problem_route(n, m, route):
    """The per-problem kernel's route by size alone: Minv, As and the
    vectors resident when they fit one block's shared memory, the vectors
    alone otherwise."""
    from smooth_feedback_tpu_torch.qp.cuda_kernel import (
        PROBLEM_STATIC_SMEM, SMEM_LIMIT, problem_route, problem_smem_bytes,
    )

    got, smem = problem_route(n, m)
    assert got == route
    assert smem == problem_smem_bytes(n, m) and smem + PROBLEM_STATIC_SMEM <= SMEM_LIMIT
    vectors = 4 * (10 * n + 15 * m)
    assert smem >= vectors + (4 * (n * n + m * n) if route == "resident" else 0)


def test_problem_wrapper_rejects_bad_inputs():
    """The per-problem wrapper checks dtype, shape and what one block's
    shared memory holds before it runs anything."""
    prm = QPSolverParams(polish=False, backend="cuda")
    args = list(per_problem_kernel_args(qp_from_numpy(_family(3)),
                                        prm=prm))
    for i, bad in ((3, args[3].double()), (0, args[0][:, :-1]), (9, args[9][:2]),
                   (6, args[6][0])):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises((TypeError, ValueError)):
            admm_iterate_cuda(prm, *wrong)
    n = m = 3000  # vectors beyond 227 KB
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    big = [z(1, n, n), z(1, m, n), z(1, n, n), z(1, n), z(1, m), z(1, m), z(1, m), z(1, n),
           z(1, m), z(1), z(1, m), z(1, m), z(1, n), z(1, m), z(1, m),
           torch.zeros(1, dtype=torch.int32)]
    with pytest.raises(ValueError, match="cannot hold"):
        admm_iterate_cuda(prm, *big)
