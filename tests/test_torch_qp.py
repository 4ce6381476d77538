"""The PyTorch port's QP solver and shared-matrix kernel module against the
JAX package (the reference), on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The JAX
side runs as the JAX tests run it here: float64 through ``backend="xla"``,
and the Pallas kernel in interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smooth_feedback_tpu.qp import QPSolverParams as JParams
from smooth_feedback_tpu.qp import QuadraticProgram as JQP
from smooth_feedback_tpu.qp import qp_factorize as j_factorize
from smooth_feedback_tpu.qp import solve_qp_batch as j_solve
from smooth_feedback_tpu.qp import warmstart_like as j_warmstart_like
from smooth_feedback_tpu.qp.pallas_kernel import admm_iterate_pallas_shared
from smooth_feedback_tpu_torch import convert
from smooth_feedback_tpu_torch.qp import (
    QPSolutionStatus,
    QPSolverParams,
    admm_iterate_cuda_shared,
    admm_iterate_reference,
    qp_factorize,
    shared_kernel_args,
    solve_qp,
    solve_qp_batch,
    warmstart_like,
)

torch.set_num_threads(1)

# the port's entry points default to the card; these tests run on the CPU
qp_from_numpy = functools.partial(convert.qp_from_numpy, device="cpu")
factors_from_numpy = functools.partial(convert.factors_from_numpy, device="cpu")
solution_from_numpy = functools.partial(convert.solution_from_numpy, device="cpu")


def _random_qp(rng, n, m):
    """Random feasible QP in the style of the JAX package's random_qp."""
    M = rng.standard_normal((n, n))
    P = M @ M.T
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    center = A @ rng.standard_normal(n)
    spread = np.abs(rng.standard_normal(m)) + 0.1
    return P, q, A, center - spread, center + spread


def _batch(rng, B, n, m):
    qps = [_random_qp(rng, n, m) for _ in range(B)]
    P, q, A, l, u = (np.stack(f) for f in zip(*qps))
    # member 1: one unbounded-above and one unbounded-below row
    u[1, 0] = np.inf
    l[1, 1] = -np.inf
    # member 2: infeasible by certificate (x0 >= 1 and x0 <= -1)
    A[2, 0] = 0.0
    A[2, 0, 0] = 1.0
    A[2, 1] = 0.0
    A[2, 1, 0] = 1.0
    l[2, 0], u[2, 0] = 1.0, np.inf
    l[2, 1], u[2, 1] = -np.inf, -1.0
    return P, q, A, l, u


def _jqp(arrs):
    return JQP(*(jnp.asarray(a) for a in arrs))


def _assert_same_solution(js, ts, atol):
    """Statuses and iteration counts equal; primal and dual within atol."""
    np.testing.assert_array_equal(np.asarray(js.status), ts.status.numpy())
    np.testing.assert_array_equal(np.asarray(js.iters), ts.iters.numpy())
    np.testing.assert_allclose(ts.primal.numpy(), np.asarray(js.primal), atol=atol, rtol=0)
    np.testing.assert_allclose(ts.dual.numpy(), np.asarray(js.dual), atol=atol, rtol=0)


def test_solve_per_problem_factors_f64():
    """Per-problem factors, f64: statuses and iterations equal, primal and
    dual within 1e-9 (both sides f64; only the summation order differs)."""
    arrs = _batch(np.random.default_rng(0), B=5, n=7, m=9)
    jp = JParams(polish=False, max_iter=2000)
    tp = QPSolverParams(polish=False, max_iter=2000)
    js = j_solve(_jqp(arrs), jp)
    ts = solve_qp_batch(qp_from_numpy(arrs), tp)
    assert set(np.asarray(js.status).tolist()) >= {0, int(QPSolutionStatus.PrimalInfeasible)}
    _assert_same_solution(js, ts, 1e-9)
    np.testing.assert_allclose(ts.objective.numpy(), np.asarray(js.objective), atol=1e-9)

    # warm-started re-solve from the JAX solution, carried across
    js2 = j_solve(_jqp(arrs), jp, js)
    ts2 = solve_qp_batch(qp_from_numpy(arrs), tp, solution_from_numpy(js))
    _assert_same_solution(js2, ts2, 1e-9)


def _shared_problem(rng, n=7, m=9, B=5):
    P, q, A, l, u = _random_qp(rng, n, m)
    shift = 0.05 * rng.standard_normal((B, m))
    qs = q[None] + 0.1 * rng.standard_normal((B, n))
    lb = l[None] + shift
    ub = u[None] + shift
    lb[3, 2] = -np.inf  # a ±inf row in one member
    ub[3, 4] = np.inf
    return (P, q, A, l, u), (P[None], qs, A[None], lb, ub)


@pytest.mark.parametrize("stop_check_iter", [1, 25])
def test_solve_shared_factors_f64(stop_check_iter):
    """Shared factors from qp_factorize of one template, f64: the factor
    pieces within 1e-10, statuses and iterations equal, primal and dual
    within 1e-9."""
    tmpl, batch = _shared_problem(np.random.default_rng(1))
    jp = JParams(polish=False, max_iter=2000, stop_check_iter=stop_check_iter)
    tp = QPSolverParams(polish=False, max_iter=2000, stop_check_iter=stop_check_iter)
    jf = jax.tree.map(lambda a: a[0], j_factorize(jax.tree.map(lambda a: jnp.asarray(a)[None], JQP(*tmpl)), jp))
    tf = qp_factorize(qp_from_numpy([a[None] for a in tmpl]), tp)
    for name in ("c", "sx", "sy", "rho", "Minv"):
        np.testing.assert_allclose(
            getattr(tf, name)[0].numpy(), np.asarray(getattr(jf, name)), atol=1e-10, rtol=0,
            err_msg=name,
        )
    tf1 = factors_from_numpy([np.asarray(a) for a in jf])
    js = j_solve(_jqp(batch), jp, None, jf)
    ts = solve_qp_batch(qp_from_numpy(batch), tp, None, tf1)
    assert np.all(np.asarray(js.status) == 0)
    _assert_same_solution(js, ts, 1e-9)


def test_warmstart_like_matches_jax():
    """warmstart_like gives the JAX package's fields, shapes and values; a
    solve from it equals the cold solve exactly."""
    arrs = _batch(np.random.default_rng(4), B=3, n=4, m=5)
    jw = j_warmstart_like(_jqp(arrs))
    tw = warmstart_like(qp_from_numpy(arrs))
    assert tw._fields == jw._fields
    for t, j in zip(tw, jw):
        assert t.shape == j.shape and t.dtype == getattr(torch, str(j.dtype))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    prm = QPSolverParams(polish=False, max_iter=200)
    for a, b in zip(solve_qp_batch(qp_from_numpy(arrs), prm, tw),
                    solve_qp_batch(qp_from_numpy(arrs), prm)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_solve_qp_single_and_unported_options():
    """The unbatched wrapper solves a box QP, with and without polish (the
    default, which lands on the exact solution), also with verbose on; every
    option is ported now: backend="lane" solves it too (its plain loop on
    the CPU), and only an unknown backend raises."""
    qp = qp_from_numpy((np.eye(2), [-4.0, 0.25], np.eye(2), [-1.0, -1.0], [1.0, 1.0]))
    sol = solve_qp(qp, QPSolverParams(polish=False))
    assert int(sol.status) == QPSolutionStatus.Optimal
    np.testing.assert_allclose(sol.primal.numpy(), [1.0, -0.25], atol=1e-3)
    sol = solve_qp(qp)
    assert int(sol.status) == QPSolutionStatus.Optimal
    np.testing.assert_allclose(sol.primal.numpy(), [1.0, -0.25], atol=1e-12)
    loud = solve_qp(qp, QPSolverParams(polish=False, verbose=True))
    torch.testing.assert_close(loud.primal, solve_qp(qp, QPSolverParams(polish=False)).primal,
                               rtol=0, atol=0)
    lane = solve_qp(qp, QPSolverParams(polish=False, backend="lane"))
    assert int(lane.status) == QPSolutionStatus.Optimal
    np.testing.assert_allclose(lane.primal.numpy(), [1.0, -0.25], atol=1e-3)
    with pytest.raises(ValueError, match="unknown backend"):
        solve_qp(qp, QPSolverParams(polish=False, backend="pallas"))


# ------------------------------------------------------- kernel module, f32


@functools.lru_cache(maxsize=None)
def _di_condensed_template():
    """The condensed double-integrator tracking QP at K=8 (n = m = 8):
    ``(Pc, Ac)`` from the JAX package's one-time condensation (built once
    for all the cases that use it)."""
    from smooth_feedback_tpu.controllers import MPCParams, MPCWeights, make_mpc_step
    from smooth_feedback_tpu.controllers.mpc import _build_condensation
    from smooth_feedback_tpu.groups import Rn
    from smooth_feedback_tpu.ocp import OCP, variable_layout
    from smooth_feedback_tpu.ocp.collocation import Mesh

    xdes = lambda t: jnp.stack([-0.5 * jnp.sin(0.3 * t), -0.15 * jnp.cos(0.3 * t)])
    step, _ = make_mpc_step(
        Rn(2), Rn(1), lambda x, u: jnp.stack([x[1], u[0]]), xdes,
        lambda t: jnp.zeros(1),
        weights=MPCWeights(Q=jnp.eye(2), Qtf=0.1 * jnp.eye(2), R=0.1 * jnp.eye(1)),
        params=MPCParams(K=8, tf=5.0),
        cr=lambda x, u: u, crl=jnp.array([-0.5]), cru=jnp.array([0.5]),
        reuse_factors=True, condense=True,
    )
    qp0 = jax.jit(step.transcribe)(0.0, xdes(0.0))
    probe = OCP(X=Rn(2), U=Rn(1), theta=None, f=None, g=None, cr=None,
                crl=jnp.zeros(1), cru=jnp.zeros(1), ce=None,
                cel=jnp.zeros(2), ceu=jnp.zeros(2))
    lay = variable_layout(probe, Mesh.uniform(2, 4, Kmin=4, Kmax=4))
    cond = _build_condensation(qp0, lay, jnp.float64)
    return np.asarray(cond["Pc"]), np.asarray(cond["Ac"])


def _kernel_inputs(family, rng, B=6):
    """Scaled shared-kernel inputs (numpy f32) for a problem family."""
    prm = JParams(polish=False, rho=2.0, rho_eq_scale=15.0)
    if family == "random":
        tmpl, (_, qb, _, l, u) = _shared_problem(rng, B=B)
    else:
        Pc, Ac = _di_condensed_template()
        n, m = Pc.shape[0], Ac.shape[0]
        qb = rng.standard_normal((B, n))
        shift = 0.2 * rng.standard_normal((B, m))
        l = -0.5 - shift
        u = 0.5 - shift
        u[0, 3] = np.inf  # a ±inf row in one member
        tmpl = (Pc, np.zeros(n), Ac, np.full(m, -0.5), np.full(m, 0.5))
    jf = jax.tree.map(
        lambda a: np.asarray(a[0], np.float32),
        j_factorize(jax.tree.map(lambda a: jnp.asarray(a)[None], JQP(*tmpl)), prm),
    )
    c, sx, sy, rho = jf.c, jf.sx, jf.sy, jf.rho
    f = lambda a: np.asarray(a, np.float32)
    qs = f(c * sx[None] * qb)
    ls = f(sy[None] * l)
    us = f(sy[None] * u)
    x0 = f(0.3 * rng.standard_normal(qs.shape))
    z0 = f(np.clip(0.3 * rng.standard_normal(ls.shape), ls, us))
    y0 = f(0.1 * rng.standard_normal(ls.shape))
    status0 = np.full((B,), -1, np.int32)
    status0[1] = int(QPSolutionStatus.PrimalInfeasible)  # comes back untouched
    return (jf.Minv, jf.As, jf.Ps, qs, ls, us, rho, sx, sy, np.float32(c),
            f(l), f(u), x0, z0, y0, status0)


@pytest.mark.parametrize("family", ["random", "di_condensed"])
@pytest.mark.parametrize("stop_check_iter,max_iter", [(1, 300), (10, 300), (10, 12)])
def test_kernel_reference_matches_pallas(family, stop_check_iter, max_iter):
    """admm_iterate_reference (f32) against the Pallas kernel in
    interpret mode: statuses and iterations equal; x, z, y within 1e-4 (f32
    with a different summation order).  The CUDA wrapper on CPU tensors gives
    the same result and launches nothing."""
    args = _kernel_inputs(family, np.random.default_rng(2))
    jprm = JParams(polish=False, rho=2.0, rho_eq_scale=15.0, max_iter=max_iter,
                   stop_check_iter=stop_check_iter, backend="pallas")
    tprm = QPSolverParams(polish=False, rho=2.0, rho_eq_scale=15.0, max_iter=max_iter,
                          stop_check_iter=stop_check_iter, backend="cuda")
    jout = admm_iterate_pallas_shared(jprm, *(jnp.asarray(a) for a in args), interpret=True)
    targs = [torch.as_tensor(a) for a in args]
    tout = admm_iterate_reference(tprm, *targs)
    status = tout[3].numpy()
    np.testing.assert_array_equal(status, np.asarray(jout[3]))
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
    for t, j in zip(tout[:3], jout[:3]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=0)
    # the member that started PrimalInfeasible is untouched
    assert status[1] == QPSolutionStatus.PrimalInfeasible and tout[4][1] == 0
    np.testing.assert_array_equal(tout[0][1].numpy(), args[12][1])
    if max_iter == 12:
        assert np.any(status == QPSolutionStatus.MaxIterations)
    else:
        assert np.any(status == QPSolutionStatus.Optimal)

    admm_iterate_cuda_shared.launches = 0
    wout = admm_iterate_cuda_shared(tprm, *targs)
    assert admm_iterate_cuda_shared.launches == 0
    for w, t in zip(wout, tout):
        torch.testing.assert_close(w, t, rtol=0, atol=0)


def test_kernel_wrapper_rejects_bad_inputs():
    """The wrapper checks dtype, shape and what the kernel can hold."""
    args = [torch.as_tensor(a) for a in _kernel_inputs("random", np.random.default_rng(3))]
    prm = QPSolverParams(polish=False, backend="cuda")
    bad = list(args)
    bad[3] = bad[3].double()
    with pytest.raises(TypeError):
        admm_iterate_cuda_shared(prm, *bad)
    bad = list(args)
    bad[0] = bad[0][:, :-1]
    with pytest.raises(ValueError):
        admm_iterate_cuda_shared(prm, *bad)
    n = m = 1792  # past the JAX package's shared_kernel_fits, so past both routes
    big = [
        torch.zeros(s, dtype=torch.float32)
        for s in [(n, n), (m, n), (n, n), (2, n), (2, m), (2, m), (m,), (n,), (m,), (),
                  (2, m), (2, m), (2, n), (2, m), (2, m)]
    ]
    with pytest.raises(ValueError, match="cannot hold"):
        admm_iterate_cuda_shared(prm, *big, torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize(
    "B,n,m,block,plan",
    [
        (8192, 52, 52, 8, (2, 8, 4)),  # the condensed path: two problems a warp
        (1024, 52, 52, 8, (1, 8, 8)),  # too few problems for that: one a warp
        (600, 52, 52, 8, (1, 5, 5)),  # ... and a block on every SM before larger blocks
        (8192, 52, 52, 1, (1, 1, 1)),
        (8192, 128, 100, 4, (2, 4, 2)),  # four entries a lane
        (100, 7, 9, 8, (1, 1, 1)),
    ],
)
def test_shared_kernel_layout(B, n, m, block, plan):
    """The launch layout's Python mirror: problems a warp, problems and warps
    a block at the shapes the tests and the condensed path use, within one
    block's shared memory."""
    from smooth_feedback_tpu_torch.qp.cuda_kernel import SMEM_LIMIT, shared_plan, smem_bytes

    P, pb, warps, smem = shared_plan(B, n, m, block)
    assert (P, pb, warps) == plan
    assert smem == smem_bytes(n, m, block) <= SMEM_LIMIT
    assert warps * P <= max(pb, P) + P - 1 and smem >= 4 * ((n | 1) * (2 * n + m) + 64 * warps * P)


def test_shared_kernel_refuses_blocks_out_of_range():
    """kernel_block outside 1..8 raises before anything runs."""
    args = [torch.as_tensor(a) for a in _kernel_inputs("random", np.random.default_rng(3))]
    admm_iterate_cuda_shared.launches = 0
    for block in (0, 9):
        with pytest.raises(ValueError, match="kernel_block"):
            admm_iterate_cuda_shared(QPSolverParams(polish=False, kernel_block=block), *args)
    assert admm_iterate_cuda_shared.launches == 0


def test_sort_stragglers_is_exact():
    """sort_stragglers permutes the batch around the kernel by the warm
    start's iteration counts and inverts the permutation: the result equals
    the unsorted solve exactly (the kernel's plain version on CPU tensors)."""
    tmpl, batch = _shared_problem(np.random.default_rng(6), B=7)
    prm = QPSolverParams(polish=False, max_iter=300, backend="cuda")
    f = qp_factorize(qp_from_numpy([a[None] for a in tmpl], dtype=torch.float32), prm)
    f = type(f)(*(a[0] for a in f))
    qps = qp_from_numpy(batch, dtype=torch.float32)
    ws = solve_qp_batch(qps, prm, None, f)
    ws = ws._replace(iters=torch.tensor([50, 3, 20, 3, 90, 1, 7], dtype=torch.int32))
    plain = solve_qp_batch(qps, prm, ws, f)
    srt = solve_qp_batch(qps, QPSolverParams(polish=False, max_iter=300, backend="cuda",
                                             sort_stragglers=True), ws, f)
    for a, b in zip(plain, srt):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_shared_kernel_args_are_what_the_solver_hands_the_kernel():
    """shared_kernel_args, warm-started or not, gives the kernel what
    solve_qp_batch on backend="cuda" gives it: its plain version on those
    arguments, unscaled, equals the solver's solution exactly (CPU tensors)."""
    tmpl, batch = _shared_problem(np.random.default_rng(8), B=6)
    prm = QPSolverParams(polish=False, max_iter=300, backend="cuda")
    f = qp_factorize(qp_from_numpy([a[None] for a in tmpl], dtype=torch.float32), prm)
    f = type(f)(*(a[0] for a in f))
    qps = qp_from_numpy(batch, dtype=torch.float32)
    cold = solve_qp_batch(qps, prm, None, f)
    for ws in (None, cold):
        sol = solve_qp_batch(qps, prm, ws, f)
        x, z, y, status, iters, pres, dres = admm_iterate_reference(
            prm, *shared_kernel_args(qps, f, ws)
        )
        torch.testing.assert_close(sol.primal, f.sx * x, rtol=0, atol=0)
        torch.testing.assert_close(sol.dual, f.sy * y / f.c, rtol=0, atol=0)
        assert torch.equal(sol.status, status) and torch.equal(sol.iters, iters)
    assert bool((cold.status == 0).all())
    with pytest.raises(ValueError, match="shared"):
        shared_kernel_args(qps, qp_factorize(qps, prm))
