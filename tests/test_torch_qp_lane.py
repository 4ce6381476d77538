"""The port's lane backend (``backend="lane"``) against the JAX package's, on
the CPU: the plain batch-trailing loop with its scaling, factorization,
checks, certificates, refinement and adaptive rho; the lane kernel's plain
version and launch layout; and the dispatch rules.

Problems are made with numpy from a seed (tests/test_qp.py's families, at
small sizes) and handed to both packages.  Both run float64; the bar is the
ROADMAP's: statuses and iteration counts equal, primals within 1e-9.  Each
JAX program is compiled once and shared by the cases that need it.
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
from smooth_feedback_tpu_torch import convert
from smooth_feedback_tpu_torch.qp import (
    QPSolutionStatus,
    QPSolverParams,
    admm_iterate_cuda_lane,
    admm_iterate_lane_reference,
    lane_kernel_args,
    qp_factorize,
    solve_qp_batch,
)
from smooth_feedback_tpu_torch.qp import solver as qsolver
from smooth_feedback_tpu_torch.qp.cuda_kernel import (
    LANE_MAX_WARPS, SMEM_LIMIT, lane_fits, lane_plan, lane_problem_bytes,
)

torch.set_num_threads(1)

qp_from_numpy = functools.partial(convert.qp_from_numpy, device="cpu")


def _random_qp(rng, n, m):
    """tests/test_qp.py's random_qp: P = M M', bounds straddling A x0."""
    M = rng.standard_normal((n, n))
    A = rng.standard_normal((m, n))
    center = A @ rng.standard_normal(n)
    spread = np.abs(rng.standard_normal(m)) + 0.1
    return M @ M.T, rng.standard_normal(n), A, center - spread, center + spread


def _batch(seed, B, n, m, scale=1.0):
    rng = np.random.default_rng(seed)
    P, q, A, l, u = (np.stack(f) for f in zip(*(_random_qp(rng, n, m) for _ in range(B))))
    return scale * P, scale * q, A, l, u


def _family(seed, B=6, n=3, m=20):
    """A random batch whose member 1 has a row unbounded above and one
    unbounded below, member 2 a free row (rho pinned at 1e-6) and member 3
    an equality row."""
    P, q, A, l, u = _batch(seed, B, n, m)
    u[1, 0], l[1, 1] = np.inf, -np.inf
    l[2, 2], u[2, 2] = -np.inf, np.inf
    l[3, 3] = u[3, 3] = 0.5 * (l[3, 3] + u[3, 3])  # A x0, still feasible
    return P, q, A, l, u


def _jqp(arrs):
    return JQP(*(jnp.asarray(a) for a in arrs))


def _assert_same(js, ts, atol=1e-9):
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_array_equal(ts.iters.numpy(), np.asarray(js.iters))
    np.testing.assert_allclose(ts.primal.numpy(), np.asarray(js.primal), atol=atol, rtol=0)
    np.testing.assert_allclose(ts.dual.numpy(), np.asarray(js.dual), atol=atol, rtol=0)


LANE = dict(backend="lane")


@functools.lru_cache(maxsize=None)
def _imbalanced(seed=11, B=8, n=3, m=24):
    """tests/test_qp.py's adaptive-rho family: the cost scaled 1000x against
    the constraints, so the residuals are badly balanced."""
    return _batch(seed, B, n, m, scale=1000.0)


ADAPTIVE = dict(max_iter=50000, polish=False, scaling=False, eps_abs=1e-7, eps_rel=1e-7,
                adaptive_rho=True)


@functools.lru_cache(maxsize=None)
def _jax_adaptive_lane():
    return j_solve(_jqp(_imbalanced()), JParams(**ADAPTIVE, **LANE))


def test_lane_matches_jax_random():
    """tests/test_qp.py:688 (tall tiny QPs, the ASIF shape) with a +-inf
    row pair, a free row and an equality row: statuses, iteration counts,
    primal and dual as JAX's lane backend; all Optimal."""
    arrs = _family(4, B=8, n=3, m=20)
    prm = dict(max_iter=4000, polish=False, **LANE)
    js = j_solve(_jqp(arrs), JParams(**prm))
    ts = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**prm))
    assert bool((ts.status == QPSolutionStatus.Optimal).all())
    _assert_same(js, ts)
    np.testing.assert_allclose(ts.objective.numpy(), np.asarray(js.objective), atol=1e-9, rtol=0)


def test_lane_polish_and_warmstart_match_jax():
    """tests/test_qp.py:709: polish (batch-leading finalize) and the scaled
    warm start compose with the lane loop; the warm-started solve stops no
    later than the cold one, both as JAX's."""
    arrs = _batch(5, 6, 4, 16)
    prm = dict(max_iter=4000, polish=True, eps_abs=1e-6, eps_rel=1e-6, **LANE)
    jprm, tprm = JParams(**prm), QPSolverParams(**prm)
    js = j_solve(_jqp(arrs), jprm)
    ts = solve_qp_batch(qp_from_numpy(arrs), tprm)
    _assert_same(js, ts)
    js2 = j_solve(_jqp(arrs), jprm, js)
    ts2 = solve_qp_batch(qp_from_numpy(arrs), tprm, ts)
    _assert_same(js2, ts2)
    assert bool((ts2.status == QPSolutionStatus.Optimal).all())
    assert bool((ts2.iters <= ts.iters).all())


CERTIFICATES = {
    # x <= -1 and x >= 1
    "primal infeasible": ((np.eye(1)[None], np.zeros((1, 1)), np.array([[[1.0], [1.0]]]),
                           np.array([[-np.inf, 1.0]]), np.array([[-1.0, np.inf]])),
                          QPSolutionStatus.PrimalInfeasible),
    # min -x, x >= 0
    "dual infeasible": ((np.zeros((1, 1, 1)), np.array([[-1.0]]), np.array([[[1.0]]]),
                         np.array([[0.0]]), np.array([[np.inf]])), QPSolutionStatus.DualInfeasible),
    # the box [2, 1]
    "trivially infeasible": ((np.eye(1)[None], np.zeros((1, 1)), np.array([[[1.0]]]),
                              np.array([[2.0]]), np.array([[1.0]])), QPSolutionStatus.PrimalInfeasible),
}


@pytest.mark.parametrize("case", list(CERTIFICATES))
def test_lane_certificates_match_jax(case):
    """tests/test_qp.py:732: each certificate fires on the lane loop, with
    JAX's status and iteration count."""
    arrs, want = CERTIFICATES[case]
    prm = dict(max_iter=4000, polish=False, **LANE)
    js = j_solve(_jqp(arrs), JParams(**prm))
    ts = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**prm))
    assert int(ts.status[0]) == want
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_array_equal(ts.iters.numpy(), np.asarray(js.iters))


def test_lane_precomputed_factors_match_jax():
    """tests/test_qp.py:763: per-problem factors from the batch-leading
    qp_factorize transpose into the lane loop, in both packages alike."""
    arrs = _batch(6, 6, 3, 12)
    prm = dict(max_iter=4000, polish=False, **LANE)
    jf = j_factorize(_jqp(arrs), JParams(**prm))
    tf = qp_factorize(qp_from_numpy(arrs), QPSolverParams(**prm))
    js = j_solve(_jqp(arrs), JParams(**prm), None, jf)
    ts = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**prm), None, tf)
    _assert_same(js, ts)


def test_lane_midsize_matches_jax():
    """tests/test_qp.py:781 at n = 40, m = 10: above 32 variables the lane
    factorization runs batch-leading (cholesky_ex, two triangular solves);
    with polish, as JAX's."""
    arrs = _batch(8, 3, 40, 10)
    prm = dict(polish=True, **LANE)
    _assert_same(j_solve(_jqp(arrs), JParams(**prm)), solve_qp_batch(qp_from_numpy(arrs),
                                                                       QPSolverParams(**prm)))


def test_lane_compensated_check_and_refinement_match_jax():
    """tests/test_qp.py:811's lane case at n = m = 6 (equality rows, a tight
    eps_abs): compensated residuals in the stopping check, the certificate
    of the polished point, and two KKT refinement sweeps a solve."""
    rng = np.random.default_rng(3)
    B, n = 4, 6
    M = rng.standard_normal((B, n, n))
    P = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)
    beq = 0.1 * rng.standard_normal((B, n))
    arrs = (P, rng.standard_normal((B, n)), np.broadcast_to(np.eye(n), (B, n, n)).copy(), beq, beq)
    prm = dict(max_iter=20000, polish=True, eps_abs=2e-9, eps_rel=0.0, compensated_check=True,
               kkt_refine_iters=2, **LANE)
    js = j_solve(_jqp(arrs), JParams(**prm))
    ts = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**prm))
    _assert_same(js, ts)
    np.testing.assert_allclose(ts.dual_res.numpy(), np.asarray(js.dual_res), atol=1e-12, rtol=0)
    assert bool((ts.status == QPSolutionStatus.Optimal).all())


def test_lane_adaptive_rho_matches_jax():
    """tests/test_qp.py:861 and :903-974: adaptive rho on the lane loop
    (scaling off, eps 1e-7, the cost 1000x the constraints) takes JAX's
    adaptation schedule: statuses and iterations equal, primal and dual
    within 1e-9; the torch loop's adaptive rho runs the same schedule; a
    static rho needs more iterations; a certificate still fires."""
    arrs = _imbalanced()
    js = _jax_adaptive_lane()
    ts = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**ADAPTIVE, **LANE))
    _assert_same(js, ts)
    assert bool((ts.status == QPSolutionStatus.Optimal).all())
    tt = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**ADAPTIVE))
    np.testing.assert_array_equal(tt.iters.numpy(), ts.iters.numpy())
    np.testing.assert_allclose(tt.primal.numpy(), ts.primal.numpy(), atol=1e-9, rtol=0)
    static = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**dict(
        ADAPTIVE, adaptive_rho=False, max_iter=2 * int(ts.iters.max())), **LANE))
    assert bool((static.status == QPSolutionStatus.MaxIterations).all())
    arrs, want = CERTIFICATES["primal infeasible"]
    sol = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**ADAPTIVE, **LANE))
    assert int(sol.status[0]) == want


def _reference(arrs, prm, member_refactor, factors=None):
    """The lane kernel's plain version on the solver's float64 inputs."""
    P, q, A, l, u = qp_from_numpy(arrs)
    args = qsolver._lane_inputs(prm, P, q, A, l, u, None, factors)
    return admm_iterate_lane_reference(prm, *args, member_refactor=member_refactor)


def test_member_refactorization_is_exact():
    """The lane kernel refactorizes only the members that adapt, where JAX
    refactorizes the whole fleet whenever one adapts.  In the plain version
    (f64), refactorizing the adapting members alone gives JAX's statuses,
    iterations and refactor counts, and the same unscaled primal within
    1e-9, from the lane loop's own factors: a member that does not adapt
    would get its own factors back.  The two exceptions: factors passed in
    from the batch-leading qp_factorize (the first whole-fleet
    refactorization replaces them with lane-computed ones: a rounding-level
    difference), and a starting rho outside [1e-6, 1e6] (the whole-fleet
    refactorization clips it; alone, a member that never adapts keeps it)."""
    arrs = _imbalanced()
    prm = QPSolverParams(**ADAPTIVE, **LANE)
    js = _jax_adaptive_lane()
    whole = _reference(arrs, prm, False)
    alone = _reference(arrs, prm, True)
    assert int(alone[7].sum()) > 0 and len(set(alone[7].tolist())) > 1  # members adapt unevenly
    for out in (whole, alone):
        np.testing.assert_array_equal(out[3].numpy(), np.asarray(js.status))
        np.testing.assert_array_equal(out[4].numpy(), np.asarray(js.iters))
        np.testing.assert_allclose(out[0].numpy(), np.asarray(js.primal), atol=1e-9, rtol=0)
    torch.testing.assert_close(alone[7], whole[7], rtol=0, atol=0)
    torch.testing.assert_close(alone[0], whole[0], rtol=0, atol=0)

    # exception 1: batch-leading factors differ from the lane ones by rounding
    fac = qp_factorize(qp_from_numpy(arrs), prm)
    whole_f, alone_f = (_reference(arrs, prm, mr, fac) for mr in (False, True))
    torch.testing.assert_close(alone_f[4], whole_f[4], rtol=0, atol=0)
    np.testing.assert_allclose(alone_f[0].numpy(), whole_f[0].numpy(), atol=1e-9, rtol=0)

    # exception 2: equality rows at rho_eq_scale rho = 2e6, clipped to 1e6 by
    # the first whole-fleet refactorization (member 0, imbalanced, adapts),
    # kept by a member that never adapts
    P, q, A, l, u = _batch(8, 4, 3, 8)
    P[0], q[0] = 1000.0 * P[0], 1000.0 * q[0]
    l[1:, 0] = u[1:, 0] = 0.5 * (l[1:, 0] + u[1:, 0])
    arrs = (P, q, A, l, u)
    kw = dict(max_iter=400, polish=False, scaling=False, rho=2.0, rho_eq_scale=1e6,
              adaptive_rho=True, **LANE)
    prm = QPSolverParams(**kw)
    jx = j_solve(_jqp(arrs), JParams(**kw))
    whole, alone = (_reference(arrs, prm, mr) for mr in (False, True))
    np.testing.assert_array_equal(whole[4].numpy(), np.asarray(jx.iters))
    np.testing.assert_allclose(whole[0].numpy(), np.asarray(jx.primal), atol=1e-9, rtol=0)
    kept = (alone[7] == 0).nonzero().flatten()
    assert kept.numel() and int(alone[7].sum()) > 0
    assert not torch.equal(alone[0][kept], whole[0][kept])


def test_kernel_plain_version_is_the_lane_loop():
    """admm_iterate_lane_reference is the solver's loop: on the solver's
    inputs it returns the iterates solve_qp_batch finalizes (polish off), and
    from factors it computes first it runs exactly as from none; the kernel
    wrapper on CPU tensors is the plain version, on the float32 arguments
    lane_kernel_args prepares, and counts no launch."""
    arrs = _family(12, B=5, n=4, m=10)
    prm = QPSolverParams(max_iter=500, polish=False, adaptive_rho=True, rho=0.02, **LANE)
    P, q, A, l, u = qp_from_numpy(arrs)
    args = qsolver._lane_inputs(prm, P, q, A, l, u, None, None)
    out = admm_iterate_lane_reference(prm, *args)
    sol = solve_qp_batch(qp_from_numpy(arrs), prm)
    c, sx, sy = args[5:8]
    torch.testing.assert_close(sx * out[0], sol.primal, rtol=0, atol=0)
    torch.testing.assert_close(sy * out[2] / c[:, None], sol.dual, rtol=0, atol=0)
    torch.testing.assert_close(out[3], sol.status, rtol=0, atol=0)
    torch.testing.assert_close(out[4], sol.iters, rtol=0, atol=0)

    Mredt, Minvt, fail = qsolver._lane_chol_inverse(
        args[9].permute(1, 2, 0), args[10].permute(1, 2, 0), args[8].T, prm.sigma)
    assert not bool(fail.any())
    given = list(args)
    given[11], given[12] = Mredt.permute(2, 0, 1), Minvt.permute(2, 0, 1)
    for a, b in zip(admm_iterate_lane_reference(prm, *given), out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    f32 = lane_kernel_args(qp_from_numpy(arrs), None, None, prm)
    assert f32[11] is None and f32[12] is None and f32[0].dtype == torch.float32
    before = admm_iterate_cuda_lane.launches
    for a, b in zip(admm_iterate_cuda_lane(prm, *f32), admm_iterate_lane_reference(prm, *f32)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert admm_iterate_cuda_lane.launches == before
    # the wrapper takes float32, contiguous, consistently shaped arguments
    with pytest.raises(TypeError, match="float32"):
        admm_iterate_cuda_lane(prm, *args)
    with pytest.raises(ValueError, match="together"):
        admm_iterate_cuda_lane(prm, *f32[:11], f32[9], None, *f32[13:])
    with pytest.raises(ValueError, match="shape"):
        admm_iterate_cuda_lane(prm, *f32[:10], f32[10][:, :-1], *f32[11:])


@pytest.mark.parametrize(
    "B,n,m,plan",
    [
        (256, 3, 53, (2, 2 * 3856)),  # the ASIF fleet: two problems a block, 128 blocks
        (4096, 3, 53, (LANE_MAX_WARPS, LANE_MAX_WARPS * 3856)),
        (1, 3, 53, (1, 3856)),
        (256, 32, 256, (2, 2 * 66176)),  # n <= 32 at m = 256: three fit a block
        (64, 96, 96, (1, 195072)),  # n = m = 96: one a block
    ],
)
def test_lane_plan(B, n, m, plan):
    """lane_plan mirrors the kernel's launch layout: a warp a problem, as
    many a block as fit (at most 8), no more than it takes to give each of
    the 132 SMs a block."""
    assert lane_plan(B, n, m) == plan
    assert lane_problem_bytes(n, m) * plan[0] == plan[1] <= SMEM_LIMIT


def test_lane_fits_the_shapes_it_must_hold():
    """The lane kernel holds every n <= 32 with m <= 256 and n = m up to 96
    (benchmarks/qp_bench.py's lane column), and refuses n = m = 128, which
    then runs the plain loop; lane_plan raises for it."""
    assert all(lane_fits(n, m) for n in range(1, 33) for m in (1, 53, 256))
    assert all(lane_fits(n, n) for n in range(1, 97))
    assert not lane_fits(128, 128)
    with pytest.raises(ValueError, match="cannot hold"):
        lane_plan(4, 128, 128)


def test_lane_dispatch_rules(capfd):
    """Shared factors on "lane" take the torch shared loop (as JAX's take its
    XLA shared path): equal to "torch" and to JAX's lane backend there;
    adaptive rho is refused on "cuda" and with shared factors; lane solves of
    CPU tensors run the plain loop, with no fall-through counted and no
    launch; verbose prints the lane loop's check lines."""
    arrs = tuple(a[:1] if a.ndim == 3 else a for a in _batch(14, 4, 4, 6))
    prm = dict(max_iter=4000, polish=False)
    tmpl = qp_from_numpy(tuple(a[:1] for a in arrs))
    fac = type(qp_factorize(tmpl))(*(a[0] for a in qp_factorize(tmpl)))
    tl = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**prm, **LANE), None, fac)
    tt = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**prm), None, fac)
    for a, b in zip(tl, tt):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    jfac = jax.tree.map(lambda a: a[0], j_factorize(_jqp(tuple(a[:1] for a in arrs)), JParams()))
    _assert_same(j_solve(_jqp(arrs), JParams(**prm, **LANE), None, jfac), tl)

    with pytest.raises(ValueError, match="adaptive_rho"):
        solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(adaptive_rho=True, backend="cuda"))
    with pytest.raises(ValueError, match="adaptive_rho"):
        solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(adaptive_rho=True, **LANE), None, fac)

    falls, launches = qsolver.lane_fallthroughs, admm_iterate_cuda_lane.launches
    capfd.readouterr()
    sol = solve_qp_batch(qp_from_numpy(_family(15, B=4, n=3, m=6)),
                         QPSolverParams(max_iter=60, stop_check_iter=10, polish=False, verbose=True,
                                        **LANE))
    lines = [s for s in capfd.readouterr().out.splitlines() if s.startswith("[qp/lane] iter ")]
    assert len(lines) == (int(sol.iters.max()) + 8) // 10
    assert qsolver.lane_fallthroughs == falls and admm_iterate_cuda_lane.launches == launches
