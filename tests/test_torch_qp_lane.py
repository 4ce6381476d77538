"""The port's lane backend (``backend="lane"``) against the JAX package's, on
the CPU: the plain whole solve (the lane kernel's plain version, built from
the batch-trailing pieces) with its scaling, factorization, checks,
certificates, refinement and adaptive rho; the lane kernel's launch layout;
and the dispatch rules.

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
    admm_solve_cuda_lane,
    admm_solve_lane_reference,
    lane_kernel_args,
    qp_factorize,
    solve_qp_batch,
)
from smooth_feedback_tpu_torch.qp import solver as qsolver
from smooth_feedback_tpu_torch.qp.cuda_kernel import (
    LANE_MAX_WARPS, SMEM_LIMIT, lane_fits, lane_plan, lane_problem_bytes,
)

from smooth_feedback_tpu_torch.groups import Rn

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
    return admm_solve_lane_reference(prm, *qp_from_numpy(arrs), None, None, factors,
                                     member_refactor=member_refactor)


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
    assert int(alone.refactors.sum()) > 0 and len(set(alone.refactors.tolist())) > 1  # unevenly
    for out in (whole, alone):
        np.testing.assert_array_equal(out.status.numpy(), np.asarray(js.status))
        np.testing.assert_array_equal(out.iters.numpy(), np.asarray(js.iters))
        np.testing.assert_allclose(out.primal.numpy(), np.asarray(js.primal), atol=1e-9, rtol=0)
    torch.testing.assert_close(alone.refactors, whole.refactors, rtol=0, atol=0)
    torch.testing.assert_close(alone.primal, whole.primal, rtol=0, atol=0)

    # exception 1: batch-leading factors differ from the lane ones by rounding
    fac = qp_factorize(qp_from_numpy(arrs), prm)
    whole_f, alone_f = (_reference(arrs, prm, mr, fac) for mr in (False, True))
    torch.testing.assert_close(alone_f.iters, whole_f.iters, rtol=0, atol=0)
    np.testing.assert_allclose(alone_f.primal.numpy(), whole_f.primal.numpy(), atol=1e-9, rtol=0)

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
    np.testing.assert_array_equal(whole.iters.numpy(), np.asarray(jx.iters))
    np.testing.assert_allclose(whole.primal.numpy(), np.asarray(jx.primal), atol=1e-9, rtol=0)
    kept = (alone.refactors == 0).nonzero().flatten()
    assert kept.numel() and int(alone.refactors.sum()) > 0
    assert not torch.equal(alone.primal[kept], whole.primal[kept])


def test_kernel_plain_version_is_the_lane_loop():
    """admm_solve_lane_reference is the solver's lane path: on the solver's
    inputs it returns the solution solve_qp_batch returns (polish off), and
    from factors it computes first it runs exactly as from none; the kernel
    wrapper on CPU tensors is the plain version (refactorizing the adapting
    members alone, as the kernel does), on the float32 operands
    lane_kernel_args prepares, and counts no launch; it raises on operands
    the kernel does not take."""
    arrs = _family(12, B=5, n=4, m=10)
    prm = QPSolverParams(max_iter=500, polish=False, adaptive_rho=True, rho=0.02, **LANE)
    qp = qp_from_numpy(arrs)
    out = admm_solve_lane_reference(prm, *qp)
    sol = solve_qp_batch(qp, prm)
    for name in ("primal", "dual", "status", "iters", "objective"):
        torch.testing.assert_close(getattr(out, name), getattr(sol, name), rtol=0, atol=0)
    torch.testing.assert_close(out.pres, sol.primal_res, rtol=0, atol=0)
    assert bool((out.sweeps > 0).all())
    torch.testing.assert_close(out.sx * out.x, out.primal, rtol=0, atol=0)

    Pt, At = qp.P.permute(1, 2, 0), qp.A.permute(1, 2, 0)
    c, sx, sy, rho, Pst, Ast, _ = qsolver._lane_scaling(Pt, qp.q.T, At, qp.l.T, qp.u.T, prm)
    Mredt, Minvt, fail = qsolver._lane_chol_inverse(Pst, Ast, rho, prm.sigma)
    assert not bool(fail.any())
    given = qsolver.QPFactors(c, sx.T, sy.T, rho.T, Pst.permute(2, 0, 1), Ast.permute(2, 0, 1),
                              Mredt.permute(2, 0, 1), Minvt.permute(2, 0, 1), ~fail)
    from_given = admm_solve_lane_reference(prm, *qp, None, None, given)
    for name in ("primal", "dual", "status", "iters", "objective", "pres", "dres", "refactors"):
        torch.testing.assert_close(getattr(from_given, name), getattr(out, name), rtol=0, atol=0)

    f32 = lane_kernel_args(qp_from_numpy(arrs, dtype=torch.float32))
    assert f32[5] is None and f32[7] is None and f32[0].dtype == torch.float32
    before = admm_solve_cuda_lane.launches
    k = admm_solve_cuda_lane(prm, *f32)
    r = admm_solve_lane_reference(prm, *f32, member_refactor=True)
    for a, b in zip(k, r):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert admm_solve_cuda_lane.launches == before
    # the wrapper takes float32 operands with contiguous inner axes
    with pytest.raises(TypeError, match="float32"):
        admm_solve_cuda_lane(prm, *qp)
    with pytest.raises(ValueError, match="together"):
        admm_solve_cuda_lane(prm, *f32[:5], f32[1], None)
    with pytest.raises(ValueError, match="shape"):
        admm_solve_cuda_lane(prm, f32[0], f32[1][:, :-1], *f32[2:])
    with pytest.raises(ValueError, match="inner"):
        admm_solve_cuda_lane(prm, f32[0].mT, *f32[1:])


@pytest.mark.parametrize(
    "B,n,m,plan",
    [
        # the ASIF fleet: two problems a block, 128 blocks, P and A resident
        (256, 3, 53, (2, 2 * 4528, 1, 3)),
        (4096, 3, 53, (LANE_MAX_WARPS, LANE_MAX_WARPS * 4528, 1, 3)),
        (1, 3, 53, (1, 4528, 1, 3)),
        (256, 8, 8, (2, 2 * 2752, 1, 8)),  # the last shape on the register path
        (256, 32, 256, (2, 2 * 104192, 1, 0)),  # a lane per output; resident, two fit a block
        (64, 96, 96, (1, 195072, 0, 0)),  # n = m = 96: one a block, P and A in device memory
    ],
)
def test_lane_plan(B, n, m, plan):
    """lane_plan mirrors the kernel's launch layout: a warp a problem, the
    unscaled P and A in shared memory where one problem with them fits a
    block, as many a block as fit (at most 8), no more than it takes to give
    each of the 132 SMs a block; the register path, one instantiation a
    width, up to n = 8."""
    assert lane_plan(B, n, m) == plan
    assert lane_problem_bytes(n, m, bool(plan[2])) * plan[0] == plan[1] <= SMEM_LIMIT


def test_lane_fits_the_shapes_it_must_hold():
    """The lane kernel holds every n <= 32 with m <= 1140 and n = m up to
    105 (benchmarks/qp_bench.py's lane column among them), and refuses n =
    m = 128, which then runs the plain whole solve; lane_plan raises for
    it."""
    assert all(lane_fits(n, m) for n in range(1, 33) for m in (1, 53, 256, 1140))
    assert all(lane_fits(n, n) for n in range(1, 106))
    assert not lane_fits(128, 128) and not lane_fits(106, 106) and not lane_fits(32, 1141)
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

    falls, launches = qsolver.lane_fallthroughs, admm_solve_cuda_lane.launches
    capfd.readouterr()
    sol = solve_qp_batch(qp_from_numpy(_family(15, B=4, n=3, m=6)),
                         QPSolverParams(max_iter=60, stop_check_iter=10, polish=False, verbose=True,
                                        **LANE))
    lines = [s for s in capfd.readouterr().out.splitlines() if s.startswith("[qp/lane] iter ")]
    assert len(lines) == (int(sol.iters.max()) + 8) // 10
    assert qsolver.lane_fallthroughs == falls and admm_solve_cuda_lane.launches == launches


# ------------------------------------------ the whole solve, at the paths' shapes

ASIF = dict(polish=False, max_iter=250, stop_check_iter=10, rho=0.02, adaptive_rho=True, **LANE)


@functools.lru_cache(maxsize=None)
def _asif_fleet(B=8):
    """benchmarks/asif_bench.py's ASIF QPs, (n, m) = (3, 53): the vehicle
    filter's transcription (chip_smoke's, K = 50 over T = 2.5) at B states
    from a seed, each with an MPC input from a seed, as numpy in float64."""
    import chip_smoke
    from smooth_feedback_tpu_torch.controllers import asif_to_qp_fleet
    from smooth_feedback_tpu_torch.groups import SE2, Bundle

    X = Bundle(SE2, Rn(3))
    rng = np.random.default_rng(21)
    dx = torch.as_tensor(0.2 * rng.standard_normal((B, 6)))
    xs = torch.stack([X.rplus(X.identity(dtype=torch.float64, device="cpu"), d) for d in dx])
    us = torch.as_tensor(0.3 * rng.standard_normal((B, 2)))
    fl = chip_smoke.asif_filter("cpu", torch.float64)
    qp = asif_to_qp_fleet(X, Rn(2), chip_smoke.asif_to_qp_params(), chip_smoke.ASIF_T, xs, us,
                          fl["W_u"], fl["ulim"], chip_smoke.vehicle_asif_f, fl["h"], fl["bu"])
    return tuple(a.numpy() for a in qp)


@functools.lru_cache(maxsize=None)
def _jax_asif(warm):
    arrs = _asif_fleet()
    js = j_solve(_jqp(arrs), JParams(**ASIF))
    if not warm:
        return js
    P, q, A, l, u = arrs
    return j_solve(_jqp((P, q + 0.05, A, l, u)), JParams(**ASIF), js)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_lane_asif_fleet_matches_jax(start):
    """The ASIF's (3, 53) fleet at asif_bench.py's solver settings (rho
    0.02, adaptive rho, max_iter 250, a check every 10): the plain whole
    solve (the lane kernel's plain version, what CPU tensors run) against
    JAX's solve_qp_batch(backend="lane"), cold, and warm-started from the
    cold solution on the next step's QPs (q moved): statuses and iteration
    counts equal, primal and dual within 1e-9 (f64)."""
    from smooth_feedback_tpu_torch.qp import QPSolution
    from smooth_feedback_tpu_torch.qp import solver as qs

    P, q, A, l, u = arrs = _asif_fleet()
    assert A.shape[1:] == (53, 3)
    prm = QPSolverParams(**ASIF)
    sweeps = qs.lane_ruiz_sweeps
    ts = solve_qp_batch(qp_from_numpy(arrs), prm)
    assert qs.lane_ruiz_sweeps > sweeps  # the plain whole solve scales in torch
    if start == "warm":
        ts = solve_qp_batch(qp_from_numpy((P, q + 0.05, A, l, u)), prm, QPSolution(*ts))
    js = _jax_asif(start == "warm")
    _assert_same(js, ts)
    assert float((ts.status == QPSolutionStatus.Optimal).float().mean()) >= 0.5


def test_lane_adaptive_compensated_family_matches_jax():
    """qp_bench.py's lane family at (3, 24), the smoke's adaptive-rho and
    compensated-check shape: the plain whole solve against JAX's lane
    backend, statuses and iteration counts equal, primal and dual within
    1e-9 (f64), members refactorized."""
    import chip_smoke

    arrs = chip_smoke.lane_family(3, 24, 8, 0.3, 27)
    kw = dict(max_iter=4000, polish=False, adaptive_rho=True, compensated_check=True, **LANE)
    js = j_solve(_jqp(arrs), JParams(**kw))
    ts = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**kw))
    _assert_same(js, ts)
    out = admm_solve_lane_reference(QPSolverParams(**kw), *qp_from_numpy(arrs))
    assert int(out.refactors.sum()) > 0


def test_lane_special_members_match_jax():
    """One batch with a trivially infeasible member (a row with l > u), a
    member with rows free on both sides (rho pinned at 1e-6), a member whose
    reduced KKT matrix has no Cholesky factor (P negative definite: it
    starts Unknown), a member with an equality row, and ordinary members:
    the plain whole solve gives JAX's statuses, iteration counts, primal and
    dual (within 1e-9, f64)."""
    import chip_smoke

    P, q, A, l, u = (np.array(a) for a in chip_smoke.lane_family(3, 20, 6, 0.3, 7))
    P = P + 0.1 * np.eye(3)
    l[1, 0], u[1, 0] = 2.0, 1.0
    l[2, :5], u[2, :5] = -np.inf, np.inf
    P[3], A[3] = -1e3 * np.eye(3), 1e-3 * A[3]
    l[4, 3] = u[4, 3] = 0.5 * (l[4, 3] + u[4, 3])
    arrs = (P, q, A, l, u)
    kw = dict(max_iter=2000, polish=False, adaptive_rho=True, **LANE)
    js = j_solve(_jqp(arrs), JParams(**kw))
    ts = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**kw))
    _assert_same(js, ts)
    assert int(ts.status[1]) == QPSolutionStatus.PrimalInfeasible and int(ts.iters[1]) == 0
    assert int(ts.status[3]) == QPSolutionStatus.Unknown and int(ts.iters[3]) == 0
    assert int(ts.status[2]) == QPSolutionStatus.Optimal


def _ruiz_pair():
    """Member 0 is equilibrated already (P = I, unit rows of A): its Ruiz
    loop stops after 1 sweep; member 1's A spans ten decades each way and
    needs 10."""
    n, m = 3, 6
    A0 = np.zeros((m, n))
    A0[np.arange(m), np.arange(m) % n] = 1.0
    rng = np.random.default_rng(5)
    M = rng.standard_normal((64, n, n))
    A = rng.standard_normal((64, m, n)) * 10.0 ** (5 * rng.standard_normal((64, m, n)))
    q = rng.standard_normal((64, n))
    P = np.stack([np.eye(n), M[6] @ M[6].T])
    A = np.stack([A0, A[6]])
    q = np.stack([0.5 * np.ones(n), q[6]])
    l = np.einsum("bmn,n->bm", A, np.ones(n)) - np.abs(A).sum(axis=2) - 1.0
    return P, q, A, l, l + 2.0 * np.abs(l) + 1.0


def test_lane_ruiz_stops_per_member_as_the_batch_loop():
    """The lane kernel sweeps each member's Ruiz equilibration until that
    member stops; the batch loop sweeps until every member has stopped,
    leaving a stopped member unchanged.  On a batch whose members stop
    after 1 and 10 sweeps, each member scaled alone gives the batch loop's
    c, sx and sy bit for bit, as JAX's _ruiz_lane gives them (to rounding);
    the whole solve of the batch is JAX's."""
    from smooth_feedback_tpu.qp.solver import _ruiz_lane as j_ruiz
    from smooth_feedback_tpu_torch.qp.solver import _ruiz_lane

    P, q, A, l, u = arrs = _ruiz_pair()
    lane = lambda P_, q_, A_: (torch.as_tensor(P_).permute(1, 2, 0), torch.as_tensor(q_).T,
                               torch.as_tensor(A_).permute(1, 2, 0))
    c, sx, sy, sweeps = _ruiz_lane(*lane(P, q, A))
    assert sweeps.tolist() == [1, 10]
    for b in range(2):
        cb, sxb, syb, swb = _ruiz_lane(*lane(P[b:b + 1], q[b:b + 1], A[b:b + 1]))
        assert int(swb[0]) == int(sweeps[b])
        for alone, batch in ((cb[0], c[b]), (sxb[:, 0], sx[:, b]), (syb[:, 0], sy[:, b])):
            assert torch.equal(alone, batch)
    jc, jsx, jsy = j_ruiz(*(jnp.asarray(a.numpy()) for a in lane(P, q, A)))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-15, atol=0)
    np.testing.assert_allclose(sx.numpy(), np.asarray(jsx), rtol=1e-15, atol=0)
    np.testing.assert_allclose(sy.numpy(), np.asarray(jsy), rtol=1e-15, atol=0)
    prm = dict(max_iter=400, polish=False, **LANE)
    _assert_same(j_solve(_jqp(arrs), JParams(**prm)),
                 solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**prm)))


def test_lane_fits_every_shape_it_held_before():
    """lane_fits, lane_problem_bytes and lane_plan accept every shape the
    lane kernel held before it kept the unscaled matrices (one problem's
    As, Minv, Mred, two scratch matrices at row stride n | 1 and 9 n + 14 m
    floats of vectors within a block's 232,448 bytes), the boundary shapes
    (32, 1140), (105, 105), (3, 3414) and (8, 2510) among them, each with
    one problem a block at least and the block within the limit."""
    n = np.arange(1, 129)[:, None]
    m = np.arange(1, 4097)[None, :]
    ld = n | 1
    before = 4 * ((ld * (m + 4 * n) + 9 * n + 14 * m + 3) // 4 * 4) <= SMEM_LIMIT
    now = np.array([[lane_fits(int(a), int(b)) for b in range(1, 4097)] for a in range(1, 129)])
    np.testing.assert_array_equal(now, before)
    for shape in ((32, 1140), (105, 105), (3, 3414), (8, 2510), (1, 3873)):
        assert lane_fits(*shape)
        for B in (1, 256, 4096):
            ppb, smem, resident, small = lane_plan(B, *shape)
            assert 1 <= ppb <= LANE_MAX_WARPS and smem <= SMEM_LIMIT
            assert smem == ppb * lane_problem_bytes(*shape, bool(resident))
            assert small == (shape[0] if shape[0] <= 8 else 0)
    assert not lane_fits(3, 3415) and not lane_fits(8, 2511) and not lane_fits(106, 106)
