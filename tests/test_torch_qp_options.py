"""The PyTorch port's QP solver options against the JAX package, on the CPU:
polish (and that the default parameters, which polish, now solve),
``_certify_point``, ``compensated_check``, ``kkt_refine_iters``,
``adaptive_rho``, ``verbose``, ``solve_qp_timed`` and ``qp_phase_timings``.

Problems are made with numpy from a seed, in the style of the JAX package's
``random_qp`` and tests/test_qp.py's families, and handed to both packages.
The JAX side runs float64 on "xla"; the bar in float64 is the ROADMAP's:
statuses and iteration counts equal, primal (and dual) within 1e-9.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smooth_feedback_tpu.qp import QPSolverParams as JParams
from smooth_feedback_tpu.qp import QuadraticProgram as JQP
from smooth_feedback_tpu.qp import qp_factorize as j_factorize
from smooth_feedback_tpu.qp import solve_qp as j_solve_qp
from smooth_feedback_tpu.qp import solve_qp_batch as j_solve
from smooth_feedback_tpu.qp import solve_qp_timed as j_solve_timed
from smooth_feedback_tpu.qp.solver import _certify_point as j_certify_point
from smooth_feedback_tpu_torch import convert
from smooth_feedback_tpu_torch.qp import (
    QPSolutionStatus,
    QPSolverParams,
    qp_factorize,
    qp_phase_timings,
    solve_qp,
    solve_qp_batch,
    solve_qp_timed,
)
from smooth_feedback_tpu_torch.qp.solver import _certify_point

torch.set_num_threads(1)

qp_from_numpy = functools.partial(convert.qp_from_numpy, device="cpu")


def _random_qp(rng, n, m):
    M = rng.standard_normal((n, n))
    A = rng.standard_normal((m, n))
    center = A @ rng.standard_normal(n)
    spread = np.abs(rng.standard_normal(m)) + 0.1
    return M @ M.T, rng.standard_normal(n), A, center - spread, center + spread


def _family(seed, B=5, n=6, m=8):
    """A batch with a +-inf row pair (member 1), an equality row (member
    3) and a primal-infeasible member (member 2: x0 >= 1 and x0 <= -1)."""
    rng = np.random.default_rng(seed)
    P, q, A, l, u = (np.stack(f) for f in zip(*(_random_qp(rng, n, m) for _ in range(B))))
    u[1, 0], l[1, 1] = np.inf, -np.inf
    l[3, 2] = u[3, 2]
    A[2, :2] = 0.0
    A[2, :2, 0] = 1.0
    l[2, 0], u[2, 0] = 1.0, np.inf
    l[2, 1], u[2, 1] = -np.inf, -1.0
    return P, q, A, l, u


def _jqp(arrs):
    return JQP(*(jnp.asarray(a) for a in arrs))


def _assert_same(js, ts, atol=1e-9):
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_array_equal(ts.iters.numpy(), np.asarray(js.iters))
    np.testing.assert_allclose(ts.primal.numpy(), np.asarray(js.primal), atol=atol, rtol=0)
    np.testing.assert_allclose(ts.dual.numpy(), np.asarray(js.dual), atol=atol, rtol=0)


def test_default_parameters_solve_and_match_jax():
    """QPSolverParams() polishes.  solve_qp and solve_qp_batch with the
    defaults used to raise NotImplementedError; now they return what JAX
    returns (f64: statuses and iterations equal, primal and dual within
    1e-9).  The polished points are KKT points to 1e-9 where the plain
    ADMM solve stops at eps 1e-3."""
    arrs = _family(0)
    js = j_solve(_jqp(arrs), JParams())
    ts = solve_qp_batch(qp_from_numpy(arrs))
    st = ts.status.numpy()
    assert set(st.tolist()) == {int(QPSolutionStatus.Optimal), int(QPSolutionStatus.PrimalInfeasible)}
    _assert_same(js, ts)
    np.testing.assert_allclose(ts.objective.numpy(), np.asarray(js.objective), atol=1e-9)

    one = tuple(a[0] for a in arrs)
    j1 = j_solve_qp(_jqp(one))
    t1 = solve_qp(qp_from_numpy(one))
    assert int(t1.status) == int(j1.status) == QPSolutionStatus.Optimal
    np.testing.assert_allclose(t1.primal.numpy(), np.asarray(j1.primal), atol=1e-9, rtol=0)
    # stationarity of the polished point, far below the ADMM tolerance
    P, q, A = one[:3]
    x, y = t1.primal.numpy(), t1.dual.numpy()
    assert np.abs(P @ x + q + A.T @ y).max() < 1e-9


def test_polish_float32_lu_matches_jax():
    """float32 polishes through LU of the (n+m) quasi-definite system (the
    float64 path takes the Schur complement's Cholesky).  Statuses equal;
    primal within 1e-4.  Iteration counts may differ: float32 on both sides
    with another summation order puts a member's residual on either side of
    a check's threshold (member 3, with an equality row at rho 100, stops 75
    iterations apart).  Polish takes both to the same active-set point, so
    the primals agree to float32 refinement accuracy all the same."""
    arrs = tuple(np.asarray(a, np.float32) for a in _family(1))
    js = j_solve(_jqp(arrs), JParams())
    ts = solve_qp_batch(qp_from_numpy(arrs, dtype=torch.float32))
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_allclose(ts.primal.numpy(), np.asarray(js.primal), atol=1e-4, rtol=0)
    assert (ts.status.numpy() == QPSolutionStatus.Optimal).sum() == 4


@pytest.mark.parametrize(
    "opts",
    [
        dict(compensated_check=True, eps_abs=1e-7, eps_rel=1e-7, max_iter=3000),
        dict(kkt_refine_iters=2, polish=False, eps_abs=1e-6, eps_rel=1e-6),
        dict(compensated_check=True, kkt_refine_iters=1, eps_abs=1e-6, eps_rel=1e-6, stop_check_iter=1),
    ],
    ids=["compensated", "refine", "both"],
)
def test_compensated_check_and_kkt_refinement_f64(opts):
    """compensated_check (error-free residuals in the stopping check, and
    the polished point re-certified) and kkt_refine_iters (refinement of each
    KKT solve) against JAX in f64: statuses and iterations equal, primal and
    dual within 1e-9, the reported residuals within 1e-12."""
    arrs = _family(2)
    js = j_solve(_jqp(arrs), JParams(**opts))
    ts = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**opts))
    _assert_same(js, ts)
    for a, b in ((ts.primal_res, js.primal_res), (ts.dual_res, js.dual_res)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=0)


def test_certify_point_matches_jax():
    """_certify_point at the same points (float64 and float32): pres and
    dres within 1e-13 (float64) and 2e-6 (float32) of the residuals' scale
    (the compensated sums are exact to ~eps^2; what may differ is the final
    rounding of hi + lo), and the same verdicts.  Member 0 sits at its
    polished solution and passes; the others are random points and fail."""
    arrs = _family(3)
    rng = np.random.default_rng(4)
    j_certify = jax.jit(j_certify_point, static_argnums=0)
    B, n = arrs[1].shape
    m = arrs[3].shape[1]
    sol = solve_qp_batch(qp_from_numpy(arrs))
    for dt, tol in ((np.float64, 1e-13), (np.float32, 2e-6)):
        data = tuple(np.asarray(a, dt) for a in arrs)
        primal = np.asarray(rng.standard_normal((B, n)), dt)
        dual = np.asarray(rng.standard_normal((B, m)), dt)
        primal[0], dual[0] = sol.primal[0].numpy(), sol.dual[0].numpy()
        prm = dict(eps_abs=1e-5, eps_rel=1e-5)
        jp, jd, jok = j_certify(JParams(**prm), *_jqp(data), jnp.asarray(primal), jnp.asarray(dual))
        tdata = qp_from_numpy(data, dtype=getattr(torch, np.dtype(dt).name))
        tp, td, tok = _certify_point(QPSolverParams(**prm), *tdata, torch.as_tensor(primal), torch.as_tensor(dual))
        scale = np.asarray(jp) + np.asarray(jd) + 1.0
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=tol * scale.max(), rtol=0)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=tol * scale.max(), rtol=0)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert bool(tok[0]) and not bool(tok[1:].any())


def _imbalanced(seed, B=6, n=3, m=24):
    """test_qp.py's adaptive-rho family: cost scaled 1000x against the
    constraints (the residuals are badly balanced)."""
    rng = np.random.default_rng(seed)
    P, q, A, l, u = (np.stack(f) for f in zip(*(_random_qp(rng, n, m) for _ in range(B))))
    return 1000.0 * P, 1000.0 * q, A, l, u


def test_adaptive_rho_f64():
    """adaptive_rho on the torch loop against JAX's on "xla" (f64, scaling
    off, eps 1e-7): statuses and iterations equal, primal and dual within
    1e-9; adaptation takes fewer iterations than a static rho; the
    certificates still fire with it on."""
    arrs = _imbalanced(11)
    prm = dict(max_iter=50000, polish=False, scaling=False, eps_abs=1e-7, eps_rel=1e-7)
    js = j_solve(_jqp(arrs), JParams(**prm, adaptive_rho=True))
    ts = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**prm, adaptive_rho=True))
    _assert_same(js, ts)
    assert bool((ts.status == QPSolutionStatus.Optimal).all())
    # a static rho leaves every member short of eps at twice the iterations
    static = solve_qp_batch(
        qp_from_numpy(arrs), QPSolverParams(**dict(prm, max_iter=2 * int(ts.iters.max())))
    )
    assert bool((static.status == QPSolutionStatus.MaxIterations).all())

    infeasible = (np.eye(1)[None], np.zeros((1, 1)), np.array([[[1.0], [1.0]]]),
                  np.array([[-np.inf, 1.0]]), np.array([[-1.0, np.inf]]))
    sol = solve_qp_batch(qp_from_numpy(infeasible), QPSolverParams(**prm, adaptive_rho=True))
    assert int(sol.status[0]) == QPSolutionStatus.PrimalInfeasible


def test_adaptive_rho_rejected_cuda_and_shared():
    """As JAX rejects adaptive_rho on "pallas" and with shared factors, the
    port rejects it on "cuda" and with shared factors (ValueError), before
    anything runs."""
    arrs = tuple(a[:2] for a in _family(5, n=3, m=5))
    qps = qp_from_numpy(arrs)
    with pytest.raises(ValueError, match="adaptive_rho"):
        solve_qp_batch(qps, QPSolverParams(adaptive_rho=True, backend="cuda"))
    prm = QPSolverParams(adaptive_rho=True)
    tmpl = qp_from_numpy(tuple(a[:1] for a in arrs))
    fac = type(qp_factorize(tmpl, prm))(*(a[0] for a in qp_factorize(tmpl, prm)))
    with pytest.raises(ValueError, match="adaptive_rho"):
        solve_qp_batch(qp_from_numpy(tuple(a[:1] if a.ndim == 3 else a for a in arrs)), prm, None, fac)
    # the JAX package rejects the same two
    jqps = _jqp(arrs)
    with pytest.raises(ValueError, match="adaptive_rho"):
        j_solve(jqps, dataclasses.replace(JParams(), adaptive_rho=True, backend="pallas"))
    jfac = jax.tree.map(lambda a: a[0], j_factorize(_jqp(tuple(a[:1] for a in arrs)), JParams()))
    with pytest.raises(ValueError, match="adaptive_rho"):
        j_solve(jqps, JParams(adaptive_rho=True), None, jfac)


def test_solve_qp_timed_matches_jax():
    """solve_qp_timed in chunks of 15 iterations (f64, polish off): with an
    infinite budget the statuses and the accumulated iteration counts equal
    JAX's (a member converged in an earlier chunk adds nothing), and the
    primal agrees within 1e-9; with a zero budget every member still
    running after the first chunk returns MaxTime, as in JAX; a single
    (unbatched) QP goes through too."""
    arrs = _family(6, B=6)
    prm = dict(polish=False, max_iter=400, stop_check_iter=5)
    js = j_solve_timed(_jqp(arrs), JParams(**prm), chunk_iter=15)
    ts = solve_qp_timed(qp_from_numpy(arrs), QPSolverParams(**prm), chunk_iter=15)
    _assert_same(js, ts)
    one = solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**prm))
    # chunking restarts from warm starts, so counts exceed a single solve's
    assert int(ts.iters.max()) > 15 and int(one.iters.max()) > 15

    jz = j_solve_timed(_jqp(arrs), JParams(**prm), max_time=0.0, chunk_iter=15)
    tz = solve_qp_timed(qp_from_numpy(arrs), QPSolverParams(**prm), max_time=0.0, chunk_iter=15)
    np.testing.assert_array_equal(tz.status.numpy(), np.asarray(jz.status))
    np.testing.assert_array_equal(tz.iters.numpy(), np.asarray(jz.iters))
    assert int(QPSolutionStatus.MaxTime) in tz.status.tolist()

    single = tuple(a[0] for a in arrs)
    t1 = solve_qp_timed(qp_from_numpy(single), QPSolverParams(**prm), chunk_iter=15)
    j1 = j_solve_timed(_jqp(single), JParams(**prm), chunk_iter=15)
    assert t1.primal.shape == (single[0].shape[0],)
    assert int(t1.status) == int(j1.status) and int(t1.iters) == int(j1.iters)


def test_verbose_prints_the_jax_check_lines(capfd):
    """verbose=True prints one line at each stopping check with JAX's fields
    (members running, median and largest primal and dual residuals); on the
    same problems in f64 the lines read as JAX's do."""
    arrs = _family(7, B=4)
    prm = dict(polish=False, max_iter=60, stop_check_iter=20, verbose=True)
    j_solve(_jqp(arrs), JParams(**prm)).primal.block_until_ready()
    jlines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("[qp]")]
    solve_qp_batch(qp_from_numpy(arrs), QPSolverParams(**prm))
    tlines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("[qp]")]
    assert len(tlines) == 3 and tlines[0].startswith("[qp] iter 1: running ")
    assert tlines == jlines


def test_qp_phase_timings_fields():
    """qp_phase_timings returns JAX's fields: every phase time finite and
    non-negative, total at least the solve with polish off, the batch size,
    and the mean iteration count of the configured solve (a timing on this
    CPU, not a device figure)."""
    arrs = _family(8, B=4)
    out = qp_phase_timings(qp_from_numpy(arrs), QPSolverParams(), reps=1)
    assert set(out) == {"factor_ms", "iterate_ms", "polish_ms", "total_ms", "iters_mean", "batch"}
    assert out["batch"] == 4 and all(out[k] >= 0.0 for k in out)
    sol = solve_qp_batch(qp_from_numpy(arrs))
    assert out["iters_mean"] == float(sol.iters.double().mean())
    off = qp_phase_timings(qp_from_numpy(tuple(a[0] for a in arrs)), QPSolverParams(polish=False))
    assert off["polish_ms"] == 0.0 and off["batch"] == 1
