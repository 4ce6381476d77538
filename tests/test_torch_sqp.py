"""The single-problem SQP (solve_nlp_sqp), port against the JAX package,
float64 on the CPU: the port on backend "torch", JAX on "xla", on the
problems of tests/test_sqp.py and benchmarks/sqp_bench.py's Rosenbrock
chain (small n).  Per problem: the same status and SQP iteration count,
x within 1e-7, both KKT residuals <= tol; also the BFGS mode, the
qp_budget and stall exits and a warm start (x0, lam0) handed over through
convert.sqp_warmstart_from_numpy.  The inner QP iteration totals are not
compared: with adaptive rho they follow rounding (JAX's own batched and
single forms differ there)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smooth_feedback_tpu.nlp import NLP as JNLP
from smooth_feedback_tpu.qp import QPSolverParams as JQ
from smooth_feedback_tpu.solvers import SQPParams as JP
from smooth_feedback_tpu.solvers import solve_nlp_sqp as j_solve
from smooth_feedback_tpu_torch.convert import sqp_warmstart_from_numpy
from smooth_feedback_tpu_torch.nlp import NLP as TNLP
from smooth_feedback_tpu_torch.nlp import NLPSolutionStatus
from smooth_feedback_tpu_torch.qp import QPSolverParams as TQ
from smooth_feedback_tpu_torch.solvers import SQPParams as TP
from smooth_feedback_tpu_torch.solvers import solve_nlp_sqp as t_solve

torch.set_num_threads(1)

inf = float("inf")
OPTIMAL = int(NLPSolutionStatus.Optimal)


def _arr(lib):
    return (lambda a: jnp.asarray(a, jnp.float64)) if lib is jnp else (
        lambda a: torch.tensor(np.asarray(a, dtype=np.float64)))


def _problem(name, lib):
    """(NLP, x0) of tests/test_sqp.py's problems and the chain, in ``lib``."""
    a = _arr(lib)
    NLP = JNLP if lib is jnp else TNLP
    st = lib.stack
    if name == "equality_qp":  # min x'x, x0 + x1 = 1 -> (0.5, 0.5)
        return NLP(2, 1, lambda x: x @ x, lambda x: st([x[0] + x[1]]), a([-inf] * 2),
                   a([inf] * 2), a([1.0]), a([1.0])), np.zeros(2)
    if name == "rosenbrock_box":  # -> (1, 1)
        return NLP(2, 1, lambda x: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2,
                   lambda x: st([x[0] + x[1]]), a([-2.0, -2.0]), a([2.0, 2.0]), a([-10.0]),
                   a([10.0])), np.array([-1.0, 1.0])
    if name == "inequality_active":  # -> (1.5, 0.5)
        return NLP(2, 1, lambda x: (x[0] - 2) ** 2 + (x[1] - 1) ** 2,
                   lambda x: st([x[0] + x[1]]), a([0.0, 0.0]), a([inf, inf]), a([-inf]),
                   a([2.0])), np.zeros(2)
    if name == "nonlinear_constraint":  # -> -(1, 1)/sqrt(2)
        return NLP(2, 1, lambda x: x[0] + x[1], lambda x: st([x @ x]), a([-inf] * 2),
                   a([inf] * 2), a([1.0]), a([1.0])), np.array([0.5, -0.8])
    if name == "chain6":  # benchmarks/sqp_bench.py:26-44 at n = 6
        n = 6
        return NLP(n, 2, lambda x: (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2).sum(),
                   lambda x: st([x.sum() - 0.9 * n, x[0] * x[1]]), a(-5.0 * np.ones(n)),
                   a(5.0 * np.ones(n)), a([0.0, -inf]), a([0.0, 2.0])), 0.9 + 0.2 * np.arange(n) / n
    if name == "valley":  # tests/test_sqp.py's stiff Rosenbrock valley (b = 10)
        return NLP(2, 1, lambda x: (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2,
                   lambda x: st([x[0] + x[1]]), a([-5.0] * 2), a([5.0] * 2), a([-4.0]),
                   a([4.0])), np.array([-1.2, 1.0])
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _jax_solve(name, prm, with_lam=False):
    """The JAX package's solve_nlp_sqp of ``name`` under ``prm``, jitted
    once per (problem, parameters)."""
    nlp, _ = _problem(name, jnp)
    if with_lam:
        return jax.jit(lambda x0, lam0: j_solve(nlp, x0, prm, lam0))
    return jax.jit(lambda x0: j_solve(nlp, x0, prm))


def _compare(name, jprm, tprm, x0=None, lam0=None):
    nlp_t, x0_default = _problem(name, torch)
    x0 = x0_default if x0 is None else x0
    if lam0 is None:
        sj = _jax_solve(name, jprm)(jnp.asarray(x0))
    else:
        sj = _jax_solve(name, jprm, True)(jnp.asarray(x0), jnp.asarray(lam0))
    xt, lt = sqp_warmstart_from_numpy(x0, lam0, device="cpu")
    st = t_solve(nlp_t, xt, tprm, lt)
    assert int(st.status) == int(sj.status), (int(st.status), int(sj.status))
    assert int(st.iters) == int(sj.iters), (int(st.iters), int(sj.iters))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), atol=1e-7, rtol=0)
    if int(sj.status) == OPTIMAL:
        assert float(st.kkt_res) <= tprm.tol and float(sj.kkt_res) <= jprm.tol
    return sj, st


@pytest.mark.parametrize("name", ["equality_qp", "rosenbrock_box", "inequality_active",
                                  "nonlinear_constraint", "chain6"])
def test_single_form_matches_jax(name):
    """Default parameters (exact Hessian, equality augmentation, watchdog
    line search, adaptive-rho inner QPs), max_iter 200."""
    sj, st = _compare(name, JP(max_iter=200), TP(max_iter=200))
    assert int(st.status) == OPTIMAL and int(st.qp_iters) >= int(st.iters) > 0


def test_single_form_bfgs_matches_jax():
    _compare("rosenbrock_box", JP(max_iter=200, hessian="bfgs"), TP(max_iter=200, hessian="bfgs"))


def test_single_form_budget_and_stall_exits_match_jax():
    """qp_budget and stall_iters end the valley's solve early as
    IterationLimit at the same iteration in both packages; the same solve
    without them is Optimal."""
    for kw in (dict(qp_budget=300), dict(stall_iters=3, stall_ratio=1e-12), {}):
        qj = JQ(max_iter=400)
        qt = TQ(max_iter=400)
        sj, st = _compare("valley", JP(max_iter=60, tol=1e-10, qp=qj, **kw),
                          TP(max_iter=60, tol=1e-10, qp=qt, **kw))
        assert int(st.status) == (OPTIMAL if not kw else int(NLPSolutionStatus.IterationLimit))


def test_single_form_warm_start_matches_jax():
    """A warm start (x0, lam0) from a perturbed earlier solution, handed to
    the port through convert.sqp_warmstart_from_numpy: the same iterations
    as JAX, fewer than from the cold start."""
    prm_j, prm_t = JP(max_iter=100), TP(max_iter=100)
    cold_j, _ = _compare("chain6", prm_j, prm_t)
    x0 = np.asarray(cold_j.x) + 1e-3
    lam0 = np.asarray(cold_j.lam)
    sj, st = _compare("chain6", prm_j, prm_t, x0, lam0)
    assert int(st.iters) < int(cold_j.iters)
