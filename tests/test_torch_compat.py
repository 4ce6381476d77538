"""The port's solver bridges (``smooth_feedback_tpu_torch.compat``).

``osqp`` and ``cyipopt`` are not installed, so the OSQP and Ipopt bridges'
parameter mapping, warm starts, status maps and exact Hessian are exercised
against in-memory fake modules injected into ``sys.modules`` (the fakes and
cases of tests/test_bridges.py, on the port's types).  ``solve_nlp_scipy``
is held against the JAX package's on the same NLP.
"""

import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smooth_feedback_tpu.compat import solve_nlp_scipy as j_solve_nlp_scipy
from smooth_feedback_tpu.nlp import NLP as JNLP
from smooth_feedback_tpu_torch.compat import solve_nlp_scipy
from smooth_feedback_tpu_torch.nlp import NLP, NLPSolution, NLPSolutionStatus, with_hessians
from smooth_feedback_tpu_torch.qp import (
    QPSolution,
    QPSolutionStatus,
    QPSolverParams,
    QuadraticProgram,
)

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64)

# --------------------------------------------------------------------- osqp


class _FakeOSQPResult:
    def __init__(self, status):
        self.x = np.array([1.0, 2.0])
        self.y = np.array([0.5])
        self.info = types.SimpleNamespace(
            status=status, iter=13, obj_val=-1.25, pri_res=1e-7, dua_res=2e-7
        )


class _FakeOSQP:
    """Records setup/warm_start kwargs; returns a canned result."""

    instances = []

    def __init__(self):
        self.setup_kwargs = None
        self.warmstart_args = None
        self.status = "solved"
        _FakeOSQP.instances.append(self)

    def setup(self, **kwargs):
        self.setup_kwargs = kwargs

    def warm_start(self, x=None, y=None):
        self.warmstart_args = (np.asarray(x), np.asarray(y))

    def solve(self):
        return _FakeOSQPResult(self.status)


@pytest.fixture
def fake_osqp(monkeypatch):
    mod = types.ModuleType("osqp")
    mod.OSQP = _FakeOSQP
    _FakeOSQP.instances = []
    monkeypatch.setitem(sys.modules, "osqp", mod)
    return mod


def _small_qp():
    return QuadraticProgram(
        P=torch.tensor([[2.0, 0.5], [0.5, 1.0]], **F64),
        q=torch.tensor([1.0, -1.0], **F64),
        A=torch.tensor([[1.0, 1.0]], **F64),
        l=torch.tensor([-1.0], **F64),
        u=torch.tensor([1.0], **F64),
    )


def test_osqp_bridge_param_mapping(fake_osqp):
    from smooth_feedback_tpu_torch.compat import osqp_available, solve_qp_osqp

    assert osqp_available()
    prm = QPSolverParams(
        alpha=1.55, rho=0.2, sigma=2e-6, scaling=True,
        eps_abs=1e-5, eps_rel=1e-6, eps_primal_inf=1e-7, eps_dual_inf=1e-8,
        max_iter=321, stop_check_iter=10, polish=True, polish_iter=7,
        delta=3e-6,
    )
    sol = solve_qp_osqp(_small_qp(), prm)

    kw = _FakeOSQP.instances[-1].setup_kwargs
    assert kw["alpha"] == 1.55 and kw["rho"] == 0.2 and kw["sigma"] == 2e-6
    assert kw["scaling"] == 10  # scaling=True -> 10 Ruiz iters
    assert kw["eps_abs"] == 1e-5 and kw["eps_rel"] == 1e-6
    assert kw["eps_prim_inf"] == 1e-7 and kw["eps_dual_inf"] == 1e-8
    assert kw["max_iter"] == 321 and kw["check_termination"] == 10
    assert kw["polish"] is True and kw["polish_refine_iter"] == 7
    assert kw["delta"] == 3e-6
    assert kw["adaptive_rho"] is False and kw["scaled_termination"] is False
    # P passed as upper triangle (OSQP convention)
    P_dense = np.asarray(kw["P"].todense())
    np.testing.assert_allclose(P_dense, np.triu([[2.0, 0.5], [0.5, 1.0]]))

    assert int(sol.status) == QPSolutionStatus.Optimal
    assert int(sol.iters) == 13
    assert sol.primal.dtype == torch.float64
    np.testing.assert_allclose(sol.primal, [1.0, 2.0])


def test_osqp_bridge_scaling_off(fake_osqp):
    from smooth_feedback_tpu_torch.compat import solve_qp_osqp

    solve_qp_osqp(_small_qp(), QPSolverParams(scaling=False))
    assert _FakeOSQP.instances[-1].setup_kwargs["scaling"] == 0


def test_osqp_bridge_warmstart_passthrough(fake_osqp):
    from smooth_feedback_tpu_torch.compat import solve_qp_osqp

    z = torch.zeros((), **F64)
    ws = QPSolution(
        primal=torch.tensor([0.1, 0.2], **F64), dual=torch.tensor([0.3], **F64),
        status=torch.tensor(0, dtype=torch.int32), iters=torch.tensor(0, dtype=torch.int32),
        objective=z, primal_res=z, dual_res=z,
    )
    solve_qp_osqp(_small_qp(), QPSolverParams(), warmstart=ws)
    wx, wy = _FakeOSQP.instances[-1].warmstart_args
    np.testing.assert_allclose(wx, [0.1, 0.2])
    np.testing.assert_allclose(wy, [0.3])


@pytest.mark.parametrize(
    "osqp_status,expected",
    [
        ("solved", QPSolutionStatus.Optimal),
        ("solved inaccurate", QPSolutionStatus.Optimal),
        ("primal infeasible", QPSolutionStatus.PrimalInfeasible),
        ("dual infeasible", QPSolutionStatus.DualInfeasible),
        ("maximum iterations reached", QPSolutionStatus.MaxIterations),
        ("run time limit reached", QPSolutionStatus.MaxTime),
        ("interrupted", QPSolutionStatus.Unknown),
    ],
)
def test_osqp_bridge_status_map(fake_osqp, osqp_status, expected):
    from smooth_feedback_tpu_torch.compat import solve_qp_osqp

    orig_init = _FakeOSQP.__init__

    def patched(self):
        orig_init(self)
        self.status = osqp_status

    _FakeOSQP.__init__ = patched
    try:
        sol = solve_qp_osqp(_small_qp(), QPSolverParams())
    finally:
        _FakeOSQP.__init__ = orig_init
    assert int(sol.status) == expected


# ------------------------------------------------------------------- cyipopt


class _FakeIpoptProblem:
    """Records construction args/options; drives the callbacks once."""

    last = None

    def __init__(self, n, m, problem_obj, lb, ub, cl, cu):
        self.n, self.m = n, m
        self.obj = problem_obj
        self.lb, self.ub, self.cl, self.cu = (
            np.asarray(lb), np.asarray(ub), np.asarray(cl), np.asarray(cu)
        )
        self.options = {}
        self.ipopt_status = 0
        _FakeIpoptProblem.last = self

    def add_option(self, k, v):
        self.options[k] = v

    def solve(self, x0, lagrange=[], zl=[], zu=[]):
        x0 = np.asarray(x0)
        self.warmstart_seen = (
            (np.asarray(lagrange), np.asarray(zl), np.asarray(zu))
            if len(lagrange)
            else None
        )
        # exercise every callback the way Ipopt would
        fv = self.obj.objective(x0)
        gv = self.obj.gradient(x0)
        cv = self.obj.constraints(x0)
        jv = self.obj.jacobian(x0)
        assert np.isscalar(fv) or np.ndim(fv) == 0
        assert gv.shape == (self.n,)
        assert cv.shape == (self.m,)
        assert jv.shape == (self.m * self.n,)
        # drive the intermediate (per-iteration) callback like Ipopt does
        if hasattr(self.obj, "intermediate"):
            for it in range(6):
                assert (
                    self.obj.intermediate(
                        0, it, float(fv), 0.1, 0.1, 0.1, 0.1, 0.1, 1.0, 1.0, 1
                    )
                    is True
                )
        # exact-Hessian mode: drive eval_h the way Ipopt would
        self.hessian_seen = None
        if hasattr(self.obj, "hessian"):
            rows, cols = self.obj.hessianstructure()
            assert np.all(rows >= cols)  # lower triangle
            hv = self.obj.hessian(x0, np.full(self.m, 3.0), 0.5)
            assert hv.shape == rows.shape
            self.hessian_seen = (rows, cols, hv)
        info = {
            "status": self.ipopt_status,
            "obj_val": float(fv),
            "mult_x_L": np.zeros(self.n),
            "mult_x_U": np.zeros(self.n),
            "mult_g": np.full(self.m, 2.0),
        }
        return x0, info


@pytest.fixture
def fake_cyipopt(monkeypatch):
    mod = types.ModuleType("cyipopt")
    mod.Problem = _FakeIpoptProblem
    monkeypatch.setitem(sys.modules, "cyipopt", mod)
    return mod


def _small_nlp():
    # min (x0-1)^2 + x1^2  s.t. 0 <= x0 + x1 <= 1, -inf/inf var bounds
    return NLP(
        n=2, m=1,
        f=lambda x: (x[0] - 1.0) ** 2 + x[1] ** 2,
        g=lambda x: torch.stack([x[0] + x[1]]),
        xl=torch.tensor([-torch.inf, -5.0], **F64),
        xu=torch.tensor([torch.inf, 5.0], **F64),
        gl=torch.tensor([0.0], **F64),
        gu=torch.tensor([1.0], **F64),
    )


def test_ipopt_bridge_mapping(fake_cyipopt):
    from smooth_feedback_tpu_torch.compat import ipopt_available, solve_nlp_ipopt

    assert ipopt_available()
    sol = solve_nlp_ipopt(_small_nlp(), np.array([0.5, 0.5]), {"max_iter": 77})

    p = _FakeIpoptProblem.last
    # +-2e19 bound clipping
    np.testing.assert_allclose(p.lb, [-2e19, -5.0])
    np.testing.assert_allclose(p.ub, [2e19, 5.0])
    # default L-BFGS Hessian + option passthrough
    assert p.options["hessian_approximation"] == "limited-memory"
    assert p.options["max_iter"] == 77

    assert int(sol.status) == NLPSolutionStatus.Optimal
    # lambda sign flip: lam = -mult_g (Ipopt convention differs)
    np.testing.assert_allclose(sol.lam, [-2.0])
    np.testing.assert_allclose(sol.objective, 0.5)  # f at x0=(0.5,0.5)
    # iteration count through the intermediate callback (the fake drives
    # 6 iterations, 0..5)
    assert int(sol.iters) == 5


def test_ipopt_bridge_warmstart_passthrough(fake_cyipopt):
    """An NLPSolution warm start: primal overrides x0, multipliers pass
    through with the mult_g sign flip, warm_start_init_point is set."""
    from smooth_feedback_tpu_torch.compat import solve_nlp_ipopt

    ws = NLPSolution(
        status=torch.tensor(0, dtype=torch.int32), iters=torch.tensor(4, dtype=torch.int32),
        x=torch.tensor([0.25, 0.75], **F64),
        zl=torch.tensor([0.1, 0.0], **F64), zu=torch.tensor([0.0, 0.2], **F64),
        lam=torch.tensor([1.5], **F64),
        objective=torch.zeros((), **F64), kkt_res=torch.zeros((), **F64),
    )
    sol = solve_nlp_ipopt(_small_nlp(), np.zeros(2), warmstart=ws)
    p = _FakeIpoptProblem.last
    assert p.options["warm_start_init_point"] == "yes"
    lag, zl, zu = p.warmstart_seen
    np.testing.assert_allclose(lag, [-1.5])  # lam -> mult_g sign flip
    np.testing.assert_allclose(zl, [0.1, 0.0])
    np.testing.assert_allclose(zu, [0.0, 0.2])
    # the fake echoes its x0 back: proves warmstart.x overrode the x0 arg
    np.testing.assert_allclose(sol.x, [0.25, 0.75])
    assert int(sol.status) == NLPSolutionStatus.Optimal


def test_ipopt_bridge_exact_hessian(fake_cyipopt):
    """A HessianNLP routes the exact Lagrangian Hessian to eval_h and drops
    the L-BFGS option."""
    from smooth_feedback_tpu_torch.compat import solve_nlp_ipopt

    sol = solve_nlp_ipopt(with_hessians(_small_nlp()), np.array([0.5, 0.5]))
    assert int(sol.status) == NLPSolutionStatus.Optimal

    p = _FakeIpoptProblem.last
    assert "hessian_approximation" not in p.options
    rows, cols, hv = p.hessian_seen
    # obj_factor * H(f) + lam0 * H(g0) with H(f) = 2 I, H(g0) = 0; the fake
    # drives obj_factor = 0.5, lam = [3.0]
    H = np.zeros((2, 2))
    H[rows, cols] = hv
    np.testing.assert_allclose(H, 0.5 * 2.0 * np.eye(2), atol=1e-12)


@pytest.mark.parametrize(
    "ipopt_status,expected",
    [
        (0, NLPSolutionStatus.Optimal),
        (1, NLPSolutionStatus.Optimal),
        (2, NLPSolutionStatus.PrimalInfeasible),
        (4, NLPSolutionStatus.DualInfeasible),
        (-1, NLPSolutionStatus.IterationLimit),
        (-4, NLPSolutionStatus.IterationLimit),
        (5, NLPSolutionStatus.Unknown),
        (-2, NLPSolutionStatus.Unknown),
    ],
)
def test_ipopt_bridge_status_map(fake_cyipopt, ipopt_status, expected):
    from smooth_feedback_tpu_torch.compat import solve_nlp_ipopt

    orig_init = _FakeIpoptProblem.__init__

    def patched(self, *a, **kw):
        orig_init(self, *a, **kw)
        self.ipopt_status = ipopt_status

    _FakeIpoptProblem.__init__ = patched
    try:
        sol = solve_nlp_ipopt(_small_nlp(), np.array([0.5, 0.5]))
    finally:
        _FakeIpoptProblem.__init__ = orig_init
    assert int(sol.status) == expected


# --------------------------------------------------------------------- scipy


def test_scipy_bridge_matches_jax():
    """solve_nlp_scipy on a curved NLP (a circle constraint active at the
    optimum, a box bound inactive) against the JAX package's on the same
    problem: status equal, x within 1e-6; the result on the NLP's dtype."""
    c = np.array([1.5, 0.7])
    f = lambda x: (x[0] - c[0]) ** 2 + (x[1] - c[1]) ** 2 + 0.1 * x[0] * x[1]
    bounds = dict(xl=[-2.0, -2.0], xu=[2.0, 2.0], gl=[-np.inf, 0.0], gu=[1.0, np.inf])
    jnlp = JNLP(n=2, m=2, f=f, g=lambda x: jnp.stack([x @ x, x[0] + x[1] + 1.0]),
                **{k: jnp.asarray(v) for k, v in bounds.items()})
    tnlp = NLP(n=2, m=2, f=f, g=lambda x: torch.stack([x @ x, x[0] + x[1] + 1.0]),
               **{k: torch.tensor(v, **F64) for k, v in bounds.items()})
    x0 = np.array([0.1, -0.3])
    want = j_solve_nlp_scipy(jnlp, x0)
    got = solve_nlp_scipy(tnlp, x0)
    assert int(got.status) == int(want.status) == NLPSolutionStatus.Optimal
    assert got.x.dtype == torch.float64
    np.testing.assert_allclose(got.x, np.asarray(want.x), atol=1e-6)
    np.testing.assert_allclose(float(got.objective), float(want.objective), atol=1e-6)
    assert abs(float(got.x @ got.x) - 1.0) < 1e-6  # the circle is active

