"""Active Set Invariance safety Filter (ASIF) on Lie groups (PyTorch port of
``smooth_feedback_tpu/controllers/asif.py``).

The filter minimally modifies a desired input so that barrier constraints
h(t, x) >= 0 stay invariant along a backup trajectory:

    min_{mu, delta}  mu' W_u mu + relax_cost delta^2
    s.t.             d/dt h(phi_t(x0)) >= -alpha h(phi_t(x0)) - delta  (K times)
                     u_des (+) mu in ulim,   delta >= 0

The transcription forward-integrates the backup closed loop x' = f(x,
bu(t, x)) with fixed steps, together with its body-frame sensitivity
S' = (-ad(f_cl) + d^r f_cl / dx) S, and emits one barrier row per constraint
time; the small dense QP (n = nu + 1 variables, m = K nh + nb + 1 rows) is
solved by ``solve_qp_batch``.  ``asif_to_qp_fleet`` transcribes a fleet with
the sensitivity stack batch-trailing, ``(nx, nx, B)``, as the JAX package
does; the user callables run under ``torch.func.vmap``.

Forward mode in torch 2.13 gives a 0-d float32 tangent times a Python scalar
(``-0.2 * x[4]`` inside ``f``) a float64 tangent (groups/_series.py avoids
the fault with 1-d views, which the user's callables cannot be given).  So
every tangent Jacobian of a user callable is cast back to the working dtype
(:func:`_jac`), and ``d h / d t``, whose 0-d argument would carry the fault
into any matrix product inside ``h``, is taken in reverse mode
(``torch.func.jacrev``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd, jacrev, vmap

from .._precision import ieee_f32_matmul
from ..groups.base import LieGroup, ad_generators
from ..qp.solver import solve_qp_batch
from ..qp.types import QPSolution, QPSolutionStatus, QPSolverParams, QuadraticProgram
from ..utils.bounds import ManifoldBounds, empty_bounds
from ..utils.linalg import mm_lane


@dataclasses.dataclass(frozen=True)
class ASIFtoQPParams:
    K: int = 10  # number of constraint instances over the horizon
    alpha: float = 1.0  # barrier decay rate
    dt: float = 0.1  # maximal integration step
    relax_cost: float = 100.0  # relaxation penalty


@dataclasses.dataclass(frozen=True)
class ASIFilterParams:
    T: float = 1.0  # backup horizon (fixes the number of steps)
    asif: ASIFtoQPParams = dataclasses.field(default_factory=ASIFtoQPParams)
    qp: QPSolverParams = dataclasses.field(default_factory=QPSolverParams)


def _jac(fn, z):
    """``jacfwd(fn)(z)`` in the dtype of ``z`` (see the module docstring)."""
    return jacfwd(fn)(z).to(z.dtype)


def _steps(prm: ASIFtoQPParams, T: float):
    """``(n_sub, hstep)``: substeps per constraint interval and their length."""
    tau = T / prm.K
    n_sub = max(1, int(-(-tau // prm.dt)))  # ceil(tau / dt)
    return n_sub, tau / n_sub


def _cost_matrix(prm: ASIFtoQPParams, W_u, kw):
    """The QP's cost matrix diag(W_u, relax_cost)."""
    return torch.diag_embed(
        torch.cat([torch.as_tensor(W_u, **kw), torch.full((1,), prm.relax_cost, **kw)])
    )


def asif_to_qp(
    X: LieGroup,
    U: LieGroup,
    prm: ASIFtoQPParams,
    T: float,
    x0: torch.Tensor,
    u_des: torch.Tensor,
    W_u,
    ulim: ManifoldBounds,
    f: Callable,
    h: Callable,
    bu: Callable,
) -> QuadraticProgram:
    """The ASIF QP of one state ``x0`` and desired input ``u_des``.

    ``f(x, u) -> (nx,)`` is the body-velocity dynamics, ``h(t, x) -> (nh,)``
    the barrier (safe set h >= 0), ``bu(t, x)`` the backup controller.  The
    QP has the dtype and device of ``x0``."""
    with ieee_f32_matmul():
        return _asif_to_qp_impl(X, U, prm, T, x0, u_des, W_u, ulim, f, h, bu)


def _asif_to_qp_impl(X, U, prm, T, x0, u_des, W_u, ulim, f, h, bu):
    nx, nu = X.ndof, U.ndof
    kw = dict(dtype=x0.dtype, device=x0.device)
    t = torch.zeros((), **kw)
    nh = int(h(t, x0).shape[0])
    n_sub, hstep = _steps(prm, T)
    zx = torch.zeros((nx,), **kw)
    zu = torch.zeros((nu,), **kw)

    # dynamics value and input Jacobian at the current state
    f0 = f(x0, u_des)
    df0_du = _jac(lambda v: f(x0, U.rplus(u_des, v)), zu)  # (nx, nu)

    def fcl(t_, x_):
        return f(x_, bu(t_, x_))

    x, S = x0, torch.eye(nx, **kw)
    Arows, lrows = [], []
    for _ in range(prm.K):
        # barrier row at the current constraint time
        hval = h(t, x)
        dh_dt = jacrev(lambda s: h(s, x))(t)  # (nh,)
        dh_dx = _jac(lambda w: h(t, X.rplus(x, w)), zx)  # (nh, nx)
        dh_dx0 = dh_dx @ S
        Arows.append(dh_dx0 @ df0_du)  # (nh, nu)
        lrows.append(-dh_dt - prm.alpha * hval - dh_dx0 @ f0)
        # integrate to the next constraint time; the sensitivity uses the
        # post-step state
        for _ in range(n_sub):
            x_new = X.rplus(x, hstep * fcl(t, x))
            fv = fcl(t, x_new)
            J = _jac(lambda w: fcl(t, X.rplus(x_new, w)), zx)
            S = S + hstep * ((-X.ad(fv) + J) @ S)
            t, x = t + hstep, x_new

    Kh = prm.K * nh
    A_bar = torch.stack(Arows).reshape(Kh, nu)
    du_c = ulim.A @ U.rminus(u_des, ulim.c)  # (nb,)
    nb = int(ulim.A.shape[0])
    one = torch.ones((1,), **kw)
    A = torch.cat([
        torch.cat([A_bar, torch.ones((Kh, 1), **kw)], dim=1),  # relaxation column
        torch.cat([ulim.A.to(**kw), torch.zeros((nb, 1), **kw)], dim=1),  # input bounds
        torch.cat([torch.zeros((1, nu), **kw), one[None]], dim=1),  # delta >= 0
    ])
    inf = float("inf")
    l = torch.cat([torch.stack(lrows).reshape(-1), ulim.l.to(**kw) - du_c, 0.0 * one])
    u = torch.cat([torch.full((Kh,), inf, **kw), ulim.u.to(**kw) - du_c, inf * one])
    P = _cost_matrix(prm, W_u, kw)
    return QuadraticProgram(P=P, q=torch.zeros((nu + 1,), **kw), A=A, l=l, u=u)


def asif_to_qp_fleet(
    X: LieGroup,
    U: LieGroup,
    prm: ASIFtoQPParams,
    T: float,
    xs: torch.Tensor,
    u_des: torch.Tensor,
    W_u,
    ulim: ManifoldBounds,
    f: Callable,
    h: Callable,
    bu: Callable,
) -> QuadraticProgram:
    """Fleet ASIF transcription: ``asif_to_qp`` of every member of ``xs``
    (B, x-params) and ``u_des`` (B, u-params), with the sensitivity stack
    carried batch-trailing as (nx, nx, B) and the per-member callables (f, h,
    bu and their tangent Jacobians) run batch-leading under ``vmap``.  P is
    the one cost matrix expanded to (B, N, N) without a copy."""
    with ieee_f32_matmul():
        return _asif_to_qp_fleet_impl(X, U, prm, T, xs, u_des, W_u, ulim, f, h, bu)


def _asif_to_qp_fleet_impl(X, U, prm, T, xs, u_des, W_u, ulim, f, h, bu):
    nx, nu = X.ndof, U.ndof
    B = int(xs.shape[0])
    kw = dict(dtype=xs.dtype, device=xs.device)
    t = torch.zeros((), **kw)
    nh = int(h(t, xs[0]).shape[0])
    n_sub, hstep = _steps(prm, T)
    zx = torch.zeros((nx,), **kw)
    zu = torch.zeros((nu,), **kw)
    # ad is linear: constant generators assemble ad(f_cl) batch-trailing
    # straight from the (nx, B) velocity stack
    adgen = ad_generators(X, **kw)

    f0t = vmap(f)(xs, u_des).T  # (nx, B)
    df0t = vmap(lambda x_, ud: _jac(lambda v: f(x_, U.rplus(ud, v)), zu))(xs, u_des)
    df0t = df0t.permute(1, 2, 0)  # (nx, nu, B)

    def fcl(t_, x_):
        return f(x_, bu(t_, x_))

    x = xs
    St = torch.eye(nx, **kw)[:, :, None].expand(nx, nx, B)
    Arows, lrows = [], []
    for _ in range(prm.K):
        hval = vmap(lambda xi: h(t, xi))(x)  # (B, nh)
        dh_dt = vmap(lambda xi: jacrev(lambda s: h(s, xi))(t))(x)  # (B, nh)
        dh_dx = vmap(lambda xi: _jac(lambda w: h(t, X.rplus(xi, w)), zx))(x)  # (B, nh, nx)
        dh_dx0 = mm_lane(dh_dx.permute(1, 2, 0), St)  # (nh, nx, B)
        Arows.append(mm_lane(dh_dx0, df0t))  # (nh, nu, B)
        lrows.append(-dh_dt.T - prm.alpha * hval.T - (dh_dx0 * f0t[None]).sum(dim=1))  # (nh, B)
        for _ in range(n_sub):
            fv0 = vmap(lambda xi: fcl(t, xi))(x)
            x_new = vmap(lambda xi, fi: X.rplus(xi, hstep * fi))(x, fv0)
            fv = vmap(lambda xi: fcl(t, xi))(x_new)
            J = vmap(lambda xi: _jac(lambda w: fcl(t, X.rplus(xi, w)), zx))(x_new)
            At = -torch.einsum("kij,kb->ijb", adgen, fv.T) + J.permute(1, 2, 0)
            St = St + hstep * mm_lane(At, St)
            t, x = t + hstep, x_new

    Kh = prm.K * nh
    nb = int(ulim.A.shape[0])
    A_bar = torch.stack(Arows).permute(3, 0, 1, 2).reshape(B, Kh, nu)
    du_c = vmap(lambda ud: ulim.A @ U.rminus(ud, ulim.c))(u_des)  # (B, nb)
    A = torch.cat([
        torch.cat([A_bar, torch.ones((B, Kh, 1), **kw)], dim=2),
        torch.cat([ulim.A.to(**kw), torch.zeros((nb, 1), **kw)], dim=1).expand(B, nb, nu + 1),
        torch.cat([torch.zeros((1, nu), **kw), torch.ones((1, 1), **kw)], dim=1).expand(B, 1, nu + 1),
    ], dim=1)
    inf = float("inf")
    l = torch.cat([
        torch.stack(lrows).permute(2, 0, 1).reshape(B, Kh),
        ulim.l.to(**kw)[None] - du_c,
        torch.zeros((B, 1), **kw),
    ], dim=1)
    u = torch.cat([
        torch.full((B, Kh), inf, **kw), ulim.u.to(**kw)[None] - du_c, torch.full((B, 1), inf, **kw),
    ], dim=1)
    P = _cost_matrix(prm, W_u, kw)
    return QuadraticProgram(
        P=P.expand(B, nu + 1, nu + 1), q=torch.zeros((B, nu + 1), **kw), A=A, l=l, u=u
    )


class ASIFStepResult(NamedTuple):
    u: torch.Tensor  # filtered input
    status: torch.Tensor
    warmstart: QPSolution


_ACCEPT = (
    int(QPSolutionStatus.Optimal),
    int(QPSolutionStatus.MaxIterations),
    int(QPSolutionStatus.MaxTime),
)


def make_asif_step(
    X: LieGroup,
    U: LieGroup,
    f: Callable,
    h: Callable,
    bu: Callable,
    *,
    params: ASIFilterParams = ASIFilterParams(),
    W_u=None,
    ulim: Optional[ManifoldBounds] = None,
    dtype=torch.float64,
    device="cuda",
):
    """Build the functional ASIF step.

    Returns ``(step, init_warmstart)``: ``step(warmstart, x, u_des)`` filters
    one input and ``step.fleet(warmstarts, xs, u_des)`` a fleet (one
    ``asif_to_qp_fleet`` transcription and one batched solve), each giving
    an :class:`ASIFStepResult` with the minimally modified input
    ``u_des (+) mu``.  The callables must create their tensors with
    ``dtype`` and ``device`` and run under ``torch.func.vmap``."""
    kw = dict(dtype=dtype, device=device)
    nu = U.ndof
    W_u = torch.ones((nu,), **kw) if W_u is None else torch.as_tensor(W_u, **kw)
    if ulim is None:
        ulim = empty_bounds(U, **kw)
    nh = int(h(torch.zeros((), **kw), X.identity(**kw)).shape[0])
    M = params.asif.K * nh + int(ulim.A.shape[0]) + 1
    N = nu + 1

    def _finalize(sol: QPSolution, warmstarts: QPSolution, u_des) -> ASIFStepResult:
        B = int(u_des.shape[0])
        u = vmap(U.rplus)(u_des, sol.primal[:, :nu])
        st = sol.status
        ok = (st == _ACCEPT[0]) | (st == _ACCEPT[1]) | (st == _ACCEPT[2])
        new_ws = QPSolution(*(
            torch.where(ok.reshape((B,) + (1,) * (new.dim() - 1)), new, old)
            for new, old in zip(sol, warmstarts)
        ))
        return ASIFStepResult(u=u, status=st, warmstart=new_ws)

    def step(warmstart: QPSolution, x, u_des) -> ASIFStepResult:
        qp = asif_to_qp(X, U, params.asif, params.T, x, u_des, W_u, ulim, f, h, bu)
        ws_b = QPSolution(*(a[None] for a in warmstart))
        sol = solve_qp_batch(QuadraticProgram(*(a[None] for a in qp)), params.qp, ws_b)
        res = _finalize(sol, ws_b, u_des[None])
        return ASIFStepResult(res.u[0], res.status[0], QPSolution(*(a[0] for a in res.warmstart)))

    def fleet_step(warmstarts: QPSolution, xs, u_des) -> ASIFStepResult:
        """Batched ASIF step: one fleet transcription, one batched solve."""
        qps = asif_to_qp_fleet(X, U, params.asif, params.T, xs, u_des, W_u, ulim, f, h, bu)
        return _finalize(solve_qp_batch(qps, params.qp, warmstarts), warmstarts, u_des)

    step.fleet = fleet_step

    init_ws = QPSolution(
        primal=torch.zeros((N,), **kw),
        dual=torch.zeros((M,), **kw),
        status=torch.tensor(int(QPSolutionStatus.Unknown), dtype=torch.int32, device=device),
        iters=torch.tensor(0, dtype=torch.int32, device=device),
        objective=torch.zeros((), **kw),
        primal_res=torch.full((), float("inf"), **kw),
        dual_res=torch.full((), float("inf"), **kw),
    )
    return step, init_ws


class ASIFilter:
    """Stateful wrapper holding the warm start between calls:
    ``filter(x, u_des) -> (u, status)``."""

    def __init__(self, X, U, f, h, bu, *, params=ASIFilterParams(), W_u=None, ulim=None,
                 dtype=torch.float64, device="cuda"):
        self._step, self._ws = make_asif_step(
            X, U, f, h, bu, params=params, W_u=W_u, ulim=ulim, dtype=dtype, device=device
        )

    def __call__(self, x, u_des):
        res = self._step(self._ws, x, u_des)
        self._ws = res.warmstart
        return res.u, QPSolutionStatus(int(res.status))
