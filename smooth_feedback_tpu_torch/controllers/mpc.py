"""Model-predictive control on Lie groups (PyTorch port of
``smooth_feedback_tpu/controllers/mpc.py``).

One MPC step linearizes the tracking OCP around the reference, transcribes it
to a QP, solves it with a warm start and applies ``u = udes(t) (+) du_0``.
Two paths are ported:

- the sparse path (``condense=False``): ``step`` and ``step.fleet`` transcribe
  every controller at its own clock and state (``torch.func.vmap`` of the
  transcription) and solve the batch in one ``solve_qp_batch`` call, each
  member with its own factorization unless ``reuse_factors=True`` and the
  state group is commutative; ``step.fleet_shared_t`` transcribes once for a
  fleet on one clock and sets each member's initial-condition bounds;
  ``time_varying=True`` hands f and cr the absolute time;
- the condensed, factor-reusing path (``reuse_factors=True, condense=True``):
  the dynamics and initial-condition rows are eliminated once on the host
  (float64), the condensed QP's scaling and KKT inverse are computed once,
  and each fleet step on a common clock costs one vectors-only template
  transcription, a few small GEMMs, one batched solve against the shared
  factors and an affine state recovery.

:class:`MPC` wraps a step and holds its warm start between calls.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from .._precision import ieee_f32_matmul
from ..groups.base import LieGroup
from ..ocp.collocation.mesh import Mesh
from ..ocp.ocp import OCP
from ..ocp.to_qp import ocp_to_qp, ocp_to_qp_vectors, variable_layout
from ..qp.solver import QPFactors, qp_factorize, solve_qp_batch
from ..qp.types import QPSolution, QPSolutionStatus, QPSolverParams, QuadraticProgram


@dataclasses.dataclass(frozen=True)
class MPCParams:
    K: int = 10  # minimum number of collocation points
    tf: float = 1.0  # horizon (seconds)
    warmstart: bool = True
    qp: QPSolverParams = dataclasses.field(default_factory=QPSolverParams)
    # predicted u/x trajectories at the mesh nodes (None when False)
    return_trajectories: bool = True


class MPCWeights(NamedTuple):
    Q: torch.Tensor  # (nx, nx) running state cost
    Qtf: torch.Tensor  # (nx, nx) terminal state cost
    R: torch.Tensor  # (nu, nu) running input cost


def default_weights(X: LieGroup, U: LieGroup, dtype=torch.float64, device="cuda") -> MPCWeights:
    """Identity weights on every state and input direction."""
    kw = dict(dtype=dtype, device=device)
    return MPCWeights(Q=torch.eye(X.ndof, **kw), Qtf=torch.eye(X.ndof, **kw), R=torch.eye(U.ndof, **kw))


class MPCStepResult(NamedTuple):
    u: torch.Tensor  # (..., u-params) control to apply
    status: torch.Tensor  # QPSolutionStatus of the QP solve
    warmstart: QPSolution  # carry for the next step
    u_traj: Optional[torch.Tensor]  # (..., N, u-params) predicted inputs (or None)
    x_traj: Optional[torch.Tensor]  # (..., N+1, x-params) predicted states (or None)


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def _build_condensation(qp0: QuadraticProgram, lay: dict, dtype, device):
    """Host-side (float64) one-time condensation of the template QP.

    The dynamics and initial-condition rows form a square invertible system
    in the state deviations, ``T dx = r - [0; E_u] du``, so
    ``dx = C0 r + Wx du`` with ``C0 = T^{-1}``, ``Wx = -C0 [0; E_u]``."""
    xL = lay["xvar_L"]
    uL = lay["uvar_L"]
    nx = lay["nx"]
    dL, crB, crL = lay["dcon_L"], lay["crcon_B"], lay["crcon_L"]
    ceB = lay["cecon_B"]

    A0 = qp0.A.detach().cpu().to(torch.float64).numpy()
    P0 = qp0.P.detach().cpu().to(torch.float64).numpy()

    IC = A0[ceB : ceB + nx, :]
    tol_ic = 50 * _eps(dtype)
    if not (
        np.allclose(IC[:, :nx], np.eye(nx), atol=tol_ic)
        and np.allclose(IC[:, nx:], 0.0, atol=tol_ic)
    ):
        raise ValueError(
            "condense: template initial-condition rows are not the identity "
            "block (is the template transcribed at x = xdes(0)?)"
        )

    E_x = A0[:dL, :xL]
    E_u = A0[:dL, xL:]
    T = np.concatenate([IC[:, :xL], E_x], axis=0)  # (xL, xL)
    condT = np.linalg.cond(T)
    limit = 0.03 / _eps(dtype)
    if not np.isfinite(condT) or condT > limit:
        raise ValueError(
            f"condense: dynamics/IC system too ill-conditioned for the "
            f"working dtype (cond {condT:.1e} > {limit:.1e})"
        )
    C0 = np.linalg.inv(T)
    Wx = -C0 @ np.concatenate([np.zeros((nx, uL)), E_u], axis=0)  # (xL, uL)

    P_xx = P0[:xL, :xL]
    P_xu = P0[:xL, xL:]
    P_uu = P0[xL:, xL:]
    Pc = Wx.T @ P_xx @ Wx + Wx.T @ P_xu + P_xu.T @ Wx + P_uu
    Pc = 0.5 * (Pc + Pc.T)
    M1 = Wx.T @ P_xx + P_xu.T  # (uL, xL): q_c = M1 w_x + Wx' q_x + q_u

    A_cr_x = A0[crB : crB + crL, :xL]
    A_cr_u = A0[crB : crB + crL, xL:]
    Ac = A_cr_u + A_cr_x @ Wx  # (crL, uL)

    j = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return dict(
        C0b=j(C0[:, :nx]),  # w_x member part: C0b @ b0
        C0d=j(C0[:, nx:]),  # w_x shared part: C0d @ b_dyn
        Wx=j(Wx),
        Pc=j(Pc),
        M1=j(M1),
        Ac=j(Ac),
        Bsh=j(A_cr_x),  # bound shift: l_c = l_cr - Bsh w_x
        P_xx=j(P_xx),  # objective offset: 0.5 w_x' P_xx w_x + q_x' w_x
    )


def _zero_ws(nvar: int, ncon: int, dtype, device) -> QPSolution:
    """A zero warm start of the right shapes."""
    kw = dict(dtype=dtype, device=device)
    return QPSolution(
        primal=torch.zeros((nvar,), **kw),
        dual=torch.zeros((ncon,), **kw),
        status=torch.tensor(int(QPSolutionStatus.Unknown), dtype=torch.int32, device=device),
        iters=torch.tensor(0, dtype=torch.int32, device=device),
        objective=torch.zeros((), **kw),
        primal_res=torch.full((), float("inf"), **kw),
        dual_res=torch.full((), float("inf"), **kw),
    )


_ACCEPT = (
    int(QPSolutionStatus.Optimal),
    int(QPSolutionStatus.MaxIterations),
    int(QPSolutionStatus.MaxTime),
)


def make_mpc_step(
    X: LieGroup,
    U: LieGroup,
    f: Callable,
    xdes: Callable,
    udes: Callable,
    *,
    weights: MPCWeights,
    params: MPCParams = MPCParams(),
    cr: Optional[Callable] = None,
    crl=None,
    cru=None,
    Kmesh: int = 4,
    dxdes: Optional[Callable] = None,
    dtype=torch.float64,
    device="cuda",
    reuse_factors: bool = False,
    time_varying: bool = False,
    validate_reuse: bool = True,
    condense: bool = False,
    static_reference: bool = False,
):
    """Build the functional MPC step.

    ``f(x, u)`` is the body-velocity dynamics, ``xdes``/``udes`` map absolute
    time (a 0-d tensor) to the reference, ``cr(x, u)`` with bounds
    ``crl``/``cru`` are optional running constraints.  With
    ``time_varying=True`` they are ``f(t, x, u)`` and ``cr(t, x, u)`` with
    absolute time ``t`` (incompatible with ``reuse_factors``: P and A then
    change between steps).  All tensors the
    callables create must use ``dtype`` and ``device``, and they must run
    under ``torch.func.vmap`` (no Python branch on tensor values).

    ``reuse_factors=True`` factorizes the template QP (transcribed at
    ``x = xdes(0)``) once, after checking at a perturbed ``(t, x)`` that P
    and A do not change away from the initial-condition rows.  For a
    non-commutative state group those rows carry ``dr_expinv`` of each
    member's offset, so ``step``/``step.fleet`` still factorize per member.
    ``condense=True`` (needs ``reuse_factors``) eliminates the states.

    Returns ``(step, init_warmstart)``: ``step(warmstart, t, x)`` runs one
    controller; ``step.fleet(warmstarts, ts, xs)`` runs a fleet on
    per-member clocks (sparse path); ``step.fleet_shared_t(warmstarts, t,
    xs)`` runs a fleet on a common clock (both paths);
    ``step.transcribe``/``step.transcribe_vectors`` expose the QP assembly."""
    if time_varying and reuse_factors:
        raise ValueError(
            "reuse_factors requires step-invariant QP matrices; time-varying "
            "dynamics/constraints change P/A every step"
        )
    if condense and not reuse_factors:
        raise ValueError(
            "condense=True eliminates states against the one-time template "
            "and therefore requires reuse_factors=True"
        )
    if static_reference and not condense:
        raise ValueError("static_reference requires condense=True")

    kw = dict(dtype=dtype, device=device)
    nx, nu = X.ndof, U.ndof
    n_ival = -(-params.K // Kmesh)  # ceil
    mesh = Mesh.uniform(n_ival, Kmesh, Kmin=Kmesh, Kmax=Kmesh)

    if cr is None:
        crl_ = torch.zeros((0,), **kw)
        cru_ = torch.zeros((0,), **kw)
    else:
        crl_ = torch.as_tensor(crl, **kw)
        cru_ = torch.as_tensor(cru, **kw)

    Q = torch.as_tensor(weights.Q, **kw)
    Qtf = torch.as_tensor(weights.Qtf, **kw)
    R = torch.as_tensor(weights.R, **kw)
    tf = params.tf

    def _make_ocp(t, x):
        xl_fun = lambda s: xdes(t + s)
        ul_fun = lambda s: udes(t + s)
        dxl_fun = None if dxdes is None else (lambda s: dxdes(t + s))
        if time_varying:
            f_ocp = lambda s, x_, u_: f(t + s, x_, u_)
        else:
            f_ocp = lambda s, x_, u_: f(x_, u_)
        if cr is None:
            cr_ocp = lambda s, x_, u_: torch.zeros((0,), **kw)
        elif time_varying:
            cr_ocp = lambda s, x_, u_: cr(t + s, x_, u_)
        else:
            cr_ocp = lambda s, x_, u_: cr(x_, u_)

        def theta(tf_, x0, xf, q):
            e = X.rminus(xf, xdes(t + tf))
            return q[0] + 0.5 * e @ Qtf @ e

        def g(s, x_, u_):
            ex = X.rminus(x_, xdes(t + s))
            eu = U.rminus(u_, udes(t + s))
            return (0.5 * ex @ Q @ ex + 0.5 * eu @ R @ eu).reshape(1)

        def ce(tf_, x0, xf, q):
            return X.rminus(x0, x)

        ocp = OCP(
            X=X, U=U, theta=theta, f=f_ocp, g=g, cr=cr_ocp, crl=crl_, cru=cru_,
            ce=ce, cel=torch.zeros((nx,), **kw), ceu=torch.zeros((nx,), **kw),
        )
        return ocp, xl_fun, ul_fun, dxl_fun

    def transcribe(t, x) -> QuadraticProgram:
        """The tracking QP at time ``t`` and state ``x``."""
        t = torch.as_tensor(t, **kw)
        ocp, xl_fun, ul_fun, dxl_fun = _make_ocp(t, x)
        return ocp_to_qp(ocp, mesh, tf, xl_fun, ul_fun, dxl_fun, **kw)

    def transcribe_vectors(t, x):
        """The ``(q, l, u)`` vectors of ``transcribe(t, x)`` only."""
        t = torch.as_tensor(t, **kw)
        ocp, xl_fun, ul_fun, dxl_fun = _make_ocp(t, x)
        return ocp_to_qp_vectors(ocp, mesh, tf, xl_fun, ul_fun, dxl_fun, **kw)

    ocp_probe = OCP(
        X=X, U=U, theta=None, f=None, g=None, cr=None, crl=crl_, cru=cru_, ce=None,
        cel=torch.zeros((nx,), **kw), ceu=torch.zeros((nx,), **kw),
    )
    lay = variable_layout(ocp_probe, mesh)
    N = lay["N"]
    taus = torch.as_tensor(np.asarray(mesh.all_nodes()), **kw)

    def _finalize(sol: QPSolution, warmstarts: QPSolution, t, du_all, dx_all) -> MPCStepResult:
        """Result assembly for a fleet: ``t`` is 0-d (common clock) or (B,)
        (per-member clocks); ``du_all`` (B, N, nu) and ``dx_all`` (B, N+1,
        nx) are the deviation trajectories of each path's own recovery."""
        B = int(du_all.shape[0])
        at = 0 if t.dim() == 1 else None  # vmap axis of the clock
        ref = (lambda fn: vmap(fn)(t)) if at == 0 else (lambda fn: fn(t))
        u = vmap(U.rplus, in_dims=(at, 0))(ref(udes), du_all[:, 0])

        # accept the warm start on Optimal / MaxIterations / MaxTime
        ok = (sol.status == _ACCEPT[0]) | (sol.status == _ACCEPT[1]) | (sol.status == _ACCEPT[2])
        new_ws = QPSolution(
            *(
                torch.where(ok.reshape((B,) + (1,) * (new.dim() - 1)), new, old)
                for new, old in zip(sol, warmstarts)
            )
        )
        if params.return_trajectories:
            uref = ref(lambda t_: vmap(lambda s: udes(t_ + tf * s))(taus[:N]))
            xref = ref(lambda t_: vmap(lambda s: xdes(t_ + tf * s))(taus))
            u_traj = vmap(vmap(U.rplus), in_dims=(at, 0))(uref, du_all)
            x_traj = vmap(vmap(X.rplus), in_dims=(at, 0))(xref, dx_all)
        else:
            u_traj = x_traj = None
        return MPCStepResult(u=u, status=sol.status, warmstart=new_ws, u_traj=u_traj, x_traj=x_traj)

    def _one(fleet_fn, warmstart: QPSolution, t, x) -> MPCStepResult:
        """One controller: ``fleet_fn`` on a batch of one."""
        res = fleet_fn(QPSolution(*(a[None] for a in warmstart)), t, x[None])
        return MPCStepResult(*(None if a is None else _index0(a) for a in res))

    t_zero = torch.zeros((), **kw)
    factors1 = factors_gen = None
    if reuse_factors:
        # template at x = xdes(0): the initial-condition block is exactly I there
        qp0 = transcribe(t_zero, xdes(t_zero))
        if validate_reuse:
            # a transcription at another time and a perturbed state must give
            # the same P/A away from the IC rows (those vary for a
            # non-commutative X, see factors_gen below)
            eps = 0.1 * torch.arange(1, nx + 1, **kw) / nx
            x_probe = X.rplus(X.identity(**kw), eps)
            qp1 = transcribe(torch.tensor(0.437, **kw), x_probe)
            tol = 50 * _eps(dtype)
            ce_rows = torch.as_tensor(lay["cecon_B"] + np.arange(nx), device=device)
            keep = torch.ones(lay["Ncon"], dtype=torch.bool, device=device)
            keep[ce_rows] = False
            for name, a0, a1 in (("P", qp0.P, qp1.P), ("A", qp0.A[keep], qp1.A[keep])):
                err = float((a1 - a0).abs().max())
                scale = 1.0 + float(a0.abs().max())
                if not err <= tol * scale:
                    raise ValueError(
                        f"reuse_factors: QP matrix {name} is not step-invariant "
                        f"(max deviation {err:.3e} at a perturbed (t, x))"
                    )
        if not condense:
            # shared (batch-free) template factors: fleet_shared_t iterates
            # every member against them (its IC rows are the template's
            # identity rows); step and step.fleet only for a commutative
            # state, whose full matrices, IC rows included, are step-invariant
            factors1 = QPFactors(*(a[0] for a in qp_factorize(
                QuadraticProgram(*(a[None] for a in qp0)), params.qp
            )))
            if X.is_commutative():
                factors_gen = factors1

    if not condense:
        uvar_B, xvar_L = lay["uvar_B"], lay["xvar_L"]

        def fleet(warmstarts: QPSolution, ts, xs) -> MPCStepResult:
            """Batched MPC step on per-member clocks: ``xs`` (B, x-params), ``ts``
            (B,) or a scalar, ``warmstarts`` a QPSolution with a leading batch
            axis.  Each member is transcribed at its own (t, x); the batch
            solves in one ``solve_qp_batch`` call."""
            with ieee_f32_matmul():
                B = int(xs.shape[0])
                ts = torch.as_tensor(ts, **kw).expand(B).contiguous()
                qps = vmap(transcribe)(ts, xs)
                if factors_gen is not None:
                    # shared factors: P and A are the template's for all members
                    qps = qps._replace(P=qps.P[:1], A=qps.A[:1])
                sol = solve_qp_batch(
                    qps, params.qp, warmstarts if params.warmstart else None, factors_gen
                )
                return _finalize(
                    sol, warmstarts, ts,
                    sol.primal[:, uvar_B:].reshape(B, N, nu),
                    sol.primal[:, :xvar_L].reshape(B, N + 1, nx),
                )

        ce_rows = torch.as_tensor(lay["cecon_B"] + np.arange(nx), device=device)

        def fleet_shared_t(warmstarts: QPSolution, t, xs) -> MPCStepResult:
            """Fleet step on a common clock ``t``: one transcription at
            ``x = xdes(t)``, where the initial-condition rows are exactly the
            identity, shared by the fleet; only those rows' bounds,
            ``-(xdes(t) (-) x)``, differ per member.  Exact for any state
            group: ``dr_expinv(c) dx0 = -c`` has the unique solution
            ``dx0 = -c`` that the identity rows pin, so primals equal the
            per-member transcription's.  With ``reuse_factors`` the fleet
            iterates against the template's shared factors."""
            with ieee_f32_matmul():
                t = torch.as_tensor(t, **kw)
                B = int(xs.shape[0])
                xd = xdes(t)
                qp1 = transcribe(t, xd)
                ce_bounds = -vmap(lambda x: X.rminus(xd, x))(xs)  # (B, nx)
                l_b = qp1.l[None].repeat(B, 1)
                u_b = qp1.u[None].repeat(B, 1)
                l_b[:, ce_rows] = ce_bounds
                u_b[:, ce_rows] = ce_bounds
                qps = QuadraticProgram(
                    P=qp1.P[None], q=qp1.q[None].expand(B, -1), A=qp1.A[None], l=l_b, u=u_b
                )
                sol = solve_qp_batch(
                    qps, params.qp, warmstarts if params.warmstart else None, factors1
                )
                return _finalize(
                    sol, warmstarts, t,
                    sol.primal[:, uvar_B:].reshape(B, N, nu),
                    sol.primal[:, :xvar_L].reshape(B, N + 1, nx),
                )

        def step(warmstart: QPSolution, t, x) -> MPCStepResult:
            return _one(fleet, warmstart, t, x)

        step.fleet = fleet
        step.fleet_shared_t = fleet_shared_t
        step.transcribe = transcribe
        step.transcribe_vectors = transcribe_vectors
        return step, _zero_ws(lay["Nvar"], lay["Ncon"], dtype, device)

    # the condensed path
    cond = _build_condensation(qp0, lay, dtype, device)
    uL, xL, dL = lay["uvar_L"], lay["xvar_L"], lay["dcon_L"]
    crB, crL = lay["crcon_B"], lay["crcon_L"]

    def _cond_pieces(t):
        """Shared per-step data from one vectors-only template transcription."""
        qv, lv, uv = transcribe_vectors(t, xdes(t))
        return lv[:dL], lv[crB : crB + crL], uv[crB : crB + crL], qv[:xL], qv[xL:]

    pieces0 = _cond_pieces(t_zero)
    if static_reference:
        probe = _cond_pieces(torch.tensor(0.37, **kw))
        tol_sr = 50 * _eps(dtype)
        for ref, got, nm in zip(pieces0, probe, ("b_dyn", "lcr", "ucr", "qx", "qu")):
            scale = 1.0 + (float(ref.abs().max()) if ref.numel() else 0.0)
            if not torch.allclose(ref, got, rtol=0.0, atol=tol_sr * scale):
                raise ValueError(
                    f"static_reference: template piece {nm!r} varies with t "
                    "(is xdes a group screw with constant udes?)"
                )
    b_dyn0, lcr0, ucr0 = pieces0[:3]
    wx0 = cond["C0d"] @ b_dyn0
    if crL > 0:
        Ac = cond["Ac"]
        l0 = lcr0 - cond["Bsh"] @ wx0
        u0 = ucr0 - cond["Bsh"] @ wx0
    else:
        # no running constraints: one unconstrained dummy row
        Ac = torch.zeros((1, uL), **kw)
        l0 = torch.full((1,), -float("inf"), **kw)
        u0 = torch.full((1,), float("inf"), **kw)
    qc0 = QuadraticProgram(
        P=cond["Pc"][None], q=torch.zeros((1, uL), **kw), A=Ac[None], l=l0[None], u=u0[None]
    )
    # shared (batch-free) factors: the whole fleet iterates against them
    cond_factors = QPFactors(*(a[0] for a in qp_factorize(qc0, params.qp)))

    def _condensed_qp(t, xs):
        """The fleet's condensed QPs at clock ``t`` (P and A shared, leading
        axis 1) and the affine state offsets ``wx`` (B, xL)."""
        B = int(xs.shape[0])
        if static_reference:
            b_dyn, lcr, ucr, qx, qu = pieces0
        else:
            b_dyn, lcr, ucr, qx, qu = _cond_pieces(t)
        xd = xdes(t)
        b0 = -vmap(lambda x: X.rminus(xd, x))(xs)  # (B, nx)

        wx_shared = cond["C0d"] @ b_dyn  # (xL,)
        wx = b0 @ cond["C0b"].T + wx_shared[None]  # (B, xL)
        q_c = wx @ cond["M1"].T + (cond["Wx"].T @ qx + qu)[None]  # (B, uL)
        if crL > 0:
            shift = wx @ cond["Bsh"].T  # (B, crL)
            l_b = lcr[None] - shift
            u_b = ucr[None] - shift
        else:
            l_b = torch.full((B, 1), -float("inf"), **kw)
            u_b = torch.full((B, 1), float("inf"), **kw)
        qps = QuadraticProgram(P=cond["Pc"][None], q=q_c, A=Ac[None], l=l_b, u=u_b)
        return qps, wx, qx

    def fleet_shared_t_condensed(warmstarts: QPSolution, t, xs) -> MPCStepResult:
        """Condensed fleet step on a common clock ``t``: ``xs`` is (B, x-params),
        ``warmstarts`` a QPSolution with a leading batch axis."""
        with ieee_f32_matmul():
            t = torch.as_tensor(t, **kw)
            B = int(xs.shape[0])
            qps, wx, qx = _condensed_qp(t, xs)
            sol = solve_qp_batch(
                qps, params.qp, warmstarts if params.warmstart else None, cond_factors
            )
            # the FULL-space objective (the du-space one misses the affine
            # offset of the eliminated states)
            off = 0.5 * torch.einsum("bi,ij,bj->b", wx, cond["P_xx"], wx) + wx @ qx
            sol = sol._replace(objective=sol.objective + off)
            return _finalize(
                sol, warmstarts, t,
                sol.primal.reshape(B, N, nu),
                (sol.primal @ cond["Wx"].T + wx).reshape(B, N + 1, nx),
            )

    def _no_fleet(*a, **k):
        raise NotImplementedError(
            "condense=True supports the common-clock paths only "
            "(step, fleet_shared_t); per-member clocks need per-member "
            "transcriptions, which defeats condensation"
        )

    def step(warmstart: QPSolution, t, x) -> MPCStepResult:
        return _one(fleet_shared_t_condensed, warmstart, t, x)

    step.fleet = _no_fleet
    step.fleet_shared_t = fleet_shared_t_condensed
    step.condensed_qp = lambda t, xs: _condensed_qp(torch.as_tensor(t, **kw), xs)[0]
    step.factors = cond_factors
    step.transcribe = transcribe
    step.transcribe_vectors = transcribe_vectors
    return step, _zero_ws(uL, max(crL, 1), dtype, device)


class MPC:
    """Stateful wrapper: builds the step once its reference and weights are
    set and holds the warm start between calls.  ``mpc(t, x) -> (u,
    status)``; the reference defaults to the identity state and input."""

    def __init__(
        self,
        X: LieGroup,
        U: LieGroup,
        f: Callable,
        *,
        weights: Optional[MPCWeights] = None,
        params: MPCParams = MPCParams(),
        cr: Optional[Callable] = None,
        crl=None,
        cru=None,
        Kmesh: int = 4,
        dtype=torch.float64,
        device="cuda",
        time_varying: bool = False,
    ):
        self.X, self.U, self.f = X, U, f
        self.params = params
        self._kw = dict(dtype=dtype, device=device)
        self.weights = weights if weights is not None else default_weights(X, U, **self._kw)
        self.cr, self.crl, self.cru = cr, crl, cru
        self.Kmesh = Kmesh
        self.time_varying = time_varying
        self._xdes = lambda t: X.identity(**self._kw)
        self._dxdes = None
        self._udes = lambda t: U.identity(**self._kw)
        self._step = None
        self._ws = None

    def _rebuild(self):
        self._step, self._ws = make_mpc_step(
            self.X, self.U, self.f, self._xdes, self._udes,
            weights=self.weights, params=self.params, cr=self.cr, crl=self.crl, cru=self.cru,
            Kmesh=self.Kmesh, dxdes=self._dxdes, time_varying=self.time_varying, **self._kw,
        )

    def set_xdes(self, xdes: Callable, dxdes: Optional[Callable] = None):
        """Desired state trajectory (absolute time) and, optionally, its body
        velocity."""
        self._xdes = xdes
        self._dxdes = dxdes
        self._step = None

    def set_udes(self, udes: Callable):
        """Desired input trajectory (absolute time)."""
        self._udes = udes
        self._step = None

    def set_xdes_rel(self, xdes_rel: Callable, t0=0.0):
        """Desired state trajectory in time relative to ``t0``; its body
        velocity comes from autodiff in time."""
        self.set_xdes(lambda t: xdes_rel(t - t0))

    def set_udes_rel(self, udes_rel: Callable, t0=0.0):
        """Desired input trajectory in time relative to ``t0``."""
        self.set_udes(lambda t: udes_rel(t - t0))

    def set_weights(self, weights: MPCWeights):
        self.weights = weights
        self._step = None

    def reset_warmstart(self):
        if self._ws is not None:
            self._ws = QPSolution(*(torch.zeros_like(a) for a in self._ws))

    def __call__(self, t, x):
        """One MPC step at time ``t`` and state ``x``: ``(u, status)``; the
        whole step result is kept as ``last_result``."""
        if self._step is None:
            self._rebuild()
        res = self._step(self._ws, t, x)
        self._ws = res.warmstart
        self.last_result = res
        return res.u, QPSolutionStatus(int(res.status))


def _index0(a):
    """Member 0 of a batched field (a tensor or a QPSolution)."""
    if isinstance(a, torch.Tensor):
        return a[0]
    return type(a)(*(f[0] for f in a))
