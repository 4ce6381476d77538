"""Line-search SQP for nonlinear programs (PyTorch port of
``smooth_feedback_tpu/solvers/sqp.py``).

* derivatives (gradient, constraint Jacobian, Lagrangian Hessian) come from
  ``torch.func`` of the NLP's callables, batched over a fleet with
  ``torch.func.vmap``;
* each subproblem is a dense QP with its own factors, solved by
  ``solve_qp_batch`` and warm-started across SQP iterations: on
  ``backend="cuda"`` one launch of the per-problem ADMM kernel
  (``csrc/admm_problem.cu``) per SQP iteration for the whole fleet;
* the Lagrangian Hessian is convexified by an exact equality-row
  augmentation and a shifted-Cholesky trial loop, each refined by geometric
  bisection;
* a non-monotone (watchdog) backtracking line search on the l1 merit
  function picks the step from a fixed grid.

The JAX package's ``lax.while_loop``s are host loops here: the fleet
iterates in lockstep while any member runs, and members that are done
freeze exactly as there (mask-and-continue).  The single-problem form
:func:`solve_nlp_sqp` runs the same loop on a fleet of one, which takes the
same steps as the JAX package's single form.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.func import grad, jacrev, vmap
from torch.utils._pytree import tree_map

from .._func import hessian
from .._precision import ieee_f32_matmul
from ..nlp import NLP, NLPSolution, NLPSolutionStatus
from ..qp.solver import solve_qp_batch
from ..qp.types import QPSolution, QPSolutionStatus, QPSolverParams, QuadraticProgram
from ..utils.compensated import stationarity_compensated

_OPTIMAL = int(QPSolutionStatus.Optimal)
_POLISH_FAILED = int(QPSolutionStatus.PolishFailed)
_MAX_ITER = int(QPSolutionStatus.MaxIterations)


@dataclasses.dataclass(frozen=True)
class SQPParams:
    """The JAX package's ``SQPParams``; its comments give the measurements
    behind each default."""

    max_iter: int = 100
    tol: float = 1e-6  # KKT inf-norm tolerance
    # adaptive rho: the equality-augmented Hessians condition the subproblems
    qp: QPSolverParams = dataclasses.field(
        default_factory=lambda: QPSolverParams(
            eps_abs=1e-9, eps_rel=1e-9, max_iter=4000, polish=True, adaptive_rho=True,
        )
    )
    reg_init: float = 1e-6
    reg_min: float = 1e-8
    reg_max: float = 1e8
    # geometric-bisection steps refining the Hessian shift bracket
    reg_bisect: int = 6
    ls_steps: int = 16  # backtracking grid size (alpha = 0.5**k)
    armijo: float = 1e-4
    # non-monotone (watchdog) line search: accept against the largest merit
    # of the last M iterates (the Maratos-effect remedy); 1 = monotone
    nonmonotone_M: int = 4
    # equality-row Hessian augmentation c * A_E' A_E (0 disables): exact on
    # every QP-feasible step, PD for a finite c where the reduced Hessian is
    aug_eq: float = 1.0
    # compensated (two-float) KKT stationarity, f64-like in f32
    compensated_kkt: bool = False
    verbose: bool = False  # a host line per SQP iteration
    hessian: str = "exact"  # "exact" (autodiff) or "bfgs" (damped BFGS)
    # fleet chunking (solve_nlp_sqp_batch only; None = one lockstep loop)
    chunk_size: Optional[int] = None
    # per-member total inner-ADMM budget; exhausting it freezes the member
    # as IterationLimit for rescue_nonoptimal (None = unbounded)
    qp_budget: Optional[int] = None
    # difficulty probe for chunked fleets: probe_iters unchunked SQP
    # iterations at an inner cap of probe_qp_cap, then members sorted into
    # chunks by observed difficulty
    probe_iters: int = 0
    probe_qp_cap: int = 200
    # stall freeze (None = off): no stall_ratio KKT progress for stall_iters
    # consecutive iterations freezes a member as IterationLimit
    stall_iters: Optional[int] = None
    stall_ratio: float = 0.5


def _zero_qp_ws(prefix: tuple, n: int, m: int, dtype, device) -> QPSolution:
    """Zero inner-QP warm start with the subproblem's (m + n dual) shapes."""
    kw = dict(dtype=dtype, device=device)
    return QPSolution(
        primal=torch.zeros(prefix + (n,), **kw),
        dual=torch.zeros(prefix + (m + n,), **kw),
        status=torch.full(prefix, int(QPSolutionStatus.Unknown), dtype=torch.int32, device=device),
        iters=torch.zeros(prefix, dtype=torch.int32, device=device),
        objective=torch.zeros(prefix, **kw),
        primal_res=torch.full(prefix, float("inf"), **kw),
        dual_res=torch.full(prefix, float("inf"), **kw),
    )


def solve_nlp_sqp(
    nlp: NLP,
    x0: torch.Tensor,
    params: SQPParams = SQPParams(),
    lam0: Optional[torch.Tensor] = None,
) -> NLPSolution:
    """Solve one NLP with line-search SQP: the lockstep loop of
    :func:`solve_nlp_sqp_batch` on a fleet of one, whose subproblems are QP
    batches of one (on ``backend="cuda"`` one ``admm_problem`` launch at
    B = 1 per SQP iteration).  Runs on ``x0``'s device."""
    theta = torch.zeros((1,), dtype=x0.dtype, device=x0.device)
    with ieee_f32_matmul():
        sol = _solve_nlp_sqp_batch_impl(
            lambda _: nlp, theta, x0[None], params, None if lam0 is None else lam0[None]
        )
    return NLPSolution(*(a[0] for a in sol))


def solve_nlp_sqp_batch(
    make_nlp,
    thetas,
    x0: torch.Tensor,
    params: SQPParams = SQPParams(),
    lam0: Optional[torch.Tensor] = None,
    sort_key: Optional[torch.Tensor] = None,
) -> NLPSolution:
    """Solve a fleet of structurally identical NLPs in one lockstep SQP.

    ``make_nlp(theta) -> NLP`` must run under ``torch.func.vmap`` in
    ``theta`` (a tensor, or a tuple/list/dict of tensors, each with a
    leading batch axis B: the members' problem data); every member shares
    (n, m).  ``x0`` is (B, n).  Returns an :class:`NLPSolution` with a
    leading batch axis, on ``x0``'s device.

    With ``params.chunk_size`` set the fleet runs as sequential chunks of
    that size, and an optional ``sort_key`` (B,) orders the members by
    expected difficulty first (``params.probe_iters`` measures one);
    results are inverse-permuted.  A chunk pays only its own worst member."""
    with ieee_f32_matmul():
        cs = params.chunk_size
        B = x0.shape[0]
        if cs is None or B <= cs:
            return _solve_nlp_sqp_batch_impl(make_nlp, thetas, x0, params, lam0)

        if lam0 is None:
            m = make_nlp(tree_map(lambda a: a[0], thetas)).m
            lam0 = torch.zeros((B, m), dtype=x0.dtype, device=x0.device)

        probe = None
        if params.probe_iters > 0 and sort_key is None:
            probe_prm = dataclasses.replace(
                params,
                max_iter=params.probe_iters,
                probe_iters=0,
                chunk_size=None,
                qp=dataclasses.replace(
                    params.qp, max_iter=min(params.qp.max_iter, params.probe_qp_cap)
                ),
            )
            probe = _solve_nlp_sqp_batch_impl(make_nlp, thetas, x0, probe_prm, lam0)
            # observed inner iterations, then (members at the probe's cap)
            # the log-distance of the KKT residual from tol
            sort_key = probe.qp_iters.to(x0.dtype) + 10.0 * torch.clamp(
                torch.log10(torch.clamp(probe.kkt_res, min=1e-12) / params.tol), 0.0, 30.0
            )
            x0, lam0 = probe.x, probe.lam

        perm = None
        if sort_key is not None:
            perm = torch.argsort(sort_key, stable=True)
            thetas = tree_map(lambda a: a[perm], thetas)
            x0, lam0 = x0[perm], lam0[perm]

        # sequential chunks, the last padded with copies of its fleet's first
        # member (the JAX package's lax.map over a chunk-shaped program)
        n_chunks = -(-B // cs)
        pad = n_chunks * cs - B

        def chunk(a, k):
            if pad:
                a = torch.cat([a, a[:1].expand((pad,) + a.shape[1:])])
            return a[k * cs : (k + 1) * cs]

        parts = [
            _solve_nlp_sqp_batch_impl(
                make_nlp, tree_map(lambda a: chunk(a, k), thetas), chunk(x0, k), params,
                chunk(lam0, k),
            )
            for k in range(n_chunks)
        ]
        sol = NLPSolution(*(torch.cat(f)[:B] for f in zip(*parts)))
        if perm is not None:
            inv = torch.argsort(perm)
            sol = NLPSolution(*(a[inv] for a in sol))
        if probe is not None:
            # the probe's iterations are solve work the main pass continued from
            sol = sol._replace(iters=sol.iters + probe.iters, qp_iters=sol.qp_iters + probe.qp_iters)
        return sol


def _max0(a):
    """Row maxima of a (B, k) tensor with an initial value of 0."""
    return a.amax(dim=1) if a.shape[1] else a.new_zeros(a.shape[0])


def _chol_ok(M):
    """Per-member success of a batched Cholesky: a finite factor."""
    L, info = torch.linalg.cholesky_ex(M)
    return (info == 0) & torch.isfinite(L).all(dim=2).all(dim=1)


def _solve_nlp_sqp_batch_impl(make_nlp, thetas, x0, params, lam0, trace=None):
    """The lockstep loop.  ``trace``, if given, is called as ``trace(stage,
    info)`` in every iteration: at its start (``"start"``) and after each of
    its stages, ``"hessian"``, ``"convexify"``, ``"qp"`` (``info``: the
    subproblem batch ``qp``, its warm start ``ws`` and solution ``sol``),
    ``"line_search"`` and ``"derivatives"`` (f, g, gradient, Jacobian and
    KKT residual at the new iterate); ``info`` is None elsewhere.  It is
    how a profile times the stages; the public entry points pass none."""
    nlp0 = make_nlp(tree_map(lambda a: a[0], thetas))
    n, m = nlp0.n, nlp0.m
    B = x0.shape[0]
    dt, dev = x0.dtype, x0.device
    kw = dict(dtype=dt, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    inf = float("inf")
    exact = params.hessian == "exact"
    trace = trace or (lambda stage, info: None)

    # batched evaluation of the members' callables
    fB = vmap(lambda th, x: make_nlp(th).f(x))
    gB = vmap(lambda th, x: make_nlp(th).g(x))
    gradB = vmap(lambda th, x: grad(make_nlp(th).f)(x))
    JB = vmap(lambda th, x: jacrev(make_nlp(th).g)(x))

    def lagrangian_hessian(th, x, lam):
        nlp = make_nlp(th)
        return hessian(lambda xx: nlp.f(xx) + lam @ nlp.g(xx))(x)

    hessB = vmap(lagrangian_hessian)
    xl, xu, gl, gu = (
        a.to(dt) for a in vmap(lambda th: tuple(make_nlp(th)[4:8]))(thetas)
    )  # (B, n) x2, (B, m) x2

    eyeN = torch.eye(n, **kw)
    eyeN_b = eyeN.expand(B, n, n)
    alphas = 0.5 ** torch.arange(params.ls_steps, **kw)
    eps = torch.finfo(dt).eps

    # per-element equality-row masks (l == u; inf/nan bound differences
    # compare False and stay inequalities)
    eq_g = ((gu - gl) <= 0.0).to(dt)
    eq_x = ((xu - xl) <= 0.0).to(dt)

    def violation_b(x, gval):
        vg = (torch.clamp(gl - gval, min=0.0) + torch.clamp(gval - gu, min=0.0)).sum(dim=1)
        vx = (torch.clamp(xl - x, min=0.0) + torch.clamp(x - xu, min=0.0)).sum(dim=1)
        return vg + vx

    def kkt_residual_b(x, lam, z, gval, grad_, J):
        if params.compensated_kkt:
            stat = stationarity_compensated(grad_, J, lam, z)
        else:
            stat = (grad_ + torch.einsum("bmn,bm->bn", J, lam) + z).abs().amax(dim=1)
        vg = _max0(torch.maximum(torch.clamp(gl - gval, min=0.0), torch.clamp(gval - gu, min=0.0)))
        vx = _max0(torch.maximum(torch.clamp(xl - x, min=0.0), torch.clamp(x - xu, min=0.0)))
        return torch.maximum(stat, torch.maximum(vg, vx))

    def status_in(status, *codes):
        out = torch.zeros_like(status, dtype=torch.bool)
        for c in codes:
            out = out | (status == c)
        return out

    # state (the JAX package's _BState), each with a leading batch axis
    x = x0.to(dt)
    lam = torch.zeros((B, m), **kw) if lam0 is None else lam0.to(dt)
    z = torch.zeros((B, n), **kw)
    reg = torch.full((B,), params.reg_init, **kw)
    tau = torch.full((B,), params.reg_init, **kw)
    caug = torch.zeros((B,), **kw)
    kkt = torch.full((B,), inf, **kw)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    failed = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), **i32)
    qp_iters = torch.zeros((B,), **i32)
    kkt_mark = torch.full((B,), inf, **kw)
    stall_ct = torch.zeros((B,), **i32)
    qp_ws = _zero_qp_ws((B,), n, m, dt, dev)
    fval, gval = fB(thetas, x), gB(thetas, x)
    grad_v, J = gradB(thetas, x), JB(thetas, x)
    Hb = eyeN_b
    M = max(1, params.nonmonotone_M)
    fh = fval[:, None].repeat(1, M)
    vh = violation_b(x, gval)[:, None].repeat(1, M)

    it = 0
    while it < params.max_iter and not bool(done.all()):
        trace("start", None)
        run = ~done
        c_aug = torch.zeros((B,), **kw)
        if exact:
            H = hessB(thetas, x, lam)
            H = 0.5 * (H + H.mT)
            trace("hessian", None)
            floor = torch.clamp(reg, min=params.reg_min)
            if params.aug_eq > 0.0:
                # exact equality-row augmentation: escalate c x10 (per member,
                # while any member fails) until chol(H + c G + floor I)
                # succeeds, warm-started from the last iteration's c
                G = torch.einsum("bmi,bm,bmj->bij", J, eq_g, J) + eq_x[:, :, None] * eyeN
                gmax = G.abs().amax(dim=(1, 2))
                c_unit = params.aug_eq * (1.0 + H.abs().amax(dim=(1, 2))) / (1.0 + gmax)
                # dtype-aware cap: past cond ~ eps^-0.75 the Cholesky test
                # fails from rounding, not indefiniteness
                c_cap = c_unit / eps**0.75
                c = torch.minimum(torch.maximum(caug / 10.0, c_unit), c_cap)

                def ok_c(c):
                    return _chol_ok(H + c[:, None, None] * G + floor[:, None, None] * eyeN)

                ok = ok_c(c)
                while bool((~ok & (c < c_cap) & (gmax > 0.0)).any()):
                    c = torch.where(ok, c, 10.0 * c)
                    ok = ok | ok_c(c)
                c_ok = ok
                # bisect toward the least PD-making c: an overshot c
                # conditions the inner ADMM subproblems
                lo, hi = c / 10.0, c
                for _ in range(params.reg_bisect):
                    mid = torch.sqrt(lo * hi)
                    ok = ok_c(mid)
                    lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
                # the tau shift takes over where escalation never succeeded
                # and while the member's subproblems are iteration-capped
                c_aug = torch.where(c_ok, hi, 0.0)
                c_aug = torch.where(qp_ws.status == _MAX_ITER, 0.0, c_aug)
                H = H + c_aug[:, None, None] * G
            # shifted-Cholesky convexification: escalate tau x10 until
            # chol(H + tau I) succeeds, then geometric bisection
            t = torch.maximum(tau / 10.0, floor)
            ok = _chol_ok(H + t[:, None, None] * eyeN)
            while bool((~ok & (t < params.reg_max)).any()):
                t = torch.where(ok, t, 10.0 * t)
                ok = ok | _chol_ok(H + t[:, None, None] * eyeN)
            lo, hi = t / 10.0, t
            for _ in range(params.reg_bisect):
                mid = torch.sqrt(lo * hi)
                ok = _chol_ok(H + mid[:, None, None] * eyeN)
                lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
            tau_new = torch.maximum(hi, floor)
            H = H + tau_new[:, None, None] * eyeN
        else:
            tau_new = tau
            H = Hb + reg[:, None, None] * eyeN
        trace("convexify", None)

        # one batched QP subproblem in the step d, per-problem factors
        qp_b = QuadraticProgram(
            P=H, q=grad_v, A=torch.cat([J, eyeN_b], dim=1),
            l=torch.cat([gl - gval, xl - x], dim=1), u=torch.cat([gu - gval, xu - x], dim=1),
        )
        sol = solve_qp_batch(qp_b, params.qp, qp_ws)
        trace("qp", dict(qp=qp_b, ws=qp_ws, sol=sol))
        d = sol.primal
        lam_qp = torch.where(torch.isfinite(sol.dual[:, :m]), sol.dual[:, :m], 0.0)
        z_qp = torch.where(torch.isfinite(sol.dual[:, m:]), sol.dual[:, m:], 0.0)
        # MaxIterations iterates are still descent directions (the merit
        # search rejects them if not); certificates and non-finite steps are not
        qp_ok = status_in(sol.status, _OPTIMAL, _POLISH_FAILED, _MAX_ITER) & torch.isfinite(d).all(dim=1)
        d = torch.where(qp_ok[:, None], d, 0.0)
        # undo the augmentation's known multiplier shift (lam' = lam - c A_E d)
        lam_qp = lam_qp + c_aug[:, None] * eq_g * torch.einsum("bmn,bn->bm", J, d)
        z_qp = z_qp + c_aug[:, None] * eq_x * d
        # an unconverged subproblem's dual under augmentation is amplified
        # by c_aug: keep the previous multipliers then
        converged = status_in(sol.status, _OPTIMAL, _POLISH_FAILED)
        dual_ok = converged | (c_aug <= 0.0)
        lam_qp = torch.where(dual_ok[:, None], lam_qp, lam)
        z_qp = torch.where(dual_ok[:, None], z_qp, z)

        # l1 merit line search on the shared alpha grid, per member
        mu = 2.0 * torch.clamp(_max0(lam_qp.abs()), min=1.0) + 1.0
        viol0 = violation_b(x, gval)
        phi0 = fval + mu * viol0
        dd = (grad_v * d).sum(dim=1) - mu * viol0

        def merit(alpha):
            xa = x + alpha * d
            return fB(thetas, xa) + mu * violation_b(xa, gB(thetas, xa))

        phis = vmap(merit)(alphas)  # (L, B)
        phis = torch.where(torch.isfinite(phis), phis, inf)
        # relative merit tolerance: accept eps-level ties near a solution
        eps_m = 10.0 * eps * (1.0 + phi0.abs())
        # watchdog reference: the largest merit of the last M iterates
        phi_ref = torch.maximum((fh + mu[:, None] * vh).amax(dim=1), phi0)
        armijo_ok = phis <= phi_ref + params.armijo * alphas[:, None] * dd + eps_m
        any_ok = armijo_ok.any(dim=0)
        first_ok = torch.argmax(armijo_ok.to(torch.int8), dim=0)
        best = torch.argmin(phis, dim=0)
        pick = torch.where(any_ok, first_ok, best)
        phi_best = phis.gather(0, best[None])[0]
        alpha = torch.where(qp_ok & (any_ok | (phi_best < phi_ref)), alphas[pick], 0.0)

        x_new = x + alpha[:, None] * d
        trace("line_search", None)
        # full dual step for converged subproblems (Han-Powell), the alpha
        # blend for iteration-capped ones
        a_ = alpha[:, None]
        lam_new = torch.where(converged[:, None], lam_qp, (1 - a_) * lam + a_ * lam_qp)
        z_new = torch.where(converged[:, None], z_qp, (1 - a_) * z + a_ * z_qp)

        reg_new = torch.where(
            alpha >= 0.5,
            torch.clamp(reg / 10.0, min=params.reg_min),
            torch.where(alpha <= 1e-3, torch.clamp(reg * 10.0 + 1e-6, max=params.reg_max), reg),
        )

        f_new, g_new = fB(thetas, x_new), gB(thetas, x_new)
        grad_new, J_new = gradB(thetas, x_new), JB(thetas, x_new)
        kkt_new = kkt_residual_b(x_new, lam_new, z_new, g_new, grad_new, J_new)
        done_new = kkt_new <= params.tol
        trace("derivatives", None)

        if params.hessian == "bfgs":
            # damped (Powell) BFGS on the Lagrangian gradient
            s_v = x_new - x
            y_v = (grad_new + torch.einsum("bmn,bm->bn", J_new, lam_new)) - (
                grad_v + torch.einsum("bmn,bm->bn", J, lam_new)
            )
            Hs = torch.einsum("bij,bj->bi", Hb, s_v)
            sHs = (s_v * Hs).sum(dim=1)
            sy = (s_v * y_v).sum(dim=1)
            ok_upd = (alpha > 0) & (sHs > 1e-12)
            theta = torch.where(
                sy >= 0.2 * sHs, 1.0, 0.8 * sHs / torch.clamp(sHs - sy, min=1e-12)
            )
            y_t = theta[:, None] * y_v + (1 - theta)[:, None] * Hs
            sty = torch.clamp((s_v * y_t).sum(dim=1), min=1e-12)
            Hb_new = (
                Hb
                - Hs[:, :, None] * Hs[:, None, :] / torch.clamp(sHs, min=1e-12)[:, None, None]
                + y_t[:, :, None] * y_t[:, None, :] / sty[:, None, None]
            )
            Hb_new = 0.5 * (Hb_new + Hb_new.mT)
            Hb_new = torch.where(ok_upd[:, None, None], Hb_new, Hb)
        else:
            Hb_new = Hb

        if params.verbose:
            print(
                f"[sqp/batch] it {it}: running {int(run.sum())}/{B} kkt med "
                f"{float(torch.quantile(kkt_new.double(), 0.5)):.3e} max {float(kkt_new.max()):.3e} "
                f"qp_iters max {int(sol.iters.max())} qp_st max {int(sol.status.max())} "
                f"c_aug max {float(c_aug.max()):.2e} tau max {float(tau_new.max()):.2e} "
                f"alpha med {float(torch.quantile(alpha.double(), 0.5)):.3f} "
                f"|lam_qp| max {float(lam_qp.abs().max()):.2e} |d| max {float(d.abs().max()):.2e}",
                flush=True,
            )

        # freeze members that are done (mask-and-continue)
        runc, runm = run[:, None], run[:, None, None]
        qp_iters_new = qp_iters + torch.where(run, sol.iters, 0).to(torch.int32)
        active = run & ~done_new
        exhausted = torch.zeros_like(run)
        if params.qp_budget is not None:
            # the member's total inner-iteration budget is spent: freeze it
            # as IterationLimit (rescue_nonoptimal re-solves it)
            exhausted = active & (qp_iters_new >= params.qp_budget)
        if params.stall_iters is not None:
            # no stall_ratio progress for stall_iters iterations.  The first
            # iteration (mark inf) is progress for every ratio; the JAX
            # package's inf * 0 makes it NaN, no progress, at stall_ratio 0
            target = torch.where(torch.isinf(kkt_mark), inf, kkt_mark * params.stall_ratio)
            prog = kkt_new < target
            kkt_mark = torch.where(run & prog, kkt_new, kkt_mark)
            stall_ct = torch.where(run, torch.where(prog, 0, stall_ct + 1), stall_ct).to(torch.int32)
            exhausted = exhausted | (active & (stall_ct >= params.stall_iters))

        x = torch.where(runc, x_new, x)
        lam = torch.where(runc, lam_new, lam)
        z = torch.where(runc, z_new, z)
        reg = torch.where(run, reg_new, reg)
        tau = torch.where(run, tau_new, tau)
        caug = torch.where(run, c_aug, caug)
        kkt = torch.where(run, kkt_new, kkt)
        done = done | done_new | exhausted
        failed = failed | exhausted
        iters = torch.where(run, it + 1, iters).to(torch.int32)
        qp_iters = qp_iters_new
        qp_ws = QPSolution(*(
            torch.where(run.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(sol, qp_ws)
        ))
        fval = torch.where(run, f_new, fval)
        gval = torch.where(runc, g_new, gval)
        grad_v = torch.where(runc, grad_new, grad_v)
        J = torch.where(runm, J_new, J)
        Hb = torch.where(runm, Hb_new, Hb)
        fh = torch.where(runc, torch.cat([fh[:, 1:], f_new[:, None]], dim=1), fh)
        vh = torch.where(runc, torch.cat([vh[:, 1:], violation_b(x_new, g_new)[:, None]], dim=1), vh)
        it += 1

    status = torch.where(
        done & ~failed, int(NLPSolutionStatus.Optimal), int(NLPSolutionStatus.IterationLimit)
    ).to(torch.int32)
    return NLPSolution(
        status=status,
        iters=iters,
        x=x,
        zl=torch.clamp(-z, min=0.0),
        zu=torch.clamp(z, min=0.0),
        lam=lam,
        objective=fB(thetas, x),
        kkt_res=kkt,
        qp_iters=qp_iters,
    )


# The JAX package memoizes the jitted rescue programs (_RescueCache, one per
# family, parameters and mode); eager torch compiles nothing, so the rescue
# calls the solvers directly.

# the multistart perturbation ladder (the JAX package's 6 entries, repeated
# for wider multistarts)
_LADDER = (0.3, 1.0, 3.0, 0.3, 1.0, 10.0)


def rescue_nonoptimal(
    make_nlp,
    thetas,
    sol: NLPSolution,
    params: SQPParams,
    *,
    qp_iter_scale: int = 4,
    iter_scale: int = 2,
    budget_scale: Optional[float] = None,
    adaptive_rho: Optional[bool] = None,
    stall_scale: int = 1,
    multistart: int = 4,
    perturb_scale: float = 0.1,
    x0_cold=None,
    seed: int = 0,
) -> tuple[NLPSolution, int]:
    """Re-solve the non-Optimal members of a fleet solution in two stages.

    1. **Warm-started re-solve** (``multistart``-wide lockstep groups; solo
       when ``multistart <= 1``): ``qp_iter_scale`` times the inner-ADMM
       cap, ``iter_scale`` times the SQP budget, fresh multipliers, the
       fleet's last iterate as the start; ``params.qp_budget`` scaled by
       ``budget_scale`` (default ``qp_iter_scale``) bounds the total work
       and ``params.stall_iters`` (times ``stall_scale``) cuts a diverging
       member off.
    2. **Perturbed multistart** for members still not Optimal: a
       ``multistart``-wide batch a member, the cold start (``x0_cold``,
       else zeros), the cold start under a geometric ladder of Gaussian
       perturbations (``perturb_scale`` x (1 + |cold|_inf)), the last of
       them the best-so-far iterate perturbed with the ladder's entry at
       its place (the JAX package's choice, kept for comparability: at
       ``multistart = 4`` that is the largest, 3.0); the best candidate
       (Optimal, else lowest KKT) wins.  Widths above 7 repeat the ladder
       (the JAX package indexes past its 6 entries there).

    Runs on the host: statuses are read to find the members.  Returns
    ``(merged_sol, n_rescued)``; a member's fields are replaced only when a
    rescue ends Optimal or lowers its KKT residual, and ``iters`` /
    ``qp_iters`` accumulate every attempt's work."""
    bad = np.flatnonzero(sol.status.cpu().numpy() != int(NLPSolutionStatus.Optimal))
    if bad.size == 0:
        return sol, 0

    qp_prm = dataclasses.replace(params.qp, max_iter=params.qp.max_iter * qp_iter_scale)
    if adaptive_rho is not None:
        qp_prm = dataclasses.replace(qp_prm, adaptive_rho=adaptive_rho)
    prm = dataclasses.replace(
        params,
        max_iter=params.max_iter * iter_scale,
        qp=qp_prm,
        qp_budget=(
            int(params.qp_budget * (qp_iter_scale if budget_scale is None else budget_scale))
            if params.qp_budget
            else None
        ),
        chunk_size=None,
        probe_iters=0,
        stall_iters=(
            params.stall_iters * stall_scale if params.stall_iters is not None else None
        ),
    )
    out = {k: v.clone() for k, v in sol._asdict().items()}
    dev = sol.x.device

    def merge(i, ri):
        """Adopt candidate ri for member i iff it improves; charge its work."""
        improved = int(ri.status) == int(NLPSolutionStatus.Optimal) or float(ri.kkt_res) < float(
            out["kkt_res"][i]
        )
        if improved:
            for k in ("status", "x", "zl", "zu", "lam", "objective", "kkt_res"):
                out[k][i] = getattr(ri, k)
        out["iters"][i] += int(ri.iters)
        out["qp_iters"][i] += int(ri.qp_iters)
        return improved

    take = lambda idx: tree_map(lambda a: a[torch.as_tensor(idx, device=a.device)], thetas)

    # stage 1: warm-started from the fleet iterate, in multistart-wide
    # groups (the last padded with its first member; only real entries count)
    W = int(multistart)
    if W > 1:
        for g in range(0, bad.size, W):
            idx = bad[g : g + W]
            pad = np.concatenate([idx, np.full(W - idx.size, idx[0], idx.dtype)])
            rg = solve_nlp_sqp_batch(make_nlp, take(pad), out["x"][torch.as_tensor(pad, device=dev)], prm)
            for j, i in enumerate(idx):
                merge(i, NLPSolution(*(a[j] for a in rg)))
    else:
        for i in bad:
            th_i = tree_map(lambda a: a[int(i)], thetas)
            merge(i, solve_nlp_sqp(make_nlp(th_i), sol.x[int(i)], prm))

    # stage 2: perturbed multistart for members still not Optimal
    still = [i for i in bad if int(out["status"][i]) != int(NLPSolutionStatus.Optimal)]
    if W > 1 and still:
        sig = [_LADDER[k % len(_LADDER)] for k in range(W - 1)]
        for i in still:
            th_rep = take(np.full(W, i))
            xb = out["x"][i].cpu().numpy()
            cold = (
                np.asarray(x0_cold[i].cpu() if torch.is_tensor(x0_cold) else x0_cold[i])
                if x0_cold is not None
                else np.zeros_like(xb)
            )
            scale = perturb_scale * (1.0 + float(np.max(np.abs(cold))))
            rng = np.random.default_rng(seed * 100003 + int(i))
            cands = [cold]
            for k in range(W - 1):
                base = xb if k == len(sig) - 1 else cold  # the last: best-so-far
                cands.append(base + sig[k] * scale * rng.standard_normal(xb.shape))
            ri = solve_nlp_sqp_batch(
                make_nlp, th_rep, torch.as_tensor(np.stack(cands), dtype=sol.x.dtype, device=dev), prm
            )
            stat, kkts = ri.status.cpu().numpy(), ri.kkt_res.cpu().numpy()
            opt = stat == int(NLPSolutionStatus.Optimal)
            best = int(np.flatnonzero(opt)[np.argmin(kkts[opt])] if opt.any() else np.argmin(kkts))
            picked = NLPSolution(*(a[best] for a in ri))
            # charge every candidate's work, adopt only the winner
            merge(i, picked._replace(iters=ri.iters.sum(), qp_iters=ri.qp_iters.sum()))

    return NLPSolution(**out), int(bad.size)
