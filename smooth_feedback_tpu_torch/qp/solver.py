"""Batched ADMM QP solver (operator splitting, OSQP-style), PyTorch port.

Counterpart of ``smooth_feedback_tpu/qp/solver.py``: modified-Ruiz scaling,
per-row rho, a Cholesky-based explicit inverse of the reduced KKT matrix
``P_s + sigma I + A_s' diag(rho) A_s``, and the batched ADMM loop with the
unscaled-residual stopping check and infeasibility certificates.  Statuses
and iteration counts follow the JAX package exactly.

Shared factors (``qp_factorize`` of one template, no batch axis on
``Minv``) keep ``P``, ``A`` and ``Minv`` 2-D, so every product is one
``(B, k) @ (k, j)`` GEMM and no batch of copies is materialized.

Backends: ``"torch"`` runs the plain loop below; ``"cuda"`` runs a kernel of
``qp/cuda_kernel.py``: the shared-matrix kernel against shared factors, on
its resident or its streaming route (a shape past the JAX package's
``shared_kernel_fits``, which bounds both, runs the torch shared loop
instead, on the problems' device, and counts one ``shared_fallthroughs``,
as the JAX package falls through to its XLA path), the per-problem kernel
against per-problem factors or none (then every member is scaled and
factorized here first, in torch).  ``"lane"`` is the JAX package's
batch-trailing backend for fleets of tiny per-problem QPs: on CPU tensors
its plain whole solve (built from the pieces below, in the JAX package's
``(m, n, B)`` layout), on CUDA tensors the whole solve (scaling,
factorization, loop, unscaling) as one launch of ``csrc/admm_lane.cu`` (a
shape that kernel cannot hold runs the plain whole solve on the card and
counts one ``lane_fallthroughs``); shared factors on ``"lane"`` take the
torch shared loop, as the JAX package's take its XLA shared path.

Options, as in the JAX package: ``verbose`` (a host line at each stopping
check of the torch and lane loops; the kernels run their loop on the card
and print nothing), ``polish`` (the masked active-set polish,
Cholesky of the Schur complement in float64, LU of the quasi-definite
(n+m) system in float32, with compensated refinement), ``compensated_check``
(error-free residuals in the stopping check and a certificate of the
polished point that can upgrade MaxIterations), ``kkt_refine_iters``
(iterative refinement of each KKT solve) and ``adaptive_rho`` (per-member
residual balancing with a refactorization at a check where some member
adapts; per-problem factors on ``"torch"`` and ``"lane"`` only).  The
``"cuda"`` kernels run the loop without refinement, compensated checks or
rho adaptation, as the Pallas kernels do; the lane kernel runs all three.
Polish and the certificate run after the loop on every backend.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import NamedTuple, Optional

import torch

from .._precision import ieee_f32_matmul
from ..utils.compensated import cdot, cmatvec, two_sum
from ..utils.linalg import chol_lane, chol_solve_lane, mv_lane
from .types import QPSolution, QPSolutionStatus, QPSolverParams, QuadraticProgram

_RUNNING = int(QPSolutionStatus.Running)
_OPTIMAL = int(QPSolutionStatus.Optimal)
_PRIMAL_INF = int(QPSolutionStatus.PrimalInfeasible)
_DUAL_INF = int(QPSolutionStatus.DualInfeasible)
_MAX_ITER = int(QPSolutionStatus.MaxIterations)
_POLISH_FAILED = int(QPSolutionStatus.PolishFailed)
_UNKNOWN = int(QPSolutionStatus.Unknown)


def _norm_inf(x, dim=-1):
    return x.abs().amax(dim=dim)


def _mv(M, v):
    """``M v`` per batch row: M is (j, k) shared or (B, j, k); v is (B, k)."""
    if M.dim() == 2:
        return v @ M.T
    return torch.einsum("bjk,bk->bj", M, v)


def _mtv(M, v):
    """``M' v`` per batch row: M is (j, k) shared or (B, j, k); v is (B, j)."""
    if M.dim() == 2:
        return v @ M
    return torch.einsum("bjk,bj->bk", M, v)


def _check_params(prm: QPSolverParams):
    if prm.backend not in ("torch", "cuda", "lane"):
        raise ValueError(f"unknown backend {prm.backend!r} (use 'torch', 'cuda' or 'lane')")


# ------------------------------------------------------------------- scaling


def _ruiz(P, q, A, max_ruiz_iter: int = 10):
    """Modified-Ruiz equilibration of a batch of QPs (B, n, n), (B, n),
    (B, m, n).  Returns ``(c, sx, sy)`` with ``P_s = c Sx P Sx``,
    ``q_s = c Sx q``, ``A_s = Sy A Sx``.  Each member stops sweeping on its
    own, as under ``jax.vmap`` of the JAX package's while-loop."""
    dt, dev = P.dtype, P.device
    B, n, _ = P.shape
    m = A.shape[1]

    colnorm_P = _norm_inf(P, dim=1)
    colnorm_P = torch.where(colnorm_P == 0, 1.0, colnorm_P)
    floor = torch.tensor(1e-6, dtype=dt, device=dev)
    c = 1.0 / torch.maximum(floor, torch.maximum(colnorm_P.mean(dim=1), _norm_inf(q)))

    sx = torch.ones((B, n), dtype=dt, device=dev)
    sy = torch.ones((B, m), dtype=dt, device=dev)
    err = torch.full((B,), float("inf"), dtype=dt, device=dev)
    it = 0
    while it == 0 or (it <= max_ruiz_iter and bool((err > 0.1).any())):
        active = torch.ones_like(err, dtype=torch.bool) if it == 0 else err > 0.1
        Pn = (c[:, None, None] * sx[:, :, None] * sx[:, None, :] * P).abs()
        An = (sy[:, :, None] * A * sx[:, None, :]).abs()
        sx_inc = torch.maximum(Pn.amax(dim=1), An.amax(dim=1))
        sy_inc = An.amax(dim=2)
        sx_inc = torch.where(sx_inc == 0, 1.0, sx_inc)
        sy_inc = torch.where(sy_inc == 0, 1.0, sy_inc)
        err_new = torch.maximum(
            (sx_inc - 1.0).abs().amax(dim=1), (sy_inc - 1.0).abs().amax(dim=1)
        )
        sx_new = sx * torch.rsqrt(torch.clamp(sx_inc, min=1e-8))
        sy_new = sy * torch.rsqrt(torch.clamp(sy_inc, min=1e-8))
        sx = torch.where(active[:, None], sx_new, sx)
        sy = torch.where(active[:, None], sy_new, sy)
        err = torch.where(active, err_new, err)
        it += 1
    return c, sx, sy


# ------------------------------------------------------------ stopping check


def _stopping_check(prm, P, q, A, l, u, x_us, y_us, z_us, dx_us, dy_us):
    """Per-element convergence / infeasibility certificates on UNSCALED data.
    ``P``/``A`` are shared 2-D or batched 3-D; vectors carry the batch.
    Returns ``(status, pres, dres, ratio)``, ``ratio`` the normalized
    primal-to-dual residual balance that adaptive rho reads."""
    eps_abs, eps_rel = prm.eps_abs, prm.eps_rel
    eps_pinf, eps_dinf = prm.eps_primal_inf, prm.eps_dual_inf

    diverged = ~(torch.isfinite(x_us).all(dim=1) & torch.isfinite(y_us).all(dim=1))

    if prm.compensated_check:
        # two-float accumulation removes the ~eps |P||x| sqrt(n) evaluation
        # floor on the residuals
        Ax, Ax_lo = cmatvec(A, x_us)
        s, e = two_sum(Ax, -z_us)
        pres = _norm_inf(s + (e + Ax_lo))
        Px, Px_lo = cmatvec(P, x_us)
        Aty, Aty_lo = cdot(A, y_us[:, :, None], dim=1)
        s, e = two_sum(Px, Aty)
        s2, e2 = two_sum(s, q)
        dres = _norm_inf(s2 + (e2 + e + Px_lo + Aty_lo))
    else:
        Ax = _mv(A, x_us)
        pres = _norm_inf(Ax - z_us)
        Px = _mv(P, x_us)
        Aty = _mtv(A, y_us)
        dres = _norm_inf(Px + q + Aty)
    pscale = torch.maximum(_norm_inf(Ax), _norm_inf(z_us))
    prim_ok = pres <= eps_abs + eps_rel * pscale
    dscale = torch.maximum(_norm_inf(Px), torch.maximum(_norm_inf(q), _norm_inf(Aty)))
    dual_ok = dres <= eps_abs + eps_rel * dscale
    optimal = prim_ok & dual_ok

    # normalized-residual balance for adaptive rho (OSQP sec. 5.2): ratio > 1
    # means the primal residual dominates (raise rho), and vice versa
    tiny = torch.finfo(x_us.dtype).tiny
    pn = pres / torch.clamp(pscale, min=tiny)
    dn = dres / torch.clamp(dscale, min=tiny)
    ratio = torch.where((pn > 0) & (dn > 0), pn / torch.clamp(dn, min=tiny), 1.0)

    # primal infeasibility certificate (dy direction)
    E = _norm_inf(dy_us)
    Atdy = _mtv(A, dy_us)
    u_inf = torch.isinf(u)
    l_inf = torch.isinf(l)
    viol = (
        (u_inf & (dy_us > eps_pinf * E[:, None])) | (l_inf & (dy_us < -eps_pinf * E[:, None]))
    ).any(dim=1)
    sum_term = (
        torch.where(u_inf, 0.0, u * torch.clamp(dy_us, min=0.0))
        + torch.where(l_inf, 0.0, l * torch.clamp(dy_us, max=0.0))
    ).sum(dim=1)
    prim_inf = ~viol & (torch.maximum(_norm_inf(Atdy), sum_term) < eps_pinf * E)

    # dual infeasibility certificate (dx direction)
    dxn = _norm_inf(dx_us)
    Pdx = _mv(P, dx_us)
    Adx = _mv(A, dx_us)
    tol = eps_dinf * dxn[:, None]
    row_ok = torch.where(
        u_inf, Adx >= -tol, torch.where(l_inf, Adx <= tol, Adx.abs() < tol)
    ).all(dim=1)
    dual_inf = (
        (_norm_inf(Pdx) <= eps_dinf * dxn)
        & ((q * dx_us).sum(dim=1) <= eps_dinf * dxn)
        & row_ok
    )

    B = x_us.shape[0]
    st = torch.full((B,), _RUNNING, dtype=torch.int32, device=x_us.device)
    st = torch.where(dual_inf, _DUAL_INF, st)
    st = torch.where(prim_inf, _PRIMAL_INF, st)
    st = torch.where(optimal, _OPTIMAL, st)
    st = torch.where(diverged, _UNKNOWN, st).to(torch.int32)
    return st, pres, dres, ratio


# -------------------------------------------------------------------- factors


class QPFactors(NamedTuple):
    """Precomputed scaling + reduced-KKT factorization (leading batch axis,
    or none for factors shared by a whole batch)."""

    c: torch.Tensor  # (B,) cost scaling
    sx: torch.Tensor  # (B, n) variable scaling
    sy: torch.Tensor  # (B, m) constraint scaling
    rho: torch.Tensor  # (B, m) per-row dual step
    Ps: torch.Tensor  # (B, n, n) scaled P
    As: torch.Tensor  # (B, m, n) scaled A
    Mred: torch.Tensor  # (B, n, n) reduced KKT matrix
    Minv: torch.Tensor  # (B, n, n) its SPD inverse
    fact_ok: torch.Tensor  # (B,) factorization success


def _factorize(P, q, A, l, u, prm):
    dt, dev = P.dtype, P.device
    B, m, n = A.shape
    inf = float("inf")

    if prm.scaling:
        c, sx, sy = _ruiz(P, q, A)
    else:
        c = torch.ones((B,), dtype=dt, device=dev)
        sx = torch.ones((B, n), dtype=dt, device=dev)
        sy = torch.ones((B, m), dtype=dt, device=dev)

    # per-row rho; NaN (inf - inf) compares False => inequality row
    unbounded = (l == -inf) & (u == inf)
    eq = sy * (l - u).abs() < 1e-5
    rho = torch.where(
        unbounded,
        torch.tensor(1e-6, dtype=dt, device=dev),
        torch.where(
            eq,
            torch.tensor(prm.rho_eq_scale * prm.rho, dtype=dt, device=dev),
            torch.tensor(prm.rho, dtype=dt, device=dev),
        ),
    )

    Ps = c[:, None, None] * sx[:, :, None] * sx[:, None, :] * P
    As = sy[:, :, None] * A * sx[:, None, :]

    eye = torch.eye(n, dtype=dt, device=dev)
    Mred = Ps + prm.sigma * eye[None] + torch.einsum("bmn,bm,bmk->bnk", As, rho, As)
    Minv, fact_fail = _spd_inverse(Mred)
    return QPFactors(
        c=c, sx=sx, sy=sy, rho=rho, Ps=Ps, As=As, Mred=Mred, Minv=Minv, fact_ok=~fact_fail
    )


def _spd_inverse(M):
    """Explicit inverse ``M^{-1} = L^{-T} L^{-1}`` of a batch of SPD matrices
    and a per-member failure flag; a failed member's factor is replaced by
    the identity so that frozen members do not poison the batch."""
    B, n, _ = M.shape
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    L, info = torch.linalg.cholesky_ex(M)
    bad = (info != 0) | ~torch.isfinite(L).all(dim=2).all(dim=1)
    L = torch.where(bad[:, None, None], eye[None], L)
    Linv = torch.linalg.solve_triangular(L, eye.expand(B, n, n), upper=False)
    return torch.einsum("bkn,bkm->bnm", Linv, Linv), bad


def qp_factorize(qp: QuadraticProgram, prm: QPSolverParams = QPSolverParams()) -> QPFactors:
    """Precompute scaling and KKT factorization for a batched QP template."""
    P, q, A, l, u = qp
    with ieee_f32_matmul():
        return _factorize(P, q, A, l, u, prm)


# -------------------------------------------------------------------- solver


def _polish(prm, P, q, A, l, u, c, sx, sy, x, y):
    """Masked active-set polish in scaled variables.

    The reduced KKT system over the active constraints is embedded in a fixed
    (n+m) system where inactive multiplier rows become ``-nu_i = 0``, so the
    shapes do not depend on the active set.  ``P``/``A`` are shared 2-D (the
    scalings then equal for every member: the scaled matrices stay 2-D) or
    batched 3-D.  Returns ``(x_pol, y_pol, ok)``."""
    dt, dev = x.dtype, x.device
    B, n = x.shape
    m = y.shape[1]
    eps = torch.finfo(dt).eps

    lower_act = (y < -100 * eps) & torch.isfinite(l)
    upper_act = (y > 100 * eps) & torch.isfinite(u)
    # equality rows are active at every solution, whatever the multiplier
    eq_row = torch.isfinite(l) & ((u - l) <= 0)
    upper_act = (upper_act | eq_row) & ~lower_act
    act = lower_act | upper_act

    if P.dim() == 2:
        Ps = c[0] * sx[0][:, None] * sx[0][None, :] * P
        As = sy[0][:, None] * A * sx[0][None, :]
    else:
        Ps = c[:, None, None] * sx[:, :, None] * sx[:, None, :] * P
        As = sy[:, :, None] * A * sx[:, None, :]
    qs = c[:, None] * sx * q
    ls = sy * l
    us = sy * u

    As_act = As * act.to(dt)[:, :, None]  # (B, m, n)
    # Perturbed system Hp = [[Ps + delta I, Aa'], [Aa, -Dd]] with Dd > 0
    # diagonal (delta on active rows, 1 on decoupled inactive rows).
    #   float64: SPD Schur complement + Cholesky (absorbs the 1/delta ~ 1e6
    #            conditioning of the Schur form);
    #   float32: LU of the full quasi-definite system (the Schur form
    #            overflows float32; pivoting keeps the +-delta blocks intact).
    Dd = torch.where(act, torch.full_like(y, prm.delta), torch.ones_like(y))  # (B, m)
    h_x = -qs
    h_nu = torch.where(act, torch.where(lower_act, ls, us), 0.0)
    eye_n = torch.eye(n, dtype=dt, device=dev)

    if dt == torch.float64:
        S = Ps + prm.delta * eye_n + torch.einsum("bmn,bm,bmk->bnk", As_act, 1.0 / Dd, As_act)
        L, info = torch.linalg.cholesky_ex(S)
        fact_ok = (info == 0) & torch.isfinite(L).all(dim=2).all(dim=1)
        L = torch.where(fact_ok[:, None, None], L, eye_n)

        def hp_solve(r_x, r_nu):
            rhs = r_x + torch.einsum("bmn,bm->bn", As_act, r_nu / Dd)
            tt = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
            xs_ = torch.linalg.solve_triangular(L.mT, tt, upper=True)[..., 0]
            nus = (torch.einsum("bmn,bn->bm", As_act, xs_) - r_nu) / Dd
            return xs_, nus

    else:
        top = torch.cat([(Ps + prm.delta * eye_n).expand(B, n, n), As_act.mT], dim=2)
        bottom = torch.cat([As_act, torch.diag_embed(-Dd)], dim=2)
        LU, piv, _ = torch.linalg.lu_factor_ex(torch.cat([top, bottom], dim=1))
        fact_ok = torch.isfinite(LU).all(dim=2).all(dim=1)

        def hp_solve(r_x, r_nu):
            r = torch.cat([r_x, r_nu], dim=1)
            t = torch.linalg.lu_solve(LU, piv, r[..., None])[..., 0]
            return t[:, :n], t[:, n:]

    x_t = torch.zeros((B, n), dtype=dt, device=dev)
    nu_t = torch.zeros((B, m), dtype=dt, device=dev)
    for _ in range(prm.polish_iter):
        # residual of the unperturbed system H = [[Ps, Aa'], [Aa, 0]],
        # compensated: in plain float32 its ~eps |H||t| evaluation noise
        # caps what iterative refinement recovers
        hi1, lo1 = cmatvec(Ps, x_t)
        hi2, lo2 = cdot(As_act, nu_t[:, :, None], dim=1)
        s, e = two_sum(hi1, hi2)
        r_x = (h_x - s) - (e + lo1 + lo2)
        hi3, lo3 = cmatvec(As_act, x_t)
        r_nu = (h_nu - hi3) - lo3
        dx_, dnu_ = hp_solve(r_x, r_nu)
        x_t = x_t + dx_
        nu_t = nu_t + dnu_

    ok = fact_ok & torch.isfinite(x_t).all(dim=1) & torch.isfinite(nu_t).all(dim=1)
    return x_t, torch.where(act, nu_t, y), ok


def _certify_point(prm, P, q, A, l, u, primal, dual):
    """Compensated KKT certificate at an UNSCALED ``(primal, dual)`` point
    (the polished one): primal feasibility is the distance of ``A x`` to
    ``[l, u]``, dual stationarity ``|P x + q + A' y|_inf``, both with
    error-free accumulation.  Returns ``(pres, dres, passed)``."""
    Ax, Ax_lo = cmatvec(A, primal)
    z = torch.clamp(Ax + Ax_lo, l, u)
    s, e = two_sum(Ax, -z)
    pres = _norm_inf(s + (e + Ax_lo))
    Px, Px_lo = cmatvec(P, primal)
    Aty, Aty_lo = cdot(A, dual[:, :, None], dim=1)
    s, e = two_sum(Px, Aty)
    s2, e2 = two_sum(s, q)
    dres = _norm_inf(s2 + (e2 + e + Px_lo + Aty_lo))
    prim_ok = pres <= prm.eps_abs + prm.eps_rel * torch.maximum(_norm_inf(Ax), _norm_inf(z))
    dual_ok = dres <= prm.eps_abs + prm.eps_rel * torch.maximum(
        _norm_inf(Px), torch.maximum(_norm_inf(q), _norm_inf(Aty))
    )
    finite = torch.isfinite(primal).all(dim=1) & torch.isfinite(dual).all(dim=1)
    return pres, dres, finite & prim_ok & dual_ok


def _finalize_solution(prm, P, q, A, l, u, c, sx, sy, x, y, status, iters, pres, dres):
    """Polish (``prm.polish``), then unscale and assemble the solution.

    Only Optimal members take the polished point; a failed polish turns an
    Optimal member into PolishFailed.  Under ``compensated_check`` a
    MaxIterations member whose polished point passes the compensated
    certificate becomes Optimal, and members that take the polished point
    report the residuals measured there."""
    if prm.polish:
        x_pol, y_pol, ok = _polish(prm, P, q, A, l, u, c, sx, sy, x, y)
        is_opt = status == _OPTIMAL
        use = is_opt & ok
        if prm.compensated_check:
            pres_p, dres_p, pass_p = _certify_point(
                prm, P, q, A, l, u, sx * x_pol, sy * y_pol / c[:, None]
            )
            upgrade = (status == _MAX_ITER) & ok & pass_p
            use = use | upgrade
            status = torch.where(upgrade, _OPTIMAL, status)
            pres = torch.where(use, pres_p, pres)
            dres = torch.where(use, dres_p, dres)
        x = torch.where(use[:, None], x_pol, x)
        y = torch.where(use[:, None], y_pol, y)
        status = torch.where(is_opt & ~ok, _POLISH_FAILED, status).to(torch.int32)

    primal = sx * x
    dual = sy * y / c[:, None]
    objective = (primal * (0.5 * _mv(P, primal) + q)).sum(dim=1)
    return QPSolution(
        primal=primal, dual=dual, status=status, iters=iters, objective=objective,
        primal_res=pres, dual_res=dres,
    )


def _print_check(it, status, pres, dres, tag="qp"):
    """``verbose``: one host line a stopping check, the JAX package's fields
    (members still running; median and largest residuals)."""
    med = lambda r: float(torch.quantile(r.double(), 0.5))
    print(
        f"[{tag}] iter {it}: running {int((status == _RUNNING).sum())}/{status.shape[0]}  "
        f"pres med {med(pres):.3e} max {float(pres.max()):.3e}  "
        f"dres med {med(dres):.3e} max {float(dres.max()):.3e}",
        flush=True,
    )


def solve_qp_batch(
    qp: QuadraticProgram,
    prm: QPSolverParams = QPSolverParams(),
    warmstart: Optional[QPSolution] = None,
    factors: Optional[QPFactors] = None,
) -> QPSolution:
    """Solve a batch of dense QPs; every field of ``qp`` has a leading batch
    axis (of size 1 for a field shared by the batch).

    If ``factors`` is supplied (see :func:`qp_factorize`), ``P``/``A`` must
    match the template the factors were built from; only q/l/u are read."""
    _check_params(prm)
    with ieee_f32_matmul():
        return _solve_qp_batch_impl(qp, prm, warmstart, factors)


def _batch_view(qp, factors):
    """``(P, q, A, l, u, shared)`` with the vectors expanded to the batch;
    with shared factors ``P`` and ``A`` are the 2-D template, otherwise they
    are expanded to (B, ., n)."""
    P, q, A, l, u = qp
    B = max(a.shape[0] for a in qp)
    m, n = A.shape[-2:]
    q = q.expand(B, n)
    l = l.expand(B, m)
    u = u.expand(B, m)
    shared = factors is not None and factors.Minv.dim() == 2
    if shared:
        # shared matrices stay 2-D: products are (B, k) @ (k, j) GEMMs
        if P.shape[0] != 1 or A.shape[0] != 1:
            raise ValueError("shared factors need P and A with a leading axis of 1")
        return P[0], q, A[0], l, u, True
    return P.expand(B, n, n), q, A.expand(B, m, n), l, u, False


def _scaled_inputs(A, q, l, u, factors, warmstart, shared):
    """Scaled vectors, the scaled warm start (zeros without one) and the
    initial statuses: ``(cB, sxB, syB, qs, ls, us, x0, z0, y0, status0)``."""
    c, sx, sy, _, _, _, _, _, fact_ok = factors
    B, n = q.shape
    m = l.shape[1]
    dt, dev = A.dtype, A.device
    inf = float("inf")

    # trivial infeasibility
    bad_row = (l == inf) | (u == -inf) | ((u - l) < 0)
    status0 = torch.where(
        bad_row.any(dim=1), _PRIMAL_INF, torch.where(~fact_ok, _UNKNOWN, _RUNNING)
    ).to(torch.int32)

    if shared:
        qs = c * sx[None, :] * q
        ls = sy[None, :] * l
        us = sy[None, :] * u
        cB = c.expand(B)
        sxB = sx[None, :].expand(B, n)
        syB = sy[None, :].expand(B, m)
    else:
        qs = c[:, None] * sx * q
        ls = sy * l
        us = sy * u
        cB, sxB, syB = c, sx, sy

    if warmstart is not None:
        x0 = warmstart.primal / sxB
        y0 = cB[:, None] * warmstart.dual / syB
        z0 = syB * _mv(A, warmstart.primal)
    else:
        x0 = torch.zeros((B, n), dtype=dt, device=dev)
        y0 = torch.zeros((B, m), dtype=dt, device=dev)
        z0 = torch.zeros((B, m), dtype=dt, device=dev)
    return cB, sxB, syB, qs, ls, us, x0, z0, y0, status0


def _kernel_args(factors, qs, ls, us, l, u, x0, z0, y0, status0, dtype=torch.float32):
    """The ADMM kernels' arguments after ``prm``, in their order, as
    contiguous ``dtype`` (the kernels take float32)."""
    c, sx, sy, rho, Ps, As, _, Minv, _ = factors
    f32 = lambda a: a.to(dtype).contiguous()
    return (
        f32(Minv), f32(As), f32(Ps), f32(qs), f32(ls), f32(us),
        f32(rho), f32(sx), f32(sy), f32(c), f32(l), f32(u),
        f32(x0), f32(z0), f32(y0), status0.contiguous(),
    )


def shared_kernel_args(
    qp: QuadraticProgram, factors: QPFactors, warmstart: Optional[QPSolution] = None
):
    """What :func:`solve_qp_batch` on ``backend="cuda"`` hands
    ``admm_iterate_cuda_shared`` after ``prm`` (before any straggler sort),
    for a batch ``qp`` against shared ``factors`` (no batch axis): the
    factors, the scaled vectors, the scaled warm start and the initial
    statuses, as contiguous float32 (int32 statuses).  The plain version
    ``admm_iterate_reference`` takes the same arguments."""
    P, q, A, l, u, shared = _batch_view(qp, factors)
    if not shared:
        raise ValueError("shared_kernel_args needs shared (batch-free) factors")
    _, _, _, qs, ls, us, x0, z0, y0, status0 = _scaled_inputs(
        A, q, l, u, factors, warmstart, True
    )
    return _kernel_args(factors, qs, ls, us, l, u, x0, z0, y0, status0)


def per_problem_kernel_args(
    qp: QuadraticProgram,
    factors: Optional[QPFactors] = None,
    warmstart: Optional[QPSolution] = None,
    prm: QPSolverParams = QPSolverParams(),
):
    """What :func:`solve_qp_batch` on ``backend="cuda"`` hands
    ``admm_iterate_cuda`` after ``prm``, for a batch ``qp`` against
    per-problem ``factors`` (a leading batch axis) or, without factors,
    against each member's own scaling and factorization under ``prm``.  The
    plain version ``admm_iterate_reference`` takes the same arguments."""
    P, q, A, l, u, shared = _batch_view(qp, factors)
    if shared:
        raise ValueError("per_problem_kernel_args needs per-problem factors (or none)")
    with ieee_f32_matmul():
        if factors is None:
            factors = _factorize(P, q, A, l, u, prm)
        _, _, _, qs, ls, us, x0, z0, y0, status0 = _scaled_inputs(
            A, q, l, u, factors, warmstart, False
        )
        return _kernel_args(factors, qs, ls, us, l, u, x0, z0, y0, status0)


# --------------------------------------------- lane (batch-trailing) backend
#
# The JAX package's backend for fleets of tiny per-problem QPs (the ASIF
# shape: n = nu + 1 variables, m ~ K rows) stores every matrix batch-TRAILING
# (A as (m, n, B)) and runs scaling, factorization, the ADMM iteration and the
# stopping checks in that layout.  The plain pieces below keep the layout and
# the JAX package's order of operations, so the plain whole solve built from
# them (qp/cuda_kernel.py's admm_solve_lane_reference) rounds in float64 as
# the JAX package does; on CUDA tensors the whole solve (scaling,
# factorization, loop, unscaling) runs as one launch of csrc/admm_lane.cu
# instead.


def _ruiz_lane(Pt, qt, At, max_ruiz_iter: int = 10):
    """Batch-trailing modified-Ruiz equilibration of ``(n, n, B)``, ``(n,
    B)``, ``(m, n, B)`` stacks; each member stops sweeping on its own.
    Returns ``(c, sx, sy, sweeps)``, ``sweeps`` (B,) the sweeps each member
    ran; every sweep of the loop counts one ``lane_ruiz_sweeps``."""
    dt, dev = Pt.dtype, Pt.device
    n, _, B = Pt.shape
    m = At.shape[0]

    colnorm_P = Pt.abs().amax(dim=0)  # (n, B)
    colnorm_P = torch.where(colnorm_P == 0, 1.0, colnorm_P)
    floor = torch.tensor(1e-6, dtype=dt, device=dev)
    c = 1.0 / torch.maximum(floor, torch.maximum(colnorm_P.mean(dim=0), qt.abs().amax(dim=0)))

    sx = torch.ones((n, B), dtype=dt, device=dev)
    sy = torch.ones((m, B), dtype=dt, device=dev)
    err = torch.full((B,), float("inf"), dtype=dt, device=dev)
    sweeps = torch.zeros((B,), dtype=torch.int32, device=dev)
    it = 0
    while it == 0 or (it <= max_ruiz_iter and bool((err > 0.1).any())):
        _bump("lane_ruiz_sweeps")
        active = torch.ones_like(err, dtype=torch.bool) if it == 0 else err > 0.1
        Pn = (c[None, None, :] * sx[:, None, :] * sx[None, :, :] * Pt).abs()
        An = (sy[:, None, :] * At * sx[None, :, :]).abs()
        sx_inc = torch.maximum(Pn.amax(dim=0), An.amax(dim=0))  # (n, B)
        sy_inc = An.amax(dim=1)  # (m, B)
        sx_inc = torch.where(sx_inc == 0, 1.0, sx_inc)
        sy_inc = torch.where(sy_inc == 0, 1.0, sy_inc)
        err_new = torch.maximum(
            (sx_inc - 1.0).abs().amax(dim=0), (sy_inc - 1.0).abs().amax(dim=0)
        )
        sx_new = sx * torch.rsqrt(torch.clamp(sx_inc, min=1e-8))
        sy_new = sy * torch.rsqrt(torch.clamp(sy_inc, min=1e-8))
        sx = torch.where(active[None, :], sx_new, sx)
        sy = torch.where(active[None, :], sy_new, sy)
        err = torch.where(active, err_new, err)
        sweeps = sweeps + active.to(torch.int32)
        it += 1
    return c, sx, sy, sweeps


def _lane_scaling(Pt, qt, At, lt, ut, prm):
    """Scalings, per-row rho and the scaled matrices of a batch-trailing
    fleet: ``(c, sx, sy, rho, Pst, Ast, sweeps)``, unit scalings and no
    sweeps without ``prm.scaling``."""
    dt, dev = Pt.dtype, Pt.device
    n, _, B = Pt.shape
    m = At.shape[0]
    inf = float("inf")
    if prm.scaling:
        c, sx, sy, sweeps = _ruiz_lane(Pt, qt, At)
    else:
        c = torch.ones((B,), dtype=dt, device=dev)
        sx = torch.ones((n, B), dtype=dt, device=dev)
        sy = torch.ones((m, B), dtype=dt, device=dev)
        sweeps = torch.zeros((B,), dtype=torch.int32, device=dev)
    # NaN (inf - inf) compares False => inequality row
    unbounded = (lt == -inf) & (ut == inf)
    eq = sy * (lt - ut).abs() < 1e-5
    rho = torch.where(
        unbounded,
        torch.tensor(1e-6, dtype=dt, device=dev),
        torch.where(
            eq,
            torch.tensor(prm.rho_eq_scale * prm.rho, dtype=dt, device=dev),
            torch.tensor(prm.rho, dtype=dt, device=dev),
        ),
    )  # (m, B)
    Pst = c[None, None, :] * sx[:, None, :] * sx[None, :, :] * Pt
    Ast = sy[:, None, :] * At * sx[None, :, :]
    return c, sx, sy, rho, Pst, Ast, sweeps


# Up to this n the lane factorization is the unrolled chol_lane /
# chol_solve_lane on (B,)-vectors, as in the JAX package; above it the
# reduced KKT matrix is factorized batch-leading and transposed back.
_LANE_UNROLL_MAX = 32


def _lane_chol_inverse(Pst, Ast, rho, sigma):
    """Reduced-KKT ``Mred = Ps + sigma I + A' diag(rho) A`` and its inverse for
    ``(n, n, B)`` / ``(m, n, B)`` stacks: ``(Mredt, Minvt, fact_fail)``; a
    member whose Cholesky factor is not finite gets the identity factor."""
    dt, dev = Pst.dtype, Pst.device
    n, _, B = Pst.shape
    eye = torch.eye(n, dtype=dt, device=dev)
    if n <= _LANE_UNROLL_MAX:
        ArA = ((Ast * rho[:, None, :])[:, :, None, :] * Ast[:, None, :, :]).sum(dim=0)
        Mredt = Pst + sigma * eye[:, :, None] + ArA
        L = chol_lane(Mredt)
        fact_fail = ~torch.isfinite(L).all(dim=0).all(dim=0)  # (B,)
        L = torch.where(fact_fail[None, None, :], eye[:, :, None], L)
        Minvt = chol_solve_lane(L, eye[:, :, None].expand(n, n, B))
        return Mredt, Minvt, fact_fail

    # 32 < n: batch-leading factorization, lane iteration
    A_bl = Ast.permute(2, 0, 1)  # (B, m, n)
    Mred_bl = (
        Pst.permute(2, 0, 1)
        + sigma * eye[None]
        + torch.einsum("bmi,bm,bmj->bij", A_bl, rho.T, A_bl)
    )
    L, info = torch.linalg.cholesky_ex(Mred_bl)
    fact_fail = (info != 0) | ~torch.isfinite(L).all(dim=2).all(dim=1)
    L = torch.where(fact_fail[:, None, None], eye[None], L)
    Y = torch.linalg.solve_triangular(L, eye.expand(B, n, n), upper=False)
    Minv_bl = torch.linalg.solve_triangular(L.mT, Y, upper=True)
    return Mred_bl.permute(1, 2, 0), Minv_bl.permute(1, 2, 0), fact_fail


def _stopping_check_lane(prm, Pt, qt, At, lt, ut, x_us, y_us, z_us, dx_us, dy_us):
    """Batch-trailing :func:`_stopping_check` (the same certificates and
    criteria); matrix stacks ``(k, j, B)``, vectors ``(k, B)``."""
    eps_abs, eps_rel = prm.eps_abs, prm.eps_rel
    eps_pinf, eps_dinf = prm.eps_primal_inf, prm.eps_dual_inf
    ninf = lambda v: v.abs().amax(dim=0)  # (k, B) -> (B,)
    A_mv = lambda xv: (At * xv[None, :, :]).sum(dim=1)  # (m, B)
    AT_mv = lambda v: (At * v[:, None, :]).sum(dim=0)  # (n, B)

    diverged = ~(torch.isfinite(x_us).all(dim=0) & torch.isfinite(y_us).all(dim=0))

    if prm.compensated_check:
        Ax, Ax_lo = cdot(At, x_us[None, :, :], dim=1)  # (m, B)
        s, e = two_sum(Ax, -z_us)
        pres = ninf(s + (e + Ax_lo))
        Px, Px_lo = cdot(Pt, x_us[None, :, :], dim=1)  # (n, B)
        Aty, Aty_lo = cdot(At, y_us[:, None, :], dim=0)  # (n, B)
        s, e = two_sum(Px, Aty)
        s2, e2 = two_sum(s, qt)
        dres = ninf(s2 + (e2 + e + Px_lo + Aty_lo))
    else:
        Ax = A_mv(x_us)
        pres = ninf(Ax - z_us)
        Px = mv_lane(Pt, x_us)
        Aty = AT_mv(y_us)
        dres = ninf(Px + qt + Aty)
    pscale = torch.maximum(ninf(Ax), ninf(z_us))
    prim_ok = pres <= eps_abs + eps_rel * pscale
    dscale = torch.maximum(ninf(Px), torch.maximum(ninf(qt), ninf(Aty)))
    dual_ok = dres <= eps_abs + eps_rel * dscale

    # normalized-residual balance for adaptive rho (OSQP sec. 5.2)
    tiny = torch.finfo(x_us.dtype).tiny
    pn = pres / torch.clamp(pscale, min=tiny)
    dn = dres / torch.clamp(dscale, min=tiny)
    ratio = torch.where((pn > 0) & (dn > 0), pn / torch.clamp(dn, min=tiny), 1.0)

    optimal = prim_ok & dual_ok

    E = ninf(dy_us)
    Atdy = AT_mv(dy_us)
    u_inf = torch.isinf(ut)
    l_inf = torch.isinf(lt)
    viol = (
        (u_inf & (dy_us > eps_pinf * E[None, :])) | (l_inf & (dy_us < -eps_pinf * E[None, :]))
    ).any(dim=0)
    sum_term = (
        torch.where(u_inf, 0.0, ut * torch.clamp(dy_us, min=0.0))
        + torch.where(l_inf, 0.0, lt * torch.clamp(dy_us, max=0.0))
    ).sum(dim=0)
    prim_inf = ~viol & (torch.maximum(ninf(Atdy), sum_term) < eps_pinf * E)

    dxn = ninf(dx_us)
    Pdx = mv_lane(Pt, dx_us)
    Adx = A_mv(dx_us)
    tol = eps_dinf * dxn[None, :]
    row_ok = torch.where(
        u_inf, Adx >= -tol, torch.where(l_inf, Adx <= tol, Adx.abs() < tol)
    ).all(dim=0)
    dual_inf = (
        (ninf(Pdx) <= eps_dinf * dxn)
        & ((qt * dx_us).sum(dim=0) <= eps_dinf * dxn)
        & row_ok
    )

    B = x_us.shape[1]
    st = torch.full((B,), _RUNNING, dtype=torch.int32, device=x_us.device)
    st = torch.where(dual_inf, _DUAL_INF, st)
    st = torch.where(prim_inf, _PRIMAL_INF, st)
    st = torch.where(optimal, _OPTIMAL, st)
    st = torch.where(diverged, _UNKNOWN, st).to(torch.int32)
    return st, pres, dres, ratio


def _lane_loop(prm, Pt, qt, At, lt, ut, c, sx, sy, rho, Pst, Ast, Mredt, Minvt, qs, ls, us,
               x, z, y, status, member_refactor=False):
    """The lane backend's ADMM loop on batch-trailing stacks (vectors ``(k,
    B)``), from the scaled iterates ``x, z, y`` and initial statuses.

    With ``prm.adaptive_rho``, every member still running whose residual
    balance leaves the tolerance band takes ``rho <- rho sqrt(ratio)``
    (clipped to [1e-6, 1e6], pinned rows at 1e-6); as in the JAX package the
    whole fleet is then refactorized at that rho, and a member whose factor
    is not finite keeps its previous rho and factors.  ``member_refactor``
    refactorizes the adapting members alone, as the lane kernel does: the
    other members keep their rho and factors.

    Returns ``(x, z, y, status, iters, pres, dres, refactors)``, with
    Running turned into MaxIterations and ``refactors`` the refactorizations
    each member's adaptation asked for."""
    dt, dev = qs.dtype, qs.device
    B = qs.shape[1]
    inf = float("inf")
    As_mv = lambda xv: (Ast * xv[None, :, :]).sum(dim=1)  # (m, B)
    AsT_mv = lambda v: (Ast * v[:, None, :]).sum(dim=0)  # (n, B)
    n_refine = max(0, prm.kkt_refine_iters)

    def Msolve(Minvt_, Mredt_, r):
        t = mv_lane(Minvt_, r)
        for _ in range(n_refine):
            t = t + mv_lane(Minvt_, r - mv_lane(Mredt_, t))
        return t

    alpha = prm.alpha
    # rows whose rho is pinned (unbounded) never adapt
    rho_pinned = (lt == -inf) & (ut == inf)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    refactors = torch.zeros((B,), dtype=torch.int32, device=dev)
    pres = torch.full((B,), inf, dtype=dt, device=dev)
    dres = torch.full((B,), inf, dtype=dt, device=dev)
    ones = torch.ones((B,), dtype=dt, device=dev)
    k = prm.stop_check_iter
    it = 0
    while it < prm.max_iter and bool((status == _RUNNING).any()):
        x_old, y_old = x, y
        rhs = prm.sigma * x - qs + AsT_mv(rho * z - y)
        xt = Msolve(Minvt, Mredt, rhs)
        zt = As_mv(xt)

        xn = alpha * xt + (1 - alpha) * x
        zn = torch.clamp(alpha * zt + (1 - alpha) * z + y / rho, ls, us)
        yn = y + rho * (alpha * zt + (1 - alpha) * z - zn)

        # == (1 % k) so stop_check_iter == 1 means "every iteration"
        if it % k == 1 % k:
            new_status, pres_n, dres_n, ratio = _stopping_check_lane(
                prm, Pt, qt, At, lt, ut, sx * xn, sy * yn / c[None, :], zn / sy,
                sx * (xn - x_old), sy * (yn - y_old) / c[None, :],
            )
            if prm.verbose:
                _print_check(it, new_status, pres_n, dres_n, tag="qp/lane")
        else:
            new_status = torch.full((B,), _RUNNING, dtype=torch.int32, device=dev)
            pres_n, dres_n, ratio = pres, dres, ones

        run = status == _RUNNING
        runc = run[None, :]
        x = torch.where(runc, xn, x)
        z = torch.where(runc, zn, z)
        y = torch.where(runc, yn, y)
        status = torch.where(run, new_status, status)
        iters = torch.where(run, it + 1, iters).to(torch.int32)
        pres = torch.where(run, pres_n, pres)
        dres = torch.where(run, dres_n, dres)

        if prm.adaptive_rho:
            # residual balancing (OSQP sec. 5.2): rho <- rho sqrt(pres_n /
            # dres_n) for the members still running whose imbalance leaves
            # the tolerance band (ratio is 1 between checks)
            mult = torch.sqrt(ratio)
            tol = prm.adaptive_rho_tol
            adapt = (new_status == _RUNNING) & run & ((mult > tol) | (mult < 1.0 / tol))
            if bool(adapt.any()):
                mult = torch.where(adapt, mult, 1.0)
                rho_new = torch.clamp(rho * mult[None, :], 1e-6, 1e6)
                rho_new = torch.where(rho_pinned, 1e-6, rho_new)
                Mred_n, Minv_n, bad = _lane_chol_inverse(Pst, Ast, rho_new, prm.sigma)
                # a failed refactorization keeps the previous rho and factors
                keep = (bad | ~adapt) if member_refactor else bad
                rho = torch.where(keep[None, :], rho, rho_new)
                Mredt = torch.where(keep[None, None, :], Mredt, Mred_n)
                Minvt = torch.where(keep[None, None, :], Minvt, Minv_n)
                refactors = refactors + adapt.to(torch.int32)
        it += 1

    status = torch.where(status == _RUNNING, _MAX_ITER, status).to(torch.int32)
    return x, z, y, status, iters, pres, dres, refactors


def _inner_contiguous(t):
    """Whether every axis of ``t`` after the first is laid out as in a
    contiguous tensor (the first, the batch, may have any stride)."""
    expect = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def _lane_operand(t):
    """``t`` as float32 with contiguous inner axes; no copy where it is one."""
    t = t.to(torch.float32)
    return t if _inner_contiguous(t) else t.contiguous()


def _lane_args(P, q, A, l, u, warmstart, factors):
    """The lane kernel's operands after ``prm`` from batch-leading ``(P, q,
    A, l, u)`` (expanded views keep their batch stride 0): ``(P, q, A, l, u,
    xw, yw, factors)``, the unscaled warm start's primal and dual (None
    without one) and the per-problem factors (None without them), float32
    with contiguous inner axes (factors contiguous, ``fact_ok`` bool)."""
    B, m, n = A.shape
    xw = yw = None
    if warmstart is not None:
        xw = _lane_operand(warmstart.primal.expand(B, n))
        yw = _lane_operand(warmstart.dual.expand(B, m))
    if factors is not None:
        factors = QPFactors(*(f.to(torch.float32).contiguous() for f in factors[:8]),
                            factors.fact_ok.contiguous())
    return (*(_lane_operand(a) for a in (P, q, A, l, u)), xw, yw, factors)


def lane_kernel_args(
    qp: QuadraticProgram,
    factors: Optional[QPFactors] = None,
    warmstart: Optional[QPSolution] = None,
):
    """What :func:`solve_qp_batch` on ``backend="lane"`` hands
    ``admm_solve_cuda_lane`` after ``prm`` for a batch ``qp`` against
    per-problem ``factors`` (the kernel then skips scaling and
    factorization) or none (the kernel scales and factorizes): the
    unscaled problem, the unscaled warm start (None without one) and the
    factors, float32 (see :func:`_lane_args`).  The plain version
    ``admm_solve_lane_reference`` takes the same arguments."""
    P, q, A, l, u, shared = _batch_view(qp, factors)
    if shared:
        raise ValueError("lane_kernel_args needs per-problem factors (or none)")
    return _lane_args(P, q, A, l, u, warmstart, factors)


# this module's counters and the kernels' ``launches`` (qp/cuda_kernel.py)
# are bumped under one lock: the shards of a sharded call (parallel/) solve
# in threads of their own
_count_lock = threading.Lock()


def _bump(name):
    """Add one to this module's counter ``name`` under ``_count_lock``."""
    with _count_lock:
        globals()[name] += 1


# lane solves on CUDA tensors that ran the plain lane loop on the card
# because the lane kernel cannot hold their shape (nothing launched)
lane_fallthroughs = 0
# sweeps of the batch-trailing Ruiz loop run in torch (_ruiz_lane); the lane
# kernel scales inside, so a lane solve on the card adds none
lane_ruiz_sweeps = 0


def _solve_qp_batch_lane(prm, P, q, A, l, u, warmstart, factors):
    """The lane backend: the plain whole solve on CPU tensors, one launch of
    the lane kernel on CUDA tensors (or, for a shape the kernel cannot
    hold, decided before anything launches, the plain whole solve on the
    card: one ``lane_fallthroughs``).  With ``prm.polish`` the polish and
    the solution's assembly run after it, batch-leading, from the scaled
    iterates and scalings it returns."""
    from .cuda_kernel import admm_solve_cuda_lane, admm_solve_lane_reference, lane_fits

    dt = A.dtype
    B, m, n = A.shape
    if A.device.type == "cuda" and lane_fits(n, m):
        out = admm_solve_cuda_lane(prm, *_lane_args(P, q, A, l, u, warmstart, factors),
                                   scaled=prm.polish)
        if dt != torch.float32:
            out = type(out)(*(a if a is None or not a.is_floating_point() else a.to(dt)
                              for a in out))
    else:
        if A.device.type == "cuda":
            _bump("lane_fallthroughs")
        ws = (None, None) if warmstart is None else (warmstart.primal, warmstart.dual)
        out = admm_solve_lane_reference(prm, P, q, A, l, u, *ws, factors)
    if prm.polish:
        return _finalize_solution(
            prm, P, q, A, l, u, out.c, out.sx, out.sy, out.x, out.y, out.status, out.iters,
            out.pres, out.dres,
        )
    return QPSolution(
        primal=out.primal, dual=out.dual, status=out.status, iters=out.iters,
        objective=out.objective, primal_res=out.pres, dual_res=out.dres,
    )


# shared-factor solves on backend="cuda" that ran the torch shared loop
# because their shape is past the JAX package's shared_kernel_fits, which
# bounds both routes of the shared kernel (nothing launched)
shared_fallthroughs = 0


def _solve_qp_batch_impl(qp, prm, warmstart, factors):
    P, q, A, l, u, shared = _batch_view(qp, factors)
    if prm.adaptive_rho and (prm.backend == "cuda" or shared):
        raise ValueError(
            "adaptive_rho requires per-problem factors on backend='torch' or 'lane' "
            "(shared-factor batches share one rho across the fleet, and the 'cuda' "
            "kernels keep their factorization on chip)"
        )
    if prm.backend == "lane" and not shared:
        # shared-factor batches on "lane" take the torch shared loop below
        return _solve_qp_batch_lane(prm, P, q, A, l, u, warmstart, factors)
    dt, dev = A.dtype, A.device
    B = q.shape[0]
    inf = float("inf")
    if factors is None:
        factors = _factorize(P, q, A, l, u, prm)
    c, sx, sy, rho, Ps, As, Mred, Minv, fact_ok = factors
    cB, sxB, syB, qs, ls, us, x0, z0, y0, status0 = _scaled_inputs(
        A, q, l, u, factors, warmstart, shared
    )

    on_kernel = prm.backend == "cuda"
    if on_kernel and shared:
        from .cuda_kernel import shared_kernel_fits

        # shapes past the JAX package's shared_kernel_fits take the torch
        # shared loop below on the problems' own device, as its "pallas"
        # backend falls through to its XLA shared-GEMM path; decided by
        # shape before anything launches
        if not shared_kernel_fits(A.shape[-1], A.shape[-2], prm.kernel_block):
            on_kernel = False
            _bump("shared_fallthroughs")
    if on_kernel:
        from .cuda_kernel import admm_iterate_cuda, admm_iterate_cuda_shared, admm_iterate_reference

        if dev.type == "cpu" and dt != torch.float32:
            # the kernels take float32; on CPU tensors of another dtype their
            # plain version runs in that dtype (the wrappers run it on CPU
            # tensors of float32)
            run_shared = run_problem = admm_iterate_reference
            kdt = dt
        else:
            run_shared, run_problem, kdt = admm_iterate_cuda_shared, admm_iterate_cuda, torch.float32
        if shared:
            # sort_stragglers: a pure batch permutation, inverted on the way out
            do_sort = prm.sort_stragglers and warmstart is not None
            if do_sort:
                perm = torch.argsort(warmstart.iters, stable=True)
                inv_perm = torch.argsort(perm)
                qs, ls, us, l_s, u_s, x0, z0, y0, status0 = (
                    a[perm] for a in (qs, ls, us, l, u, x0, z0, y0, status0)
                )
            else:
                l_s, u_s = l, u
            x, z, y, status, iters, pres, dres = run_shared(
                prm, *_kernel_args(factors, qs, ls, us, l_s, u_s, x0, z0, y0, status0, kdt)
            )
            if do_sort:
                x, z, y, status, iters, pres, dres = (
                    a[inv_perm] for a in (x, z, y, status, iters, pres, dres)
                )
        else:
            # each member exits on its own: no straggler sort on this route
            x, z, y, status, iters, pres, dres = run_problem(
                prm, *_kernel_args(factors, qs, ls, us, l, u, x0, z0, y0, status0, kdt)
            )
        return _finalize_solution(
            prm, P, q, A, l, u, cB, sxB, syB, x.to(dt), y.to(dt), status, iters,
            pres.to(dt), dres.to(dt),
        )

    if shared:
        rho = rho[None, :]
        mv = lambda M, r: r @ M.T
    else:
        mv = lambda M, r: torch.einsum("bnm,bm->bn", M, r)
    alpha = prm.alpha
    n_refine = max(0, prm.kkt_refine_iters)

    def Msolve(Minv_, Mred_, r):
        """``Mred^{-1} r`` through the explicit inverse, with ``n_refine``
        sweeps of iterative refinement against ``Mred``."""
        t = mv(Minv_, r)
        for _ in range(n_refine):
            t = t + mv(Minv_, r - mv(Mred_, t))
        return t

    if prm.adaptive_rho:
        # rows whose rho is pinned (unbounded) never adapt; the loop-invariant
        # part of the reduced KKT matrix is hoisted
        rho_pinned = (l == -inf) & (u == inf)
        M0 = Ps + prm.sigma * torch.eye(A.shape[-1], dtype=dt, device=dev)[None]

    x, z, y = x0, z0, y0
    status = status0
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    pres = torch.full((B,), inf, dtype=dt, device=dev)
    dres = torch.full((B,), inf, dtype=dt, device=dev)
    k = prm.stop_check_iter
    it = 0
    while it < prm.max_iter and bool((status == _RUNNING).any()):
        x_old, y_old = x, y
        rhs = prm.sigma * x - qs + _mtv(As, rho * z - y)
        xt = Msolve(Minv, Mred, rhs)
        zt = _mv(As, xt)

        xn = alpha * xt + (1 - alpha) * x
        zn = torch.clamp(alpha * zt + (1 - alpha) * z + y / rho, ls, us)
        yn = y + rho * (alpha * zt + (1 - alpha) * z - zn)

        # == (1 % k) so stop_check_iter == 1 means "every iteration"
        check = it % k == 1 % k
        if check:
            new_status, pres_n, dres_n, ratio = _stopping_check(
                prm, P, q, A, l, u,
                sxB * xn, syB * yn / cB[:, None], zn / syB,
                sxB * (xn - x_old), syB * (yn - y_old) / cB[:, None],
            )
            if prm.verbose:
                _print_check(it, new_status, pres_n, dres_n)
        else:
            new_status = torch.full((B,), _RUNNING, dtype=torch.int32, device=dev)
            pres_n, dres_n = pres, dres

        run = status == _RUNNING
        runc = run[:, None]
        x = torch.where(runc, xn, x)
        z = torch.where(runc, zn, z)
        y = torch.where(runc, yn, y)
        status = torch.where(run, new_status, status)
        iters = torch.where(run, it + 1, iters).to(torch.int32)
        pres = torch.where(run, pres_n, pres)
        dres = torch.where(run, dres_n, dres)
        it += 1

        if prm.adaptive_rho and check:
            # residual balancing: rho <- rho sqrt(pres_n / dres_n) for the
            # members still running whose imbalance leaves the tolerance
            # band; ratio is 1 between checks, so only a check can adapt
            mult = torch.sqrt(ratio)
            tol = prm.adaptive_rho_tol
            adapt = (new_status == _RUNNING) & run & ((mult > tol) | (mult < 1.0 / tol))
            if bool(adapt.any()):
                mult = torch.where(adapt, mult, 1.0)
                rho_new = torch.clamp(rho * mult[:, None], 1e-6, 1e6)
                rho_new = torch.where(rho_pinned, 1e-6, rho_new)
                Mred_n = M0 + torch.einsum("bmn,bm,bmk->bnk", As, rho_new, As)
                Minv_n, bad = _spd_inverse(Mred_n)
                # a failed refactorization keeps the previous rho and factors
                keep = bad[:, None]
                rho = torch.where(keep, rho, rho_new)
                Mred = torch.where(keep[..., None], Mred, Mred_n)
                Minv = torch.where(keep[..., None], Minv, Minv_n)

    status = torch.where(status == _RUNNING, _MAX_ITER, status).to(torch.int32)
    return _finalize_solution(prm, P, q, A, l, u, cB, sxB, syB, x, y, status, iters, pres, dres)


def solve_qp(
    qp: QuadraticProgram,
    prm: QPSolverParams = QPSolverParams(),
    warmstart: Optional[QPSolution] = None,
) -> QPSolution:
    """Solve a single dense QP (unbatched convenience wrapper)."""
    qp_b, ws_b = _batch_of_one(qp, warmstart)
    return QPSolution(*(a[0] for a in solve_qp_batch(qp_b, prm, ws_b)))


def _batch_of_one(qp, warmstart):
    """A single QP and its warm start (or None) with a batch axis of 1."""
    ws = None if warmstart is None else QPSolution(*(a[None] for a in warmstart))
    return QuadraticProgram(*(a[None] for a in qp)), ws


def solve_qp_timed(
    qp: QuadraticProgram,
    prm: QPSolverParams = QPSolverParams(),
    warmstart: Optional[QPSolution] = None,
    max_time: float = float("inf"),
    chunk_iter: int = 200,
) -> QPSolution:
    """Solve with a host wall-clock budget: the batched solve runs in chunks
    of ``chunk_iter`` ADMM iterations, each warm-started from the last, and
    the clock is read between chunks.  Members still unconverged when the
    budget runs out return ``MaxTime``; ``iters`` accumulates over the chunks
    in which a member was still unconverged (a converged member re-enters
    the next chunk as a warm start, and its few iterations there are not new
    work).  Accepts a single or a batched ``qp``."""
    batched = qp.P.dim() == 3
    qp_b, ws = (qp, warmstart) if batched else _batch_of_one(qp, warmstart)
    deadline = time.monotonic() + max_time
    total = 0
    iters_acc = None
    unconverged_prev = None
    while True:
        this_chunk = min(chunk_iter, prm.max_iter - total)
        sol = solve_qp_batch(qp_b, dataclasses.replace(prm, max_iter=this_chunk), ws)
        if iters_acc is None:
            iters_acc = sol.iters
        else:
            iters_acc = iters_acc + torch.where(unconverged_prev, sol.iters, 0).to(torch.int32)
        total += this_chunk
        unconverged = sol.status == _MAX_ITER
        if not bool(unconverged.any()) or total >= prm.max_iter:
            break
        if time.monotonic() >= deadline:
            status = torch.where(unconverged, int(QPSolutionStatus.MaxTime), sol.status)
            sol = sol._replace(status=status.to(torch.int32))
            break
        ws = sol
        unconverged_prev = unconverged
    sol = sol._replace(iters=iters_acc)
    return sol if batched else QPSolution(*(a[0] for a in sol))


def qp_phase_timings(
    qp: QuadraticProgram,
    prm: QPSolverParams = QPSolverParams(),
    warmstart: Optional[QPSolution] = None,
    reps: int = 3,
) -> dict:
    """Wall-time breakdown of a (batched) QP solve, the counterpart of the
    reference verbose mode's Factorization / Iteration / Polish table:
    ``factor_ms`` (scaling and KKT factorization, ``qp_factorize``),
    ``iterate_ms`` (the solve with polish off, minus ``factor_ms``),
    ``polish_ms`` (the configured solve minus the one with polish off; 0.0
    when ``prm.polish`` is off) and ``total_ms`` (the configured solve).
    Each leg runs once to warm up, then ``reps`` times, each ended by a
    device synchronise; the best counts.  A tuning utility, not for
    production loops."""
    qp_b, ws = (qp, warmstart) if qp.P.dim() == 3 else _batch_of_one(qp, warmstart)
    _check_params(prm)
    dev = qp_b.A.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def best(fn):
        out = fn()
        sync()
        ms = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            sync()
            ms = min(ms, 1e3 * (time.perf_counter() - t0))
        return ms, out

    prm_np = dataclasses.replace(prm, polish=False)
    with ieee_f32_matmul():
        factor_ms, _ = best(lambda: qp_factorize(qp_b, prm))
        nopolish_ms, sol = best(lambda: _solve_qp_batch_impl(qp_b, prm_np, ws, None))
        if prm.polish:
            total_ms, sol = best(lambda: _solve_qp_batch_impl(qp_b, prm, ws, None))
            polish_ms = max(0.0, total_ms - nopolish_ms)
        else:
            total_ms, polish_ms = nopolish_ms, 0.0
    return {
        "factor_ms": round(factor_ms, 4),
        "iterate_ms": round(max(0.0, nopolish_ms - factor_ms), 4),
        "polish_ms": round(polish_ms, 4),
        "total_ms": round(total_ms, 4),
        "iters_mean": float(sol.iters.float().mean()),
        "batch": int(qp_b.P.shape[0]),
    }
