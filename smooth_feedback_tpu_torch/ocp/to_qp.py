"""OCP -> dense QP transcription via linearization (PyTorch port of
``smooth_feedback_tpu/ocp/to_qp.py``).

The Lie-group OCP is linearized in the tangent space around a nominal
trajectory (xl(t), ul(t)) and collocated on an LGR mesh, giving a dense QP over

    z = [dx_0 ... dx_N,  du_0 ... du_{N-1}]

with constraints [dynamics defects; running constraints; end constraints].
Linearizations are ``torch.func.jacfwd``/``grad``/``hessian`` of the user's
functions, batched over the mesh nodes with ``torch.func.vmap``.  The
non-commutative correction ``-(tf/2) ad(f + dxl)`` on the state Jacobian is
kept exactly.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import grad, vmap

from .._func import hessian, jacfwd
from .._precision import ieee_f32_matmul
from ..qp.types import QPSolution, QuadraticProgram
from .collocation.functions import mesh_interp
from .collocation.mesh import Mesh, diffmat_local
from .ocp import OCP, OCPSolution


def variable_layout(ocp: OCP, mesh: Mesh):
    """Index layout [x-vars, u-vars] / [dyn, cr, ce]."""
    N = mesh.N_colloc
    nx, nu = ocp.nx, ocp.nu
    xvar_L = nx * (N + 1)
    uvar_L = nu * N
    dcon_L = nx * N
    crcon_L = ocp.ncr * N
    cecon_L = ocp.nce
    return dict(
        N=N,
        nx=nx,
        nu=nu,
        xvar_B=0,
        xvar_L=xvar_L,
        uvar_B=xvar_L,
        uvar_L=uvar_L,
        Nvar=xvar_L + uvar_L,
        dcon_B=0,
        dcon_L=dcon_L,
        crcon_B=dcon_L,
        crcon_L=crcon_L,
        cecon_B=dcon_L + crcon_L,
        cecon_L=cecon_L,
        Ncon=dcon_L + crcon_L + cecon_L,
    )


def body_velocity(G, xfun: Callable, t):
    """Body velocity ``d^r xl / dt`` of a group-valued trajectory at ``t``."""
    h0 = torch.zeros((), dtype=t.dtype, device=t.device)
    return jacfwd(lambda h: G.rminus(xfun(t + h), xfun(t)))(h0)


def _add(T, index, vals):
    """Out-of-place scatter-add ``T[index] += vals`` (numpy index arrays)."""
    idx = tuple(torch.as_tensor(np.asarray(i), device=T.device) for i in index)
    return T.index_put(idx, vals.to(T.dtype), accumulate=True)


def _set(T, index, vals):
    idx = tuple(torch.as_tensor(np.asarray(i), device=T.device) for i in index)
    return T.index_put(idx, vals.to(T.dtype))


def ocp_to_qp(
    ocp: OCP,
    mesh: Mesh,
    tf,
    xl_fun: Callable,
    ul_fun: Callable,
    dxl_fun: Optional[Callable] = None,
    *,
    dtype=torch.float64,
    device="cuda",
) -> QuadraticProgram:
    """Dense QP linearizing ``ocp`` around ``(xl_fun, ul_fun)``, assembled in
    ``dtype`` on ``device``.  ``dxl_fun(t) -> (nx,)`` optionally supplies the
    body velocity of ``xl_fun`` (otherwise forward-mode autodiff in time)."""
    return _ocp_to_qp_impl(ocp, mesh, tf, xl_fun, ul_fun, dxl_fun, dtype, device)


def ocp_to_qp_vectors(
    ocp: OCP,
    mesh: Mesh,
    tf,
    xl_fun: Callable,
    ul_fun: Callable,
    dxl_fun: Optional[Callable] = None,
    *,
    dtype=torch.float64,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Only the ``(q, l, u)`` vectors of :func:`ocp_to_qp`: function values
    and cost gradients at the nodes, no Jacobians or Hessians.  For problem
    families whose P/A are step-invariant (the condensed MPC fleet)."""
    return _ocp_to_qp_impl(
        ocp, mesh, tf, xl_fun, ul_fun, dxl_fun, dtype, device, vectors_only=True
    )


@ieee_f32_matmul()
def _ocp_to_qp_impl(
    ocp, mesh, tf, xl_fun, ul_fun, dxl_fun, dtype, device, vectors_only=False
):
    X, U = ocp.X, ocp.U
    lay = variable_layout(ocp, mesh)
    N, nx, nu = lay["N"], lay["nx"], lay["nu"]
    Nvar, Ncon = lay["Nvar"], lay["Ncon"]
    ncr, nce = ocp.ncr, ocp.nce
    t0 = 0.0
    kw = dict(dtype=dtype, device=device)

    taus = np.asarray(mesh.all_nodes())  # (N+1,)
    ws = np.asarray(mesh.all_weights())  # (N+1,), last = 0
    tf = torch.as_tensor(tf, **kw)
    ts = t0 + (tf - t0) * torch.as_tensor(taus, **kw)

    if dxl_fun is None:
        dxl_fun = lambda t: body_velocity(X, xl_fun, t)

    # ---- linearization trajectories at the nodes
    xls = vmap(xl_fun)(ts)  # (N+1, xparams)
    uls = vmap(ul_fun)(ts[:N])  # (N, uparams)
    dxls = vmap(dxl_fun)(ts)  # (N+1, nx)

    zx = torch.zeros((nx,), **kw)
    zu = torch.zeros((nu,), **kw)

    # ================================================================= cost
    ql = torch.ones((1,), **kw)
    xl0, xlf = xls[0], xls[N]

    def theta_t(wx0, wxf, dq):
        return ocp.theta(tf, X.rplus(xl0, wx0), X.rplus(xlf, wxf), ql + dq)

    qo_x0, qo_xf, qo_q = grad(theta_t, argnums=(0, 1, 2))(zx, zx, torch.zeros((1,), **kw))

    def g_node(t, xl, ul, w):
        return ocp.g(t, X.rplus(xl, w[:nx]), U.rplus(ul, w[nx:]))[0]

    zxu = torch.zeros((nx + nu,), **kw)
    g_grads = vmap(lambda t, xl, ul: grad(lambda w: g_node(t, xl, ul, w))(zxu))(
        ts[:N], xls[:N], uls
    )  # (N, nx+nu)

    wtf = torch.as_tensor(ws[:N], **kw) * (tf - t0)  # quadrature * horizon

    q = torch.zeros((Nvar,), **kw)
    xrows = np.arange(N)[:, None] * nx + np.arange(nx)[None, :]  # (N, nx)
    urows = lay["uvar_B"] + np.arange(N)[:, None] * nu + np.arange(nu)[None, :]
    gq = qo_q[0] * wtf[:, None] * g_grads
    q = _add(q, (xrows,), gq[:, :nx])
    q = _add(q, (urows,), gq[:, nx:])

    x0_idx = np.arange(nx)
    xf_idx = N * nx + np.arange(nx)
    q = _add(q, (x0_idx,), qo_x0)
    q = _add(q, (xf_idx,), qo_xf)

    if not vectors_only:
        th_hess = hessian(lambda w: theta_t(w[:nx], w[nx : 2 * nx], w[2 * nx :]))(
            torch.zeros((2 * nx + 1,), **kw)
        )
        g_hesss = vmap(lambda t, xl, ul: hessian(lambda w: g_node(t, xl, ul, w))(zxu))(
            ts[:N], xls[:N], uls
        )  # (N, nx+nu, nx+nu)

        P = torch.zeros((Nvar, Nvar), **kw)
        hx = qo_q[0] * wtf[:, None, None] * g_hesss
        P = _add(P, (xrows[:, :, None], xrows[:, None, :]), hx[:, :nx, :nx])
        P = _add(P, (xrows[:, :, None], urows[:, None, :]), hx[:, :nx, nx:])
        P = _add(P, (urows[:, :, None], xrows[:, None, :]), hx[:, nx:, :nx])
        P = _add(P, (urows[:, :, None], urows[:, None, :]), hx[:, nx:, nx:])

        P = _add(P, np.ix_(x0_idx, x0_idx), 0.5 * th_hess[:nx, :nx])
        P = _add(P, np.ix_(x0_idx, xf_idx), 0.5 * th_hess[:nx, nx : 2 * nx])
        P = _add(P, np.ix_(xf_idx, x0_idx), 0.5 * th_hess[nx : 2 * nx, :nx])
        P = _add(P, np.ix_(xf_idx, xf_idx), 0.5 * th_hess[nx : 2 * nx, nx : 2 * nx])

    # ============================================================ dynamics
    l = torch.zeros((Ncon,), **kw)
    u = torch.zeros((Ncon,), **kw)
    drows = np.arange(N)[:, None] * nx + np.arange(nx)[None, :]

    if vectors_only:
        fvals = vmap(ocp.f)(ts[:N], xls[:N], uls)  # (N, nx)
    else:

        def lin_dyn(t, xl, ul):
            fval = ocp.f(t, xl, ul)
            Af = jacfwd(lambda w: ocp.f(t, X.rplus(xl, w), ul))(zx)
            Bf = jacfwd(lambda v: ocp.f(t, xl, U.rplus(ul, v)))(zu)
            return fval, Af, Bf

        fvals, Afs, Bfs = vmap(lin_dyn)(ts[:N], xls[:N], uls)

        A = torch.zeros((Ncon, Nvar), **kw)
        Ablocks = tf * Afs
        if not X.is_commutative():
            ad_corr = vmap(X.ad)(fvals + dxls[:N])  # (N, nx, nx)
            Ablocks = Ablocks - 0.5 * tf * ad_corr
        Bblocks = tf * Bfs

        A = _add(A, (drows[:, :, None], xrows[:, None, :]), Ablocks)
        A = _add(A, (drows[:, :, None], urows[:, None, :]), Bblocks)

        # differentiation-matrix coupling: row block i, col block j: -alpha D[j,i] I
        offsets = mesh.interval_offsets()
        R_idx, C_idx, V_val = [], [], []
        for ival in range(mesh.N_ivals):
            K = mesh.N_colloc_ival(ival)
            D = diffmat_local(K)
            alpha = mesh.interval_diffmat_unscaled(ival)[0]
            o = int(offsets[ival])
            rows_i = (o + np.arange(K))[:, None, None] * nx + np.arange(nx)[None, None, :]
            cols_j = (o + np.arange(K + 1))[None, :, None] * nx + np.arange(nx)[None, None, :]
            R3 = np.broadcast_to(rows_i, (K, K + 1, nx))
            C3 = np.broadcast_to(cols_j, (K, K + 1, nx))
            V3 = np.broadcast_to((-alpha * D.T)[:, :, None], (K, K + 1, nx))
            R_idx.append(R3.reshape(-1))
            C_idx.append(C3.reshape(-1))
            V_val.append(V3.reshape(-1))
        A = _add(
            A,
            (np.concatenate(R_idx), np.concatenate(C_idx)),
            torch.as_tensor(np.concatenate(V_val), **kw),
        )

    ldyn = -tf * (fvals - dxls[:N])  # (N, nx)
    l = _set(l, (drows,), ldyn)
    u = _set(u, (drows,), ldyn)

    # ================================================== running constraints
    if ncr > 0:
        crrows = lay["crcon_B"] + np.arange(N)[:, None] * ncr + np.arange(ncr)[None, :]
        if vectors_only:
            crs = vmap(ocp.cr)(ts[:N], xls[:N], uls)
        else:

            def lin_cr(t, xl, ul):
                c = ocp.cr(t, xl, ul)
                Jx = jacfwd(lambda w: ocp.cr(t, X.rplus(xl, w), ul))(zx)
                Ju = jacfwd(lambda v: ocp.cr(t, xl, U.rplus(ul, v)))(zu)
                return c, Jx, Ju

            crs, Jxs, Jus = vmap(lin_cr)(ts[:N], xls[:N], uls)
            A = _add(A, (crrows[:, :, None], xrows[:, None, :]), Jxs)
            A = _add(A, (crrows[:, :, None], urows[:, None, :]), Jus)
        l = _set(l, (crrows,), ocp.crl.to(**kw)[None, :] - crs)
        u = _set(u, (crrows,), ocp.cru.to(**kw)[None, :] - crs)

    # ====================================================== end constraints
    if nce > 0:
        ceval = ocp.ce(tf, xl0, xlf, ql)
        cerows = lay["cecon_B"] + np.arange(nce)
        if not vectors_only:
            Jce0 = jacfwd(lambda w: ocp.ce(tf, X.rplus(xl0, w), xlf, ql))(zx)
            Jcef = jacfwd(lambda w: ocp.ce(tf, xl0, X.rplus(xlf, w), ql))(zx)
            A = _add(A, np.ix_(cerows, x0_idx), Jce0)
            A = _add(A, np.ix_(cerows, xf_idx), Jcef)
        l = _set(l, (cerows,), ocp.cel.to(**kw) - ceval)
        u = _set(u, (cerows,), ocp.ceu.to(**kw) - ceval)

    if vectors_only:
        return q, l, u
    return QuadraticProgram(P=P, q=q, A=A, l=l, u=u)


def qpsol_to_ocpsol(
    ocp: OCP,
    mesh: Mesh,
    qpsol: QPSolution,
    tf,
    xl_fun: Callable,
    ul_fun: Callable,
) -> OCPSolution:
    """Interpolate a QP solution back into OCP trajectories: the tangent
    deviations at the nodes, interpolated on ``mesh`` and applied to the
    nominal ``(xl_fun(t), ul_fun(t))`` with ``rplus``."""
    lay = variable_layout(ocp, mesh)
    N, nx, nu = lay["N"], lay["nx"], lay["nu"]
    Xmat = qpsol.primal[: lay["xvar_L"]].reshape(N + 1, nx)
    Umat = qpsol.primal[lay["uvar_B"] :].reshape(N, nu)
    X, U = ocp.X, ocp.U
    tf = torch.as_tensor(tf, dtype=Xmat.dtype, device=Xmat.device)

    def xfun(t):
        tngnt = mesh_interp(mesh, Xmat, t / tf, extend=True)
        return X.rplus(xl_fun(t), tngnt)

    def ufun(t):
        tngnt = mesh_interp(mesh, Umat, t / tf, extend=False)
        return U.rplus(ul_fun(t), tngnt)

    return OCPSolution(t0=0.0, tf=tf, x=xfun, u=ufun)
