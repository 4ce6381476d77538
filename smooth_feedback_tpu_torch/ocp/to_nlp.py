"""Flat OCP -> NLP transcription via LGR collocation (PyTorch port of
``smooth_feedback_tpu/ocp/to_nlp.py``).

Variables are

    z = [tf, q, X(N+1, nx).ravel(), U(N, nu).ravel()]

and constraints [dynamics defects; integral consistency; running; endpoint].
The NLP's f and g are plain torch functions built from the collocation mesh
operations; solvers differentiate them with ``torch.func``.  Dynamics
defects carry quadrature weights, and running-constraint rows and bounds
are scaled by ``w_scaling * w_i`` with ``w_scaling = 1/max(w)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..nlp import NLP, NLPSolution
from .collocation.functions import constant_like, mesh_dyn, mesh_eval, mesh_integrate, mesh_interp
from .collocation.mesh import Mesh
from .ocp import OCP, OCPSolution


class NLPLayout(NamedTuple):
    N: int
    nx: int
    nu: int
    nq: int
    ncr: int
    nce: int
    tf_B: int
    q_B: int
    x_B: int
    u_B: int
    n: int
    d_B: int
    qc_B: int
    cr_B: int
    ce_B: int
    m: int


def nlp_layout(ocp: OCP, mesh: Mesh) -> NLPLayout:
    N = mesh.N_colloc
    nx, nu, nq, ncr, nce = ocp.nx, ocp.nu, ocp.nq, ocp.ncr, ocp.nce
    tf_B = 0
    q_B = 1
    x_B = q_B + nq
    u_B = x_B + nx * (N + 1)
    n = u_B + nu * N
    d_B = 0
    qc_B = d_B + nx * N
    cr_B = qc_B + nq
    ce_B = cr_B + ncr * N
    m = ce_B + nce
    return NLPLayout(N, nx, nu, nq, ncr, nce, tf_B, q_B, x_B, u_B, n, d_B, qc_B, cr_B, ce_B, m)


def split_vars(lay: NLPLayout, z):
    tf = z[lay.tf_B]
    q = z[lay.q_B : lay.q_B + lay.nq]
    X = z[lay.x_B : lay.u_B].reshape(lay.N + 1, lay.nx)
    U = z[lay.u_B :].reshape(lay.N, lay.nu)
    return tf, q, X, U


def node_scalings(mesh: Mesh, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Per-node row scaling ``w_scaling * w_i`` of the dynamics-defect and
    running-constraint rows.  Their multipliers carry the inverse of this
    scaling; dividing it out gives the smooth continuous-time (density)
    multipliers that interpolate and transfer across meshes."""
    ws = np.asarray(mesh.all_weights())
    w_scaling = 1.0 / max(1e-6, float(ws.max()))
    return torch.as_tensor(w_scaling * ws[: mesh.N_colloc], dtype=dtype, device=device)


def ocp_to_nlp(ocp: OCP, mesh: Mesh, dtype=None, device=None) -> NLP:
    """Transcribe a flat OCP into an NLP.  ``dtype`` and ``device`` are
    those of the bounds (the problem's bound tensors' own by default)."""
    lay = nlp_layout(ocp, mesh)
    N, nx, nq = lay.N, lay.nx, lay.nq
    dtype = ocp.crl.dtype if dtype is None else dtype
    device = ocp.crl.device if device is None else device
    kw = dict(dtype=dtype, device=device)

    ws = np.asarray(mesh.all_weights())
    w_scaling = 1.0 / max(1e-6, float(ws.max()))
    row_scale = w_scaling * ws[:N]  # (N,) numpy

    def f(z):
        tf, q, X, U = split_vars(lay, z)
        return ocp.theta(tf, X[0], X[N], q)

    def g(z):
        tf, q, X, U = split_vars(lay, z)
        t0 = torch.zeros_like(tf)
        # weighted collocation defects, scaled by w_scaling
        d = w_scaling * mesh_dyn(mesh, ocp.f, t0, tf, X, U, weighted=True)
        # integral consistency: q - sum w (tf) g = 0
        qv = q - mesh_integrate(mesh, ocp.g, t0, tf, X, U)
        # running constraints scaled by w_scaling * w_i
        crv = mesh_eval(mesh, ocp.cr, t0, tf, X, U)  # (N, ncr)
        crv = constant_like(row_scale, z)[:, None] * crv
        cev = ocp.ce(tf, X[0], X[N], q)
        return torch.cat([d.reshape(-1), qv, crv.reshape(-1), cev])

    inf = float("inf")
    xl = torch.full((lay.n,), -inf, **kw)
    xl[lay.tf_B] = 0.0  # tf >= 0
    xu = torch.full((lay.n,), inf, **kw)

    crl, cru = ocp.crl.to(**kw), ocp.cru.to(**kw)
    s = constant_like(row_scale, crl)[:, None]
    cr_l = (s * crl[None, :]).reshape(-1)
    cr_u = (s * cru[None, :]).reshape(-1)
    zeros = torch.zeros((nx * N + nq,), **kw)
    gl = torch.cat([zeros, cr_l, ocp.cel.to(**kw)])
    gu = torch.cat([zeros, cr_u, ocp.ceu.to(**kw)])
    return NLP(n=lay.n, m=lay.m, f=f, g=g, xl=xl, xu=xu, gl=gl, gu=gu)


def nlp_initial_guess(ocp: OCP, mesh: Mesh, tf: float, dtype=None, device=None) -> torch.Tensor:
    """Zero-deviation initial guess with the given horizon, in the dtype and
    on the device of the problem's bounds unless given (as
    :func:`ocp_to_nlp`)."""
    lay = nlp_layout(ocp, mesh)
    dtype = ocp.crl.dtype if dtype is None else dtype
    device = ocp.crl.device if device is None else device
    z = torch.zeros((lay.n,), dtype=dtype, device=device)
    z[lay.tf_B] = tf
    return z


def nlpsol_to_ocpsol(ocp: OCP, mesh: Mesh, nlpsol: NLPSolution) -> OCPSolution:
    """Trajectory callables of an NLP solution.  ``lam_dyn(t)`` /
    ``lam_cr(t)`` return the scaling-free (density) multipliers: the NLP's
    multipliers divided by each row's transcription scaling."""
    lay = nlp_layout(ocp, mesh)
    tf, q, X, U = split_vars(lay, nlpsol.x)

    def xfun(t):
        return mesh_interp(mesh, X, t / tf, extend=True)

    def ufun(t):
        return mesh_interp(mesh, U, t / tf, extend=False)

    s = node_scalings(mesh, nlpsol.x.dtype, nlpsol.x.device)  # (N,)
    lam_d = nlpsol.lam[lay.d_B : lay.qc_B].reshape(lay.N, lay.nx) / s[:, None]
    lam_cr = nlpsol.lam[lay.cr_B : lay.ce_B].reshape(lay.N, lay.ncr) / s[:, None]

    def lam_dyn_fun(t):
        return mesh_interp(mesh, lam_d, t / tf, extend=False)

    def lam_cr_fun(t):
        return mesh_interp(mesh, lam_cr, t / tf, extend=False)

    return OCPSolution(
        t0=0.0,
        tf=tf,
        x=xfun,
        u=ufun,
        q=q,
        lam_q=nlpsol.lam[lay.qc_B : lay.cr_B],
        lam_ce=nlpsol.lam[lay.ce_B :],
        lam_dyn=lam_dyn_fun,
        lam_cr=lam_cr_fun,
    )


def ocpsol_to_nlpsol(
    ocp: OCP, mesh: Mesh, ocpsol: OCPSolution, dtype=None, multipliers: bool = False
):
    """Sample an OCP solution onto a (possibly different) mesh as an NLP
    warm start.  With ``multipliers=True`` returns ``(z, lam)``: the density
    multipliers sampled at the new mesh's nodes and scaled by its row
    scaling, ``lam_q``/``lam_ce`` carried over (bound multipliers restart
    at zero)."""
    lay = nlp_layout(ocp, mesh)
    tf = torch.as_tensor(ocpsol.tf)
    dtype = tf.dtype if dtype is None else dtype
    tf = tf.to(dtype)
    kw = dict(dtype=dtype, device=tf.device)
    taus = torch.as_tensor(np.asarray(mesh.all_nodes()), **kw)
    X = vmap(lambda s: ocpsol.x(s * tf))(taus)
    U = vmap(lambda s: ocpsol.u(s * tf))(taus[: lay.N])
    q = ocpsol.q if ocpsol.q is not None else torch.zeros((lay.nq,), **kw)
    z = torch.cat([tf[None], q.to(dtype), X.reshape(-1).to(dtype), U.reshape(-1).to(dtype)])
    if not multipliers:
        return z

    s_new = node_scalings(mesh, **kw)  # (N,)
    zeros = lambda *shape: torch.zeros(shape, **kw)
    lam_d = (
        s_new[:, None] * vmap(lambda s: ocpsol.lam_dyn(s * tf))(taus[: lay.N])
        if ocpsol.lam_dyn is not None
        else zeros(lay.N, lay.nx)
    )
    lam_cr = (
        s_new[:, None] * vmap(lambda s: ocpsol.lam_cr(s * tf))(taus[: lay.N])
        if ocpsol.lam_cr is not None
        else zeros(lay.N, lay.ncr)
    )
    lam_q = ocpsol.lam_q if ocpsol.lam_q is not None else zeros(lay.nq)
    lam_ce = ocpsol.lam_ce if ocpsol.lam_ce is not None else zeros(lay.nce)
    lam = torch.cat([
        lam_d.reshape(-1).to(dtype), lam_q.to(dtype), lam_cr.reshape(-1).to(dtype),
        lam_ce.to(dtype),
    ])
    return z, lam
