"""Lie-group OCP flattening (PyTorch port of ``smooth_feedback_tpu/ocp/flatten.py``).

The change of variables

    x = xl(t) (+) e,      u = ul(t) (+) v

turns an OCP on a Lie group into an OCP on Euclidean tangent space.  The
flat dynamics follow from  d/dt (xl exp(e)) = x hat(f):

    de/dt = dr_expinv(e) f(t, xl (+) e, ul (+) v) - dl_expinv(e) dxl(t)

Costs and constraints flatten by plain composition with (+); the flat
functions are ordinary torch compositions, differentiated by ``torch.func``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..groups.groups import Rn
from .ocp import OCP, OCPSolution
from .to_qp import body_velocity


def flatten_ocp(
    ocp: OCP,
    xl_fun: Callable,
    ul_fun: Callable,
    dxl_fun: Optional[Callable] = None,
) -> OCP:
    """Flatten a Lie-group OCP around nominal trajectories.  Returns an OCP
    on Rn(nx) x Rn(nu) whose trajectories are tangent deviations from
    ``(xl_fun, ul_fun)``."""
    X, U = ocp.X, ocp.U
    nx, nu = X.ndof, U.ndof
    if dxl_fun is None:
        dxl_fun = lambda t: body_velocity(X, xl_fun, t)

    def fe(t, e, v):
        x = X.rplus(xl_fun(t), e)
        u = U.rplus(ul_fun(t), v)
        fval = ocp.f(t, x, u)
        return X.dr_expinv(e) @ fval - X.dl_expinv(e) @ dxl_fun(t)

    def ge(t, e, v):
        return ocp.g(t, X.rplus(xl_fun(t), e), U.rplus(ul_fun(t), v))

    def cre(t, e, v):
        return ocp.cr(t, X.rplus(xl_fun(t), e), U.rplus(ul_fun(t), v))

    def thetae(tf, e0, ef, q):
        return ocp.theta(
            tf, X.rplus(xl_fun(torch.zeros_like(tf)), e0), X.rplus(xl_fun(tf), ef), q
        )

    def cee(tf, e0, ef, q):
        return ocp.ce(
            tf, X.rplus(xl_fun(torch.zeros_like(tf)), e0), X.rplus(xl_fun(tf), ef), q
        )

    return OCP(
        X=Rn(nx),
        U=Rn(nu),
        theta=thetae,
        f=fe,
        g=ge,
        cr=cre,
        crl=ocp.crl,
        cru=ocp.cru,
        ce=cee,
        cel=ocp.cel,
        ceu=ocp.ceu,
    )


def unflatten_ocpsol(
    flatsol: OCPSolution, ocp: OCP, xl_fun: Callable, ul_fun: Callable
) -> OCPSolution:
    """Map a flat solution back onto the group."""
    X, U = ocp.X, ocp.U

    def xfun(t):
        return X.rplus(xl_fun(t), flatsol.x(t))

    def ufun(t):
        return U.rplus(ul_fun(t), flatsol.u(t))

    return flatsol._replace(x=xfun, u=ufun)
