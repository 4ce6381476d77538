"""Optimal control problem definition (PyTorch port of ``ocp/ocp.py``).

    min    theta(tf, x0, xf, q)
    s.t.   d^r x_t = f(t, x, u)
           q = integral g(t, x, u) dt
           crl <= cr(t, x, u) <= cru
           cel <= ce(tf, x0, xf, q) <= ceu

A plain container of torch-traceable callables plus the state/input group
descriptions; derivatives come from ``torch.func`` in the transcriptions, and
:func:`test_ocp_derivatives` checks them against finite differences.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .._func import jacfwd
from ..groups.base import LieGroup


class OCP(NamedTuple):
    """Optimal control problem on Lie groups."""

    X: LieGroup  # state group
    U: LieGroup  # input group
    theta: Callable  # (tf, x0, xf, q) -> scalar       endpoint cost
    f: Callable  # (t, x, u) -> (nx,)                  dynamics (body velocity)
    g: Callable  # (t, x, u) -> (nq,)                  running cost integrand
    cr: Callable  # (t, x, u) -> (ncr,)                running constraints
    crl: torch.Tensor  # (ncr,)
    cru: torch.Tensor  # (ncr,)
    ce: Callable  # (tf, x0, xf, q) -> (nce,)          end constraints
    cel: torch.Tensor  # (nce,)
    ceu: torch.Tensor  # (nce,)

    @property
    def nx(self) -> int:
        return self.X.ndof

    @property
    def nu(self) -> int:
        return self.U.ndof

    @property
    def nq(self) -> int:
        """Integral-cost width, from one evaluation of ``g`` at the identity."""
        kw = dict(dtype=self.crl.dtype, device=self.crl.device)
        t = torch.zeros((), **kw)
        return int(self.g(t, self.X.identity(**kw), self.U.identity(**kw)).shape[0])

    @property
    def ncr(self) -> int:
        return int(self.crl.shape[0])

    @property
    def nce(self) -> int:
        return int(self.cel.shape[0])


class OCPSolution(NamedTuple):
    """Solution trajectories: ``x``/``u`` are callables of time."""

    t0: float
    tf: torch.Tensor
    x: Callable  # t -> (nparams_x,)
    u: Callable  # t -> (nparams_u,)
    q: Optional[torch.Tensor] = None
    lam_q: Optional[torch.Tensor] = None
    lam_ce: Optional[torch.Tensor] = None
    lam_dyn: Optional[Callable] = None
    lam_cr: Optional[Callable] = None


def _np(t):
    """A dense numpy copy (torch.func returns the efficient zero tensor for
    derivatives that vanish identically)."""
    return torch.zeros(t.shape, dtype=t.dtype).add(t).numpy()


def _check_first_second(fn_c, ndof, eps, label, second_order, dtype):
    """First- and second-order finite-difference consistency of a chart map
    ``w -> fn_c(w)`` around w = 0."""
    z = torch.zeros(ndof, dtype=dtype)
    J = _np(jacfwd(fn_c)(z))
    assert np.isfinite(J).all(), f"non-finite d{label}"
    for d in range(ndof):
        e = z.clone()
        e[d] = eps
        fd = (fn_c(e) - fn_c(-e)) / (2 * eps)
        np.testing.assert_allclose(J[..., d], _np(fd), atol=1e-4, rtol=1e-4, err_msg=f"d{label}")
    if not second_order:
        return
    Jfun = jacfwd(fn_c)
    H = _np(jacfwd(Jfun)(z))
    assert np.isfinite(H).all(), f"non-finite d2{label}"
    feps = float(eps) ** 0.5  # finite differences of an exact Jacobian: a larger step
    for d in range(ndof):
        e = z.clone()
        e[d] = feps
        fd = (Jfun(e) - Jfun(-e)) / (2 * feps)
        np.testing.assert_allclose(H[..., d], _np(fd), atol=1e-3, rtol=1e-3, err_msg=f"d2{label}")
    # symmetry of the mixed partials (a cheap state-bug detector)
    np.testing.assert_allclose(H, np.swapaxes(H, -1, -2), atol=1e-9, err_msg=label)


def test_ocp_derivatives(
    ocp: OCP,
    generator: torch.Generator,
    num: int = 3,
    eps: float = 1e-6,
    second_order: bool = True,
    dtype=torch.float64,
):
    """Self-check: autodiff first and second derivatives of the user's
    callables are finite and agree with finite differences at ``num`` random
    points drawn from ``generator`` (a CPU ``torch.Generator``), in
    ``dtype``.  Raises AssertionError on failure.  Call it twice to catch
    hidden state."""
    X, U = ocp.X, ocp.U
    nq = ocp.nq
    for _ in range(num):
        t = torch.rand((), generator=generator, dtype=dtype)
        x = X.random(generator, 0.5, dtype=dtype)
        u = U.random(generator, 0.5, dtype=dtype)
        q = torch.randn((nq,), generator=generator, dtype=dtype)

        # dynamics / running-cost / running-constraint charts in (x, u)
        for fn, label in ((ocp.f, "f"), (ocp.g, "g"), (ocp.cr, "cr")):
            assert bool(torch.isfinite(fn(t, x, u)).all()), f"non-finite {label}"

            def chart(w, fn=fn):
                return fn(t, X.rplus(x, w[: X.ndof]), U.rplus(u, w[X.ndof :]))

            _check_first_second(chart, X.ndof + U.ndof, eps, label, second_order, dtype)

        # endpoint functions: chart in (x0, xf, q)
        for fn, label in ((ocp.theta, "theta"), (ocp.ce, "ce")):
            assert bool(torch.isfinite(fn(t, x, x, q)).all()), f"non-finite {label}"

            def chart(w, fn=fn):
                return fn(
                    t,
                    X.rplus(x, w[: X.ndof]),
                    X.rplus(x, w[X.ndof : 2 * X.ndof]),
                    q + w[2 * X.ndof :],
                )

            _check_first_second(chart, 2 * X.ndof + nq, eps, label, second_order, dtype)
