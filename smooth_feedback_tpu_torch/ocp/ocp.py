"""Optimal control problem definition (PyTorch port of ``ocp/ocp.py``).

    min    theta(tf, x0, xf, q)
    s.t.   d^r x_t = f(t, x, u)
           q = integral g(t, x, u) dt
           crl <= cr(t, x, u) <= cru
           cel <= ce(tf, x0, xf, q) <= ceu

A plain container of torch-traceable callables plus the state/input group
descriptions; derivatives come from ``torch.func`` in the transcription.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

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
