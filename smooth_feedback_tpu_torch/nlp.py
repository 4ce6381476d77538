"""Nonlinear program types (PyTorch port of ``smooth_feedback_tpu/nlp.py``).

An NLP

    min   f(x)
    s.t.  xl <= x <= xu
          gl <= g(x) <= gu

is a container of torch callables plus bound tensors.  Derivatives are not
part of the interface: solvers take them with ``torch.func``.  It lives at
the package top level so that the solvers and the OCP transcription can
both depend on it.
"""

from __future__ import annotations

import enum
from typing import Callable, NamedTuple

import torch

from ._func import hessian


class NLP(NamedTuple):
    n: int  # number of variables
    m: int  # number of constraints
    f: Callable  # (n,) -> scalar           objective
    g: Callable  # (n,) -> (m,)             constraints
    xl: torch.Tensor  # (n,) variable lower bounds
    xu: torch.Tensor  # (n,) variable upper bounds
    gl: torch.Tensor  # (m,) constraint lower bounds
    gu: torch.Tensor  # (m,) constraint upper bounds


class HessianNLP(NamedTuple):
    """NLP with explicit second-order callables: ``d2f_dx2(x)`` and the
    multiplier-contracted ``d2g_dx2(x, lam)``, the surface external solvers
    with an explicit-derivative interface consume.  Build one from a plain
    :class:`NLP` with :func:`with_hessians`."""

    nlp: "NLP"
    d2f_dx2: Callable  # (n,) -> (n, n)
    d2g_dx2: Callable  # ((n,), (m,)) -> (n, n)   sum_i lam_i * H(g_i)(x)


def with_hessians(nlp: NLP) -> HessianNLP:
    """Fill a :class:`HessianNLP` from a plain :class:`NLP` by autodiff.
    ``d2g_dx2`` contracts the multipliers before differentiating (the
    Hessian of ``lam . g``), so no (m, n, n) tensor is formed."""
    return HessianNLP(
        nlp=nlp,
        d2f_dx2=hessian(nlp.f),
        d2g_dx2=hessian(lambda x, lam: lam @ nlp.g(x), argnums=0),
    )


class NLPSolutionStatus(enum.IntEnum):
    Optimal = 0
    PrimalInfeasible = 1
    DualInfeasible = 2
    IterationLimit = 3
    Unknown = 4


class NLPSolution(NamedTuple):
    status: torch.Tensor  # int32 NLPSolutionStatus
    iters: torch.Tensor  # int32
    x: torch.Tensor  # (n,) primal
    zl: torch.Tensor  # (n,) multipliers for xl
    zu: torch.Tensor  # (n,) multipliers for xu
    lam: torch.Tensor  # (m,) constraint multipliers
    objective: torch.Tensor  # scalar
    kkt_res: torch.Tensor  # scalar: final KKT residual
    # int32: total inner-QP ADMM iterations across the solve (a lockstep
    # fleet pays the largest of these)
    qp_iters: torch.Tensor = 0
