"""numpy -> port converters.

State made elsewhere (for example the JAX package's arrays, passed through
``np.asarray``) enters the port through these, so both packages solve the
same problems from the same warm starts: QPs and their factors and
solutions, MPC weights, bounds, EKF states, NLP solutions and SQP warm
starts.  Each takes a ``device`` (the card
unless told otherwise, like every entry point of the port) and a ``dtype``;
integer fields (status, iters) stay int32.
"""

from __future__ import annotations

import numpy as np
import torch

from .controllers.mpc import MPCWeights
from .estimators.ekf import EKFFleetState, EKFState, SqrtEKFFleetState, SqrtEKFState
from .nlp import NLPSolution
from .qp.solver import QPFactors
from .qp.types import QPSolution, QuadraticProgram
from .utils.bounds import ManifoldBounds


def _t(a, device, dtype):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def qp_from_numpy(qp, device="cuda", dtype=torch.float64) -> QuadraticProgram:
    """``(P, q, A, l, u)`` arrays (any leading batch axes) -> QuadraticProgram."""
    return QuadraticProgram(*(_t(a, device, dtype) for a in qp))


def factors_from_numpy(factors, device="cuda", dtype=torch.float64) -> QPFactors:
    """A QPFactors-like tuple of arrays (c, sx, sy, rho, Ps, As, Mred, Minv,
    fact_ok) -> QPFactors."""
    c, sx, sy, rho, Ps, As, Mred, Minv, fact_ok = factors
    return QPFactors(
        *(_t(a, device, dtype) for a in (c, sx, sy, rho, Ps, As, Mred, Minv)),
        fact_ok=_t(fact_ok, device, torch.bool),
    )


def solution_from_numpy(sol, device="cuda", dtype=torch.float64) -> QPSolution:
    """A QPSolution-like tuple of arrays -> QPSolution (e.g. a warm start)."""
    primal, dual, status, iters, objective, pres, dres = sol
    return QPSolution(
        primal=_t(primal, device, dtype),
        dual=_t(dual, device, dtype),
        status=_t(status, device, torch.int32),
        iters=_t(iters, device, torch.int32),
        objective=_t(objective, device, dtype),
        primal_res=_t(pres, device, dtype),
        dual_res=_t(dres, device, dtype),
    )


def weights_from_numpy(weights, device="cuda", dtype=torch.float64) -> MPCWeights:
    """``(Q, Qtf, R)`` arrays -> MPCWeights."""
    return MPCWeights(*(_t(a, device, dtype) for a in weights))


def bounds_from_numpy(bounds, device="cuda", dtype=torch.float64) -> ManifoldBounds:
    """``(A, c, l, u)`` arrays (a ManifoldBounds-like tuple) -> ManifoldBounds."""
    return ManifoldBounds(*(_t(a, device, dtype) for a in bounds))


def ekf_state_from_numpy(state, device="cuda", dtype=torch.float64) -> EKFState:
    """``(g, P)`` arrays -> EKFState (any leading batch axes)."""
    return EKFState(*(_t(a, device, dtype) for a in state))


def sqrt_ekf_state_from_numpy(state, device="cuda", dtype=torch.float64) -> SqrtEKFState:
    """``(g, S)`` arrays -> SqrtEKFState."""
    return SqrtEKFState(*(_t(a, device, dtype) for a in state))


def ekf_fleet_state_from_numpy(state, device="cuda", dtype=torch.float64) -> EKFFleetState:
    """``(g (B, nparams), Pt (ndof, ndof, B))`` arrays -> EKFFleetState, in
    the JAX package's batch-trailing covariance layout."""
    return EKFFleetState(*(_t(a, device, dtype) for a in state))


def sqrt_ekf_fleet_state_from_numpy(state, device="cuda", dtype=torch.float64) -> SqrtEKFFleetState:
    """``(g (B, nparams), St (ndof, ndof, B))`` arrays -> SqrtEKFFleetState."""
    return SqrtEKFFleetState(*(_t(a, device, dtype) for a in state))


def nlp_solution_from_numpy(sol, device="cuda", dtype=torch.float64) -> NLPSolution:
    """An NLPSolution-like tuple of arrays (status, iters, x, zl, zu, lam,
    objective, kkt_res, qp_iters; any leading batch axes) -> NLPSolution,
    for example a fleet solution to hand ``rescue_nonoptimal``."""
    status, iters, x, zl, zu, lam, objective, kkt_res, qp_iters = sol
    i32 = lambda a: _t(a, device, torch.int32)
    return NLPSolution(
        status=i32(status), iters=i32(iters),
        **{k: _t(a, device, dtype) for k, a in
           (("x", x), ("zl", zl), ("zu", zu), ("lam", lam), ("objective", objective),
            ("kkt_res", kkt_res))},
        qp_iters=i32(qp_iters),
    )


def sqp_warmstart_from_numpy(x0, lam0=None, device="cuda", dtype=torch.float64):
    """An SQP warm start ``(x0, lam0)`` (lam0 may be None) -> tensors, the
    ``x0`` and ``lam0`` arguments of ``solve_nlp_sqp`` and
    ``solve_nlp_sqp_batch``."""
    return _t(x0, device, dtype), None if lam0 is None else _t(lam0, device, dtype)
