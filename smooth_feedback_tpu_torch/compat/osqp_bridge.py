"""Bridge to the official OSQP solver (PyTorch port of
``smooth_feedback_tpu/compat/osqp_bridge.py``).

Activates only when the ``osqp`` package is installed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..qp.types import QPSolution, QPSolutionStatus, QPSolverParams, QuadraticProgram
from ._host import to_numpy


def osqp_available() -> bool:
    try:
        import osqp  # noqa: F401

        return True
    except ImportError:
        return False


def solve_qp_osqp(
    qp: QuadraticProgram,
    prm: QPSolverParams = QPSolverParams(),
    warmstart=None,
):
    """Solve one dense QP with OSQP on the host, mapping the parameters as
    the reference does (adaptive_rho off, the same eps/alpha/rho/sigma).
    The solution's tensors lie on the QP's device in its dtype."""
    import osqp
    import scipy.sparse as sp

    P, q, A, l, u = [to_numpy(a) for a in qp]
    solver = osqp.OSQP()
    solver.setup(
        P=sp.csc_matrix(np.triu(P)),
        q=q,
        A=sp.csc_matrix(A),
        l=l,
        u=u,
        alpha=prm.alpha,
        rho=prm.rho,
        sigma=prm.sigma,
        scaling=10 if prm.scaling else 0,
        eps_abs=prm.eps_abs,
        eps_rel=prm.eps_rel,
        eps_prim_inf=prm.eps_primal_inf,
        eps_dual_inf=prm.eps_dual_inf,
        max_iter=prm.max_iter,
        check_termination=prm.stop_check_iter,
        polish=prm.polish,
        polish_refine_iter=prm.polish_iter,
        delta=prm.delta,
        adaptive_rho=False,
        scaled_termination=False,
        verbose=False,
    )
    if warmstart is not None:
        solver.warm_start(x=to_numpy(warmstart.primal), y=to_numpy(warmstart.dual))
    res = solver.solve()

    status_map = {
        "solved": QPSolutionStatus.Optimal,
        "solved inaccurate": QPSolutionStatus.Optimal,
        "primal infeasible": QPSolutionStatus.PrimalInfeasible,
        "dual infeasible": QPSolutionStatus.DualInfeasible,
        "maximum iterations reached": QPSolutionStatus.MaxIterations,
        "run time limit reached": QPSolutionStatus.MaxTime,
    }
    status = status_map.get(res.info.status, QPSolutionStatus.Unknown)
    kw = dict(dtype=qp.A.dtype, device=qp.A.device)
    as_int = lambda v: torch.tensor(int(v), dtype=torch.int32, device=qp.A.device)
    return QPSolution(
        primal=torch.as_tensor(np.asarray(res.x, np.float64), **kw),
        dual=torch.as_tensor(np.asarray(res.y, np.float64), **kw),
        status=as_int(status),
        iters=as_int(res.info.iter),
        objective=torch.tensor(float(res.info.obj_val), **kw),
        primal_res=torch.tensor(float(res.info.pri_res), **kw),
        dual_res=torch.tensor(float(res.info.dua_res), **kw),
    )
