"""Bridge to Ipopt via cyipopt (PyTorch port of
``smooth_feedback_tpu/compat/ipopt_bridge.py``).

Activates only when ``cyipopt`` is installed.  Ipopt runs on the host; the
derivatives come from ``torch.func`` on the NLP's own device.
"""

from __future__ import annotations

import numpy as np

from ..nlp import NLP, HessianNLP, NLPSolution, NLPSolutionStatus
from ._host import HostNLP, to_numpy


def ipopt_available() -> bool:
    try:
        import cyipopt  # noqa: F401

        return True
    except ImportError:
        return False


def solve_nlp_ipopt(
    nlp: NLP | HessianNLP,
    x0,
    options: dict | None = None,
    warmstart: NLPSolution | None = None,
) -> NLPSolution:
    """Solve an NLP with Ipopt and ``torch.func`` derivatives.

    A plain :class:`NLP` uses first derivatives and Ipopt's L-BFGS Hessian
    (the reference example's configuration).  A :class:`HessianNLP` (see
    :func:`smooth_feedback_tpu_torch.nlp.with_hessians`) also registers the
    exact Lagrangian Hessian ``obj_factor * d2f_dx2(x) + d2g_dx2(x, lam)``,
    dense lower triangle.

    ``warmstart`` re-enters Ipopt with the full primal-dual point: primal
    from ``warmstart.x`` (overrides ``x0``), bound multipliers ``zl``/``zu``
    and constraint multipliers ``lam`` (sign-flipped to Ipopt's ``mult_g``
    convention), with ``warm_start_init_point`` set.  The iteration count
    comes from Ipopt's intermediate callback (cyipopt's result carries
    none).  The solution is numpy, as Ipopt returns it.
    """
    import cyipopt

    hess_nlp = nlp if isinstance(nlp, HessianNLP) else None
    if hess_nlp is not None:
        nlp = hess_nlp.nlp
    h = HostNLP(nlp)
    iter_count = [0]

    class _Problem:
        def objective(self, x):
            return h.f(x)

        def gradient(self, x):
            return h.grad(x)

        def constraints(self, x):
            return h.g(x)

        def jacobian(self, x):
            return h.jac(x).ravel()

        def intermediate(self, alg_mod, it, *args, **kwargs):
            iter_count[0] = int(it)
            return True

    if hess_nlp is not None:
        tril = np.tril_indices(nlp.n)

        class _HessianProblem(_Problem):
            def hessianstructure(self):
                return tril

            def hessian(self, x, lam, obj_factor):
                x = h.tensor(x)
                H = obj_factor * hess_nlp.d2f_dx2(x) + hess_nlp.d2g_dx2(x, h.tensor(lam))
                return to_numpy(H)[tril]

        problem_obj = _HessianProblem()
    else:
        problem_obj = _Problem()

    clip = lambda a: np.clip(to_numpy(a), -2e19, 2e19)
    problem = cyipopt.Problem(
        n=nlp.n,
        m=nlp.m,
        problem_obj=problem_obj,
        lb=clip(nlp.xl),
        ub=clip(nlp.xu),
        cl=clip(nlp.gl),
        cu=clip(nlp.gu),
    )
    if hess_nlp is None:
        problem.add_option("hessian_approximation", "limited-memory")
    if warmstart is not None:
        problem.add_option("warm_start_init_point", "yes")
    for k, v in (options or {}).items():
        problem.add_option(k, v)

    if warmstart is not None:
        # full primal-dual restart: lam -> mult_g with the sign flip this
        # bridge inverts on the way back out
        x, info = problem.solve(
            to_numpy(warmstart.x),
            lagrange=(-to_numpy(warmstart.lam)).tolist(),
            zl=to_numpy(warmstart.zl).tolist(),
            zu=to_numpy(warmstart.zu).tolist(),
        )
    else:
        x, info = problem.solve(to_numpy(x0))

    # the reference's status mapping
    status = {
        0: NLPSolutionStatus.Optimal,  # Solve_Succeeded
        1: NLPSolutionStatus.Optimal,  # Solved_To_Acceptable_Level
        2: NLPSolutionStatus.PrimalInfeasible,  # Infeasible_Problem_Detected
        4: NLPSolutionStatus.DualInfeasible,  # Diverging_Iterates
        -1: NLPSolutionStatus.IterationLimit,  # Maximum_Iterations_Exceeded
        -4: NLPSolutionStatus.IterationLimit,  # Maximum_CpuTime_Exceeded
    }.get(info["status"], NLPSolutionStatus.Unknown)
    return NLPSolution(
        status=np.int32(int(status)),
        iters=np.int32(iter_count[0]),
        x=np.asarray(x),
        zl=np.asarray(info["mult_x_L"]),
        zu=np.asarray(info["mult_x_U"]),
        lam=-np.asarray(info["mult_g"]),
        objective=np.float64(info["obj_val"]),
        kkt_res=np.float64(0.0),
        qp_iters=np.int32(0),
    )
