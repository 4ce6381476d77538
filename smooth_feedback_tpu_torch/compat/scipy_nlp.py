"""Host-side NLP oracle via scipy (PyTorch port of
``smooth_feedback_tpu/compat/scipy_nlp.py``): scipy's trust-constr on the
host, the NLP's derivatives from ``torch.func`` on its own device."""

from __future__ import annotations

import numpy as np
import torch

from ..nlp import NLP, NLPSolution, NLPSolutionStatus
from ._host import HostNLP, to_numpy


def solve_nlp_scipy(nlp: NLP, x0, maxiter: int = 500, tol: float = 1e-9) -> NLPSolution:
    """Solve with scipy trust-constr using ``torch.func`` derivatives.  The
    solution's tensors lie on the NLP's device in its dtype."""
    from scipy.optimize import Bounds, NonlinearConstraint, minimize

    h = HostNLP(nlp)
    res = minimize(
        h.f,
        to_numpy(x0),
        jac=h.grad,
        method="trust-constr",
        bounds=Bounds(to_numpy(nlp.xl), to_numpy(nlp.xu)),
        constraints=[NonlinearConstraint(h.g, to_numpy(nlp.gl), to_numpy(nlp.gu), jac=h.jac)],
        options={"maxiter": maxiter, "gtol": tol, "xtol": 1e-12},
    )

    lam = np.zeros(nlp.m)
    if res.v:  # list of multiplier arrays per constraint block
        lam = -np.asarray(res.v[0])
    status = (
        NLPSolutionStatus.Optimal
        if res.status in (1, 2)
        else NLPSolutionStatus.IterationLimit
    )
    kw, dev = h.kw, h.kw["device"]
    return NLPSolution(
        status=torch.tensor(int(status), dtype=torch.int32, device=dev),
        iters=torch.tensor(res.nit, dtype=torch.int32, device=dev),
        x=h.tensor(res.x),
        zl=torch.zeros(nlp.n, **kw),
        zu=torch.zeros(nlp.n, **kw),
        lam=h.tensor(lam),
        objective=torch.tensor(float(res.fun), **kw),
        kkt_res=torch.tensor(float(res.optimality), **kw),
        qp_iters=torch.tensor(0, dtype=torch.int32, device=dev),
    )
