#!/usr/bin/env python
"""Double-integrator OCP solved directly as one QP, on the PyTorch port
(examples/ocp_doubleintegrator_qp.py; the reference example
ocp_doubleintegrator_qp.cpp's workload, K = 40): transcribe with
``ocp_to_qp`` about a zero nominal and solve, on ``backend="cuda"`` one
``admm_problem`` launch."""

import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from examples_torch._common import F32_QP_EPS, device_kw, f32_cut, sync
from smooth_feedback_tpu_torch.groups import Rn
from smooth_feedback_tpu_torch.ocp import OCP, ocp_to_qp, qpsol_to_ocpsol
from smooth_feedback_tpu_torch.ocp.collocation import Mesh
from smooth_feedback_tpu_torch.qp import QPSolverParams, solve_qp


def problem(n_ival=10, dtype=torch.float32, device="cuda"):
    """``(ocp, mesh, tf, xl, ul)``: the OCP (cost the integral of |x|^2/2 +
    0.05 |u|^2 plus 0.05 |x(tf)|^2, |u| <= 1, x0 = (1, 0)) on
    Mesh.uniform(n_ival, 4, 4, 4), tf = 5, about a zero nominal."""
    kw = dict(dtype=dtype, device=device)
    bound = torch.ones(1, **kw)
    start = torch.tensor([1.0, 0.0], **kw)
    ocp = OCP(
        X=Rn(2), U=Rn(1),
        theta=lambda tf, x0, xf, q: q[0] + 0.05 * (xf @ xf),
        f=lambda t, x, u: torch.stack([x[1], u[0]]),
        g=lambda t, x, u: torch.stack([0.5 * (x @ x) + 0.05 * (u @ u)]),
        cr=lambda t, x, u: u, crl=-bound, cru=bound,
        ce=lambda tf, x0, xf, q: x0, cel=start, ceu=start,
    )
    zx, zu = torch.zeros(2, **kw), torch.zeros(1, **kw)
    return ocp, Mesh.uniform(n_ival, 4, Kmin=4, Kmax=4), 5.0, (lambda t: zx), (lambda t: zu)


def run(n_ival: int = 10, *, device="cuda", dtype=torch.float32, backend="cuda"):
    """Transcribe, solve (eps 1e-6, in float32 F32_QP_EPS; max_iter 20000,
    polish) and map back: ``dict(qp, sol, ts, xs, transcribe_s, solve_s)``
    with x(t) at 11 times."""
    kw = device_kw(device, dtype)
    ocp, mesh, tf, xl, ul = problem(n_ival, **kw)
    eps = f32_cut("QP eps", 1e-6, F32_QP_EPS, dtype)
    t0 = time.perf_counter()
    qp = ocp_to_qp(ocp, mesh, tf, xl, ul, **kw)
    sync(kw)
    t1 = time.perf_counter()
    sol = solve_qp(qp, QPSolverParams(eps_abs=eps, eps_rel=eps, max_iter=20000, backend=backend))
    sync(kw)
    t2 = time.perf_counter()
    osol = qpsol_to_ocpsol(ocp, mesh, sol, tf, xl, ul)
    ts = torch.linspace(0.0, tf, 11, **kw)
    return dict(qp=qp, sol=sol, ts=ts, xs=torch.stack([osol.x(t) for t in ts]),
                transcribe_s=t1 - t0, solve_s=t2 - t1)


def main(n_ival: int = 10, *, device="cuda", dtype=torch.float32, backend="cuda"):
    out = run(n_ival, device=device, dtype=dtype, backend=backend)
    sol = out["sol"]
    print(f"transcription: {out['transcribe_s'] * 1e6:.0f}us, solve: {out['solve_s'] * 1e6:.0f}us, "
          f"status {int(sol.status)}, iters {int(sol.iters)}")
    for t, x in zip(out["ts"].tolist(), out["xs"]):
        print(f"t={t:4.1f}: p={float(x[0]):+.4f} v={float(x[1]):+.4f}")
    return out


if __name__ == "__main__":
    main()
