#!/usr/bin/env python
"""SE(2) OCP solved as one QP via Lie-group linearization, on the PyTorch
port (examples/ocp_se2_qp.py; the reference example ocp_se2_qp.cpp's
workload): the transcription linearizes about the desired screw with the
non-commutative ad-correction, and the QP is one per-problem solve, on
``backend="cuda"`` one ``admm_problem`` launch."""

import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from examples_torch._common import F32_QP_EPS, device_kw, f32_cut, sync
from examples_torch.ocp_se2_nlp import VEL, se2_tracking
from smooth_feedback_tpu_torch.groups import SE2
from smooth_feedback_tpu_torch.ocp import OCP, ocp_to_qp, qpsol_to_ocpsol
from smooth_feedback_tpu_torch.ocp.collocation import Mesh
from smooth_feedback_tpu_torch.qp import QPSolverParams, solve_qp


def ocp_qp_problem(dtype=torch.float32, device="cuda", n_ival=10):
    """The SE(2) x R^2 OCP with cost the integral alone and x0 = (identity,
    (1, 0)), linearized about the desired screw on Mesh.uniform(n_ival, 5,
    5, 5), tf = 5.  Returns ``(ocp, mesh, tf, xl, ul, dxl)``."""
    kw = dict(dtype=dtype, device=device)
    vel = torch.tensor(VEL, **kw)
    X, U, f, g = se2_tracking(vel)
    bound_u = torch.ones(2, **kw)
    ends = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0], **kw)
    speeds = torch.stack([vel[0], vel[2]])
    xdes = lambda t: torch.cat([SE2.exp(t * vel), speeds])
    ocp = OCP(
        X=X, U=U,
        theta=lambda tf, x0, xf, q: q[0],
        f=f, g=g,
        cr=lambda t, x, u: u, crl=-bound_u, cru=bound_u,
        ce=lambda tf, x0, xf, q: X.log(x0),
        cel=ends, ceu=ends,
    )
    dxl = torch.cat([vel, torch.zeros(2, **kw)])
    return (ocp, Mesh.uniform(n_ival, 5, Kmin=5, Kmax=5), 5.0, xdes,
            lambda t: torch.zeros(2, **kw), lambda t: dxl)


def run(n_ival: int = 10, *, device="cuda", dtype=torch.float32, backend="cuda"):
    """Transcribe, solve (eps 1e-6, in float32 F32_QP_EPS; max_iter 20000,
    polish) and map back: ``dict(qp, sol, ts, xs, dev, transcribe_s,
    solve_s)`` with x(t) at 6 times and the deviation norm |primal|."""
    kw = device_kw(device, dtype)
    ocp, mesh, tf, xl, ul, dxl = ocp_qp_problem(n_ival=n_ival, **kw)
    eps = f32_cut("QP eps", 1e-6, F32_QP_EPS, dtype)
    t0 = time.perf_counter()
    qp = ocp_to_qp(ocp, mesh, tf, xl, ul, dxl, **kw)
    sync(kw)
    t1 = time.perf_counter()
    sol = solve_qp(qp, QPSolverParams(eps_abs=eps, eps_rel=eps, max_iter=20000, backend=backend))
    sync(kw)
    t2 = time.perf_counter()
    osol = qpsol_to_ocpsol(ocp, mesh, sol, tf, xl, ul)
    ts = torch.linspace(0.0, tf, 6, **kw)
    return dict(qp=qp, sol=sol, ts=ts, xs=torch.stack([osol.x(t) for t in ts]),
                dev=torch.linalg.vector_norm(sol.primal), transcribe_s=t1 - t0, solve_s=t2 - t1)


def main(n_ival: int = 10, *, device="cuda", dtype=torch.float32, backend="cuda"):
    out = run(n_ival, device=device, dtype=dtype, backend=backend)
    sol = out["sol"]
    print(f"transcription: {out['transcribe_s'] * 1e6:.0f}us, solve: {out['solve_s'] * 1e6:.0f}us, "
          f"status {int(sol.status)}, iters {int(sol.iters)}")
    # the nominal already satisfies dynamics and initial conditions; the QP
    # deviation should be small
    print(f"deviation norm from nominal: {float(out['dev']):.4f}")
    for t, x in zip(out["ts"].tolist(), out["xs"]):
        print(f"t={t:4.1f}: pos=({float(x[0]):+.3f},{float(x[1]):+.3f}) "
              f"v=({float(x[4]):+.3f},{float(x[5]):+.3f})")
    return out


if __name__ == "__main__":
    main()
