#!/usr/bin/env python
"""Double-integrator OCP as a nonlinear program with hp-adaptive refinement,
on the PyTorch port (examples/ocp_doubleintegrator_nlp.py; the reference
example ocp_doubleintegrator_nlp.cpp's workload): minimise the integral of
|x|^2 + |u|^2 under velocity and input bounds with fixed endpoints, solve
through flatten -> LGR collocation -> SQP, refine the mesh on the
dynamics-error estimate.  Like the reference it first runs the OCP
derivative self-check.  Each SQP subproblem is one QP, on
``backend="cuda"`` one ``admm_problem`` launch at B = 1."""

import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from examples_torch._common import F32_TARGET_ERR, device_kw, f32_cut, sqp_params
from smooth_feedback_tpu_torch.groups import Rn
from smooth_feedback_tpu_torch.ocp import (
    OCP,
    SolveOCPParams,
    flatten_ocp,
    solve_ocp_flat,
    test_ocp_derivatives,
    unflatten_ocpsol,
)
from smooth_feedback_tpu_torch.ocp.collocation import Mesh


def make_ocp(dtype=torch.float32, device="cuda"):
    """min integral(|x|^2 + |u|^2), dynamics [pos' = vel, vel' = u], vel in
    [-0.5, 1.5], u in [-1, 1], tf = 5 fixed, x0 = (1, 1) and xf = (0.1, 0)
    fixed by the end constraints."""
    kw = dict(dtype=dtype, device=device)
    ends = torch.tensor([5.0, 1.0, 1.0, 0.1, 0.0], **kw)
    return OCP(
        X=Rn(2), U=Rn(1),
        theta=lambda tf, x0, xf, q: q[0],
        f=lambda t, x, u: torch.stack([x[1], u[0]]),
        g=lambda t, x, u: torch.stack([x @ x + u @ u]),
        cr=lambda t, x, u: torch.stack([x[1], u[0]]),
        crl=torch.tensor([-0.5, -1.0], **kw), cru=torch.tensor([1.5, 1.0], **kw),
        ce=lambda tf, x0, xf, q: torch.cat([tf[None], x0, xf]),
        cel=ends, ceu=ends,
    )


def run(target_err: float = 1e-6, max_refine_iter: int = 10, *, device="cuda",
        dtype=torch.float32, backend="cuda"):
    """The self-check, then flatten, refine, unflatten: ``dict(sol, mesh,
    info, ts, xs, us, seconds)`` with x(t), u(t) at 11 times."""
    kw = device_kw(device, dtype)
    # the reference example's first statement: autodiff against finite
    # differences of the user's callables, in float64 on the host
    test_ocp_derivatives(make_ocp(torch.float64, "cpu"), torch.Generator().manual_seed(0), num=2)
    ocp = make_ocp(**kw)
    zx, zu = torch.zeros(2, **kw), torch.zeros(1, **kw)
    xl, ul = (lambda t: zx), (lambda t: zu)
    prm = SolveOCPParams(target_err=f32_cut("target_err", target_err, F32_TARGET_ERR, dtype),
                         max_refine_iter=max_refine_iter, tf_guess=5.0,
                         sqp=sqp_params(200, 1e-8, dtype, backend), verbose=True)
    t0 = time.perf_counter()
    flatsol, mesh, info = solve_ocp_flat(flatten_ocp(ocp, xl, ul), Mesh(), prm, **kw)
    seconds = time.perf_counter() - t0
    sol = unflatten_ocpsol(flatsol, ocp, xl, ul)
    ts = torch.linspace(0.0, float(sol.tf), 11, **kw)
    return dict(sol=sol, mesh=mesh, info=info, ts=ts, xs=torch.stack([sol.x(t) for t in ts]),
                us=torch.stack([sol.u(t) for t in ts]), seconds=seconds)


def main(target_err: float = 1e-6, max_refine_iter: int = 10, *, device="cuda",
         dtype=torch.float32, backend="cuda"):
    out = run(target_err, max_refine_iter, device=device, dtype=dtype, backend=backend)
    info, mesh = out["info"], out["mesh"]
    print(f"TOTAL TIME: {out['seconds']:.1f}s")
    print(f"status: {info.status.name}, final mesh: {mesh.N_ivals} intervals / "
          f"{mesh.N_colloc} points, dyn errors per iteration: "
          + " ".join(f"{e:.1e}" for e in info.errors))
    for t, x, u in zip(out["ts"].tolist(), out["xs"], out["us"]):
        print(f"t={t:4.1f}: pos={float(x[0]):+.3f} vel={float(x[1]):+.3f} u={float(u[0]):+.3f}")
    return out


if __name__ == "__main__":
    main()
