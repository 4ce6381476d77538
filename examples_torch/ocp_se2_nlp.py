#!/usr/bin/env python
"""SE(2) optimal control with hp-adaptive mesh refinement, on the PyTorch
port (examples/ocp_se2_nlp.py; the reference example ocp_se2_nlp.cpp's
workload): flatten the Lie-group OCP, transcribe on an LGR mesh, solve with
the SQP, estimate the interval dynamics errors, refine, repeat.  Each SQP
iteration's subproblem is one QP, on ``backend="cuda"`` one
``admm_problem`` launch at B = 1."""

import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from examples_torch._common import F32_TARGET_ERR, device_kw, f32_cut, sqp_params
from smooth_feedback_tpu_torch.groups import SE2, Bundle, Rn
from smooth_feedback_tpu_torch.ocp import (
    OCP,
    SolveOCPParams,
    flatten_ocp,
    solve_ocp_flat,
    unflatten_ocpsol,
)
from smooth_feedback_tpu_torch.ocp.collocation import Mesh

VEL = (1.0, 0.0, 0.5)


def se2_tracking(vel):
    """The reference's examples/ocp_se2.hpp vehicle tracking the screw
    ``vel`` (3,): ``(X, U, f, g)`` with X = SE(2) x R^2 (pose and the speeds
    along the screw), U = R^2 (their rates), f the body velocity and g the
    running cost |x (-) xdes(t)|^2/2 + |u|^2/2 against xdes(t) = (exp(t vel),
    speeds)."""
    X = Bundle(SE2, Rn(2))
    speeds = torch.stack([vel[0], vel[2]])

    def f(t, x, u):
        return torch.stack([x[4], torch.zeros_like(x[4]), x[5], u[0], u[1]])

    def g(t, x, u):
        e = X.rminus(x, torch.cat([SE2.exp(t * vel), speeds]))
        # 1-element: a 0-d float32 tensor times a Python scalar gets a
        # float64 tangent in torch's forward mode
        return 0.5 * torch.stack([e @ e + u @ u])

    return X, Rn(2), f, g


def ocp_example(dtype=torch.float32, device="cuda"):
    """The OCP: X = SE(2) x R^2, U = R^2, vel (1, 0, 0.5), cost tf + the
    integral of |x (-) xdes|^2/2 + |u|^2/2, |u| <= 1, tf = 5 and x0 =
    (identity, (1, 0)) fixed by the end constraints.  Returns ``(ocp, xl,
    ul)``: the OCP and its nominal, the identity and u = 0.01."""
    kw = dict(dtype=dtype, device=device)
    X, U, f, g = se2_tracking(torch.tensor(VEL, **kw))
    bound_u = torch.ones(2, **kw)
    ends = torch.tensor([5.0, 0.0, 0.0, 0.0, 1.0, 0.0], **kw)
    ocp = OCP(
        X=X, U=U,
        theta=lambda tf, x0, xf, q: tf + q[0],
        f=f, g=g,
        cr=lambda t, x, u: u, crl=-bound_u, cru=bound_u,
        ce=lambda tf, x0, xf, q: torch.cat([tf[None], X.log(x0)]),
        cel=ends, ceu=ends,
    )
    x_nom, u_nom = X.identity(**kw), torch.full((2,), 0.01, **kw)
    return ocp, (lambda t: x_nom), (lambda t: u_nom)


def run(target_err: float = 1e-6, max_refine_iter: int = 10, *, device="cuda",
        dtype=torch.float32, backend="cuda"):
    """Flatten, refine, unflatten: ``dict(sol, mesh, info, ts, xs, us,
    seconds)`` with x(t), u(t) at 11 times."""
    kw = device_kw(device, dtype)
    ocp, xl, ul = ocp_example(**kw)
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
        print(f"t={t:4.1f}: pos=({float(x[0]):+.2f},{float(x[1]):+.2f}) "
              f"u=({float(u[0]):+.2f},{float(u[1]):+.2f})")
    return out


if __name__ == "__main__":
    main()
