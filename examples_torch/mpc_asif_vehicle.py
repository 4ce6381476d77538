#!/usr/bin/env python
"""SE(2) vehicle: MPC tracking + ASIF safety filter with an obstacle, on the
PyTorch port (examples/mpc_asif_vehicle.py; the reference example's
workload).

A kinematic vehicle on X = SE(2) x R^3 (pose + body velocities) tracks a
screw trajectory with MPC while an ASIF filter keeps its distance from an
obstacle at (0, -2.3) at least 0.7, overriding the MPC input when needed.
The MPC's QP (K = 30) is a per-problem solve, on ``backend="cuda"`` one
``admm_problem`` launch; the filter's (K = 50 barrier rows) a tiny one, on
``"lane"`` one ``admm_lane`` launch.
"""

import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from examples_torch._common import device_kw, sync
from smooth_feedback_tpu_torch.controllers import (
    ASIFilterParams, ASIFtoQPParams, MPCParams, MPCWeights, make_asif_step, make_mpc_step,
)
from smooth_feedback_tpu_torch.groups import SE2, Bundle, Rn
from smooth_feedback_tpu_torch.qp import QPSolverParams
from smooth_feedback_tpu_torch.utils import ManifoldBounds

X = Bundle(SE2, Rn(3))  # pose + body velocity (vx, vy, wz)
U = Rn(2)
DT = 0.025


def f(x, u):
    """Vehicle dynamics (the reference's mpc_asif_vehicle.cpp:42-51): SE(2)
    pose with body velocity x[4:7], damped."""
    return torch.stack(
        [x[4], x[5], x[6], -0.2 * x[4] + u[0], torch.zeros_like(x[4]), -0.4 * x[6] + u[1]]
    )


def asif_filter(dev, dtype=torch.float32):
    """The safe set (clearance 0.7 of the obstacle at (0, -2.3)), the backup
    law (slow down and turn away), the input weights and the input bounds,
    in ``dtype`` on ``dev``."""
    kw = dict(dtype=dtype, device=dev)
    obstacle = torch.tensor([0.0, -2.3], **kw)
    return dict(
        h=lambda t, x: torch.linalg.vector_norm(x[:2] - obstacle)[None] - 0.7,
        bu=lambda t, x: torch.stack([0.2 * x[4], torch.full_like(x[4], -0.5)]),
        W_u=torch.tensor([20.0, 1.0], **kw),
        ulim=ManifoldBounds(A=torch.eye(2, **kw), c=torch.zeros(2, **kw),
                            l=torch.tensor([-0.2, -0.5], **kw), u=torch.tensor([0.5, 0.5], **kw)),
    )


def controllers(kw, mpc_backend, asif_backend, K_mpc=30, K_asif=50, T=2.5):
    """The MPC (K_mpc, tf = 5, polish off) tracking the screw (1, 0, 0.4)
    from (2.5, 0) heading +y, and the ASIF (K_asif, T, alpha 1, relax_cost
    100, polish off).  Returns ``dict(mpc, mws, asif, aws, aprm, fl)``."""
    vdes = torch.tensor([1.0, 0.0, 0.4], **kw)
    base = torch.tensor([2.5, 0.0, np.cos(np.pi / 2), np.sin(np.pi / 2)], **kw)
    eye = lambda n: torch.eye(n, **kw)
    mpc, mws = make_mpc_step(
        X, U, f, lambda t: torch.cat([SE2.rplus(base, t * vdes), vdes]),
        lambda t: torch.zeros(2, **kw), dxdes=lambda t: torch.cat([vdes, torch.zeros(3, **kw)]),
        weights=MPCWeights(Q=eye(6), Qtf=0.1 * eye(6), R=eye(2)),
        params=MPCParams(K=K_mpc, tf=5.0, qp=QPSolverParams(polish=False, backend=mpc_backend)),
        cr=lambda x, u: u, crl=[-0.5, -0.5], cru=[0.5, 0.5], **kw,
    )
    fl = asif_filter(kw["device"], kw["dtype"])
    aprm = ASIFilterParams(T=T, asif=ASIFtoQPParams(K=K_asif, dt=0.05, alpha=1.0, relax_cost=100.0),
                           qp=QPSolverParams(polish=False, backend=asif_backend))
    asif, aws = make_asif_step(X, U, f, fl["h"], fl["bu"], params=aprm, W_u=fl["W_u"],
                               ulim=fl["ulim"], **kw)
    return dict(mpc=mpc, mws=mws, asif=asif, aws=aws, aprm=aprm, fl=fl)


def run(steps: int = 800, K_mpc: int = 30, K_asif: int = 50, *, device="cuda",
        dtype=torch.float32, backend="cuda", asif_backend="lane"):
    """The loop from the identity: ``dict(xs, u_mpc, u_asif, hs,
    mpc_statuses, asif_statuses, seconds)`` per step."""
    kw = device_kw(device, dtype)
    c = controllers(kw, backend, asif_backend, K_mpc, K_asif)
    mws, aws, h = c["mws"], c["aws"], c["fl"]["h"]
    x = X.identity(**kw)
    rows = {k: [] for k in ("xs", "u_mpc", "u_asif", "hs", "mpc_statuses", "asif_statuses")}
    t0 = time.perf_counter()
    for i in range(steps):
        t = torch.tensor(i * DT, **kw)
        m = c["mpc"](mws, t, x)
        a = c["asif"](aws, x, m.u)
        x = X.rplus(x, DT * f(x, a.u))
        mws, aws = m.warmstart, a.warmstart
        for k, v in zip(rows, (x, m.u, a.u, h(t, x)[0], m.status, a.status)):
            rows[k].append(v)
    sync(kw)
    return dict({k: torch.stack(v) for k, v in rows.items()}, seconds=time.perf_counter() - t0)


def main(steps: int = 800, K_mpc: int = 30, K_asif: int = 50, *, device="cuda",
         dtype=torch.float32, backend="cuda", asif_backend="lane"):
    out = run(steps, K_mpc, K_asif, device=device, dtype=dtype, backend=backend,
              asif_backend=asif_backend)
    xs, hs = out["xs"].double().cpu(), out["hs"].double().cpu()
    print(f"wall: {out['seconds']:.1f}s for {steps} MPC+ASIF steps")
    print(f"min barrier value: {float(hs.min()):+.3f} (safe iff > 0)")
    diff = (out["u_mpc"] - out["u_asif"]).abs().amax(dim=1).cpu().numpy()
    print(f"ASIF interventions: {np.mean(diff > 1e-3) * 100:.1f}% of steps")
    for i in range(0, steps, max(1, steps // 5)):
        print(f"t={i * DT:5.1f}: pos=({float(xs[i, 0]):+.2f},{float(xs[i, 1]):+.2f}) "
              f"h={float(hs[i]):+.2f}")
    return out


if __name__ == "__main__":
    main()
