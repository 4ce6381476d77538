#!/usr/bin/env python
"""Closed-loop double-integrator MPC tracking a sinusoid, on the PyTorch
port (examples/mpc_doubleintegrator.py; the reference example's K = 20,
tf = 5, 50 ms steps, Q = I, Qtf = 0.1 I, R = 0.1, |u| <= 0.5).

The problem is LTI: the template is factorized once and the states are
eliminated against it (``condense=True``), so each step is a vectors-only
transcription and one solve against shared factors, on ``backend="cuda"``
one ``admm_shared`` launch at B = 1.  The plant is integrated with RK4.
"""

import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from examples_torch._common import device_kw, sync
from smooth_feedback_tpu_torch.controllers import MPCParams, MPCWeights, make_mpc_step
from smooth_feedback_tpu_torch.groups import Rn
from smooth_feedback_tpu_torch.qp import QPSolverParams

DT = 0.05


def f(x, u):
    return torch.stack([x[1], u[0]])


def build(*, device="cuda", dtype=torch.float32, backend="cuda"):
    """The controller: ``(step, warmstart)``."""
    kw = device_kw(device, dtype)
    xdes = lambda t: torch.stack([-0.5 * torch.sin(0.3 * t), -0.15 * torch.cos(0.3 * t)])
    eye = lambda n: torch.eye(n, **kw)
    return make_mpc_step(
        Rn(2), Rn(1), f, xdes, lambda t: torch.zeros(1, **kw),
        weights=MPCWeights(Q=eye(2), Qtf=0.1 * eye(2), R=0.1 * eye(1)),
        params=MPCParams(K=20, tf=5.0, qp=QPSolverParams(polish=False, max_iter=300,
                                                          backend=backend)),
        cr=lambda x, u: u, crl=[-0.5], cru=[0.5],
        reuse_factors=True,  # LTI problem: factorize once
        condense=True,  # and eliminate the states against the template
        **kw,
    )


def rk4(x, u):
    k1 = f(x, u)
    k2 = f(x + 0.5 * DT * k1, u)
    k3 = f(x + 0.5 * DT * k2, u)
    k4 = f(x + DT * k3, u)
    return x + DT / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def run(steps: int = 1200, *, device="cuda", dtype=torch.float32, backend="cuda"):
    """The closed loop from x0 = (1, 0): ``dict(xs, us, statuses,
    seconds)``, the state after each step, the applied inputs and the
    statuses."""
    step, ws = build(device=device, dtype=dtype, backend=backend)
    kw = dict(dtype=dtype, device=ws.primal.device)
    x = torch.tensor([1.0, 0.0], **kw)
    xs, us, statuses = [], [], []
    t0 = time.perf_counter()
    for i in range(steps):
        res = step(ws, torch.tensor(i * DT, **kw), x)
        x = rk4(x, res.u)
        ws = res.warmstart
        xs.append(x)
        us.append(res.u)
        statuses.append(res.status)
    sync(dict(device=ws.primal.device))
    return dict(xs=torch.stack(xs), us=torch.stack(us), statuses=torch.stack(statuses),
                seconds=time.perf_counter() - t0)


def main(steps: int = 1200, *, device="cuda", dtype=torch.float32, backend="cuda"):
    out = run(steps, device=device, dtype=dtype, backend=backend)
    xs, us = out["xs"].double().cpu().numpy(), out["us"].double().cpu().numpy()
    statuses, wall = out["statuses"].cpu().numpy(), out["seconds"]
    ts = (np.arange(steps) + 1) * DT
    err = np.abs(xs[:, 0] + 0.5 * np.sin(0.3 * ts))
    transient = min(200, steps // 2)
    print(f"MPC loop time: {wall * 1e6:.0f}us for {steps} steps ({wall / steps * 1e6:.0f}us/step)")
    print(f"optimal: {np.mean(statuses == 0) * 100:.1f}%")
    print(f"tracking err (after transient): max {err[transient:].max():.4f}")
    for i in range(0, steps, max(1, steps // 6)):
        print(f"t={ts[i]:5.1f}: x={xs[i, 0]:+.3f} v={xs[i, 1]:+.3f} u={us[i, 0]:+.3f}")
    assert np.mean(statuses == 0) > 0.95
    return out


if __name__ == "__main__":
    main()
