#!/usr/bin/env python
"""ASIF safety filtering on the double integrator, on the PyTorch port
(examples/asif_doubleintegrator.py; the reference example's workload):
keep position >= 0 while the desired input pushes toward the unsafe
region.  Each step's filter QP (K = 30 barrier rows) is a tiny
per-problem QP, on ``backend="lane"`` one ``admm_lane`` launch."""

import dataclasses
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from examples_torch._common import device_kw
from smooth_feedback_tpu_torch.controllers import ASIFilterParams, ASIFtoQPParams, make_asif_step
from smooth_feedback_tpu_torch.groups import Rn
from smooth_feedback_tpu_torch.utils import ManifoldBounds

X, U = Rn(2), Rn(1)  # (p, v)
DT = 0.02


def f(x, u):
    return torch.stack([x[1], u[0]])


def build(*, device="cuda", dtype=torch.float32, backend="lane"):
    """The filter: ``(step, warmstart, params, pieces)``, ``pieces`` the
    barrier, backup law and input bounds ``asif_to_qp`` takes."""
    kw = device_kw(device, dtype)
    h = lambda t, x: torch.stack([x[0] + 0.5 * x[1]])  # lookahead barrier
    bu = lambda t, x: torch.ones(1, **kw)  # backup: full brake (accelerate up)
    ulim = ManifoldBounds(A=torch.eye(1, **kw), c=torch.zeros(1, **kw),
                          l=torch.tensor([-1.0], **kw), u=torch.tensor([1.0], **kw))
    base = ASIFilterParams()
    prm = ASIFilterParams(T=3.0, asif=ASIFtoQPParams(K=30, alpha=2.0, dt=0.05),
                          qp=dataclasses.replace(base.qp, backend=backend))
    step, ws0 = make_asif_step(X, U, f, h, bu, params=prm, ulim=ulim, **kw)
    return step, ws0, prm, dict(h=h, bu=bu, ulim=ulim, W_u=torch.ones(1, **kw))


def run(steps: int = 500, *, device="cuda", dtype=torch.float32, backend="lane"):
    """The filtered closed loop from (2, 0) under u_des = -1: ``dict(xs,
    us, statuses)``."""
    step, ws, _, _ = build(device=device, dtype=dtype, backend=backend)
    kw = dict(dtype=dtype, device=ws.primal.device)
    x, u_des = torch.tensor([2.0, 0.0], **kw), torch.tensor([-1.0], **kw)
    xs, us, statuses = [], [], []
    for _ in range(steps):
        res = step(ws, x, u_des)
        x = x + DT * f(x, res.u)
        ws = res.warmstart
        xs.append(x)
        us.append(res.u)
        statuses.append(res.status)
    return dict(xs=torch.stack(xs), us=torch.stack(us), statuses=torch.stack(statuses))


def main(steps: int = 500, *, device="cuda", dtype=torch.float32, backend="lane"):
    out = run(steps, device=device, dtype=dtype, backend=backend)
    xs = out["xs"].double().cpu()
    print(f"min position: {float(xs[:, 0].min()):+.4f} (safe iff >= ~0)")
    print(f"final state: p={float(xs[-1, 0]):+.3f} v={float(xs[-1, 1]):+.3f}")
    assert float(xs[:, 0].min()) > -0.05
    return out


if __name__ == "__main__":
    main()
