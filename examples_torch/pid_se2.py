#!/usr/bin/env python
"""SE(2) PID control of the Lie-group double integrator, on the PyTorch
port (examples/pid_se2.py; the reference example's workload): track a
time-varying pose trajectory."""

import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from examples_torch._common import device_kw
from smooth_feedback_tpu_torch.controllers import PIDParams, pid_gains, pid_init, pid_step
from smooth_feedback_tpu_torch.groups import SE2

PID_STEPS = 2000
PID_DT = 0.01


def run(steps: int = PID_STEPS, *, device="cuda", dtype=torch.float32):
    """The loop from exp(1, -0.5, 0.8) at rest: ``dict(errs)``, the tracking
    error after each step."""
    kw = device_kw(device, dtype)
    twist = torch.tensor([0.4, 0.0, 0.3], **kw)
    gains, prm = pid_gains(SE2, kp=2.0, kd=2.5, ki=0.2, **kw), PIDParams(windup_limit=1.0)
    x, v, st = SE2.exp(torch.tensor([1.0, -0.5, 0.8], **kw)), torch.zeros(3, **kw), pid_init(SE2, **kw)
    zeros, errs = torch.zeros(3, **kw), []
    for i in range(steps):
        t = torch.tensor(i * PID_DT, **kw)
        u, st = pid_step(SE2, prm, gains, st, t, x, v, SE2.exp(t * twist), twist, zeros)
        v = v + PID_DT * u
        x = SE2.rplus(x, PID_DT * v)
        errs.append(torch.linalg.vector_norm(SE2.rminus(x, SE2.exp((t + PID_DT) * twist))))
    return dict(errs=torch.stack(errs))


def main(steps: int = PID_STEPS, *, device="cuda", dtype=torch.float32):
    out = run(steps, device=device, dtype=dtype)
    errs = out["errs"].double().cpu()
    print(f"initial error {float(errs[0]):.3f} -> final error {float(errs[-1]):.5f}")
    assert float(errs[-1]) < (0.05 if steps >= 2000 else float(errs[0]))
    return out


if __name__ == "__main__":
    main()
