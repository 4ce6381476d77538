#!/usr/bin/env python
"""SE(3) rigid-body hover: MPC on X = SE(3) x R^6 (pose + body twist), on
the PyTorch port (examples/mpc_se3_rigidbody.py).

A fully-actuated rigid body (gravity pre-compensated wrench input, double-
integrator attitude and position dynamics in the body frame) is driven from
an offset pose and nonzero twist back to hover at a fixed target pose: the
transcription on SE(3), its closed-form dr_expinv and the non-commutative
ad-correction in all six degrees of freedom.  Each step's QP (K = 8) is one
per-problem solve, on ``backend="cuda"`` one ``admm_problem`` launch.
"""

import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from examples_torch._common import device_kw
from smooth_feedback_tpu_torch.controllers import MPCParams, MPCWeights, make_mpc_step
from smooth_feedback_tpu_torch.groups import SE3, Bundle, Rn
from smooth_feedback_tpu_torch.qp import QPSolverParams

X = Bundle(SE3, Rn(6))  # pose + body twist (v, w)
U = Rn(6)  # body wrench (gravity pre-compensated)
DT = 0.05


def f(x, u):
    """d^r x = [twist; u]: kinematics driven by the body twist, unit-inertia
    wrench-to-acceleration (pre-compensated gravity)."""
    return torch.cat([x[7:], u])


def build(*, device="cuda", dtype=torch.float32, backend="cuda"):
    """The controller: ``(step, warmstart, xdes, x0)``."""
    kw = device_kw(device, dtype)
    target = SE3.exp(torch.tensor([1.0, -0.5, 0.8, 0.0, 0.0, 0.6], **kw))
    xd = torch.cat([target, torch.zeros(6, **kw)])
    eye = lambda n: torch.eye(n, **kw)
    step, ws0 = make_mpc_step(
        X, U, f, lambda t: xd, lambda t: torch.zeros(6, **kw),
        dxdes=lambda t: torch.zeros(12, **kw),
        weights=MPCWeights(Q=eye(12), Qtf=5.0 * eye(12), R=0.1 * eye(6)),
        params=MPCParams(K=8, tf=2.0, qp=QPSolverParams(polish=False, backend=backend)),
        cr=lambda x, u: u, crl=-2.0 * torch.ones(6, **kw), cru=2.0 * torch.ones(6, **kw),
        **kw,
    )
    # start away from the hover target, tumbling
    x0 = X.rplus(X.identity(**kw), torch.tensor([0.0] * 6 + [0.3, -0.2, 0.1, 0.1, 0.2, -0.1], **kw))
    return step, ws0, xd, x0


def run(steps: int = 300, *, device="cuda", dtype=torch.float32, backend="cuda"):
    """The closed loop: ``dict(xs, statuses, errs)`` with the state after
    each step, each QP's status and the hover error after each step."""
    step, ws, xd, x = build(device=device, dtype=dtype, backend=backend)
    kw = dict(dtype=dtype, device=x.device)
    xs, statuses, errs = [], [], []
    for i in range(steps):
        res = step(ws, torch.tensor(i * DT, **kw), x)
        x = X.rplus(x, DT * f(x, res.u))
        ws = res.warmstart
        xs.append(x)
        statuses.append(res.status)
        errs.append(torch.linalg.vector_norm(X.rminus(x, xd)))
    return dict(xs=torch.stack(xs), statuses=torch.stack(statuses), errs=torch.stack(errs))


def main(steps: int = 300, *, device="cuda", dtype=torch.float32, backend="cuda"):
    out = run(steps, device=device, dtype=dtype, backend=backend)
    errs = out["errs"].double().cpu().numpy()
    statuses = out["statuses"].cpu().numpy()
    print(f"hover error: initial {errs[0]:.3f} -> final {errs[-1]:.4f} "
          f"({steps} steps, optimal {np.mean(statuses == 0) * 100:.1f}%)")
    for i in range(0, steps, max(1, steps // 6)):
        print(f"t={i * DT:5.2f}: |err|={errs[i]:.4f}")
    assert np.all(statuses == 0)
    if steps >= 300:
        assert errs[-1] < 1e-2, f"did not reach hover: {errs[-1]}"
    else:
        assert errs[-1] < errs[0]
    return out


if __name__ == "__main__":
    main()
