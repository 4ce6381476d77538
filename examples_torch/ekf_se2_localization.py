#!/usr/bin/env python
"""SE(2) EKF localization on the PyTorch port
(examples/ekf_se2_localization.py): predict through unicycle dynamics,
update from body-frame landmark positions."""

import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from examples_torch._common import device_kw
from smooth_feedback_tpu_torch.estimators import ekf_predict, ekf_reset, ekf_update
from smooth_feedback_tpu_torch.groups import SE2

DT = 0.1
LANDMARKS = ((3.0, 1.0), (-2.0, 4.0), (1.0, -3.0), (4.0, -1.0))
TWIST = (1.0, 0.0, 0.4)


def landmark_meas(kw):
    """The landmarks' positions in the body frame of a pose, (8,)."""
    landmarks = torch.tensor(LANDMARKS, **kw)

    def meas(g):
        inv = SE2.inverse(g)
        Rt = torch.stack([torch.stack([inv[2], -inv[3]]), torch.stack([inv[3], inv[2]])])
        return (landmarks @ Rt.T + inv[:2]).reshape(-1)

    return meas


def noise(steps, generator=None, dtype=torch.float32, device="cuda"):
    """0.03 N(0, I8) measurement noise for ``steps`` steps from
    ``generator`` (a CPU ``torch.Generator``, seed 0 by default; not the JAX
    example's ``jax.random`` draws)."""
    generator = generator or torch.Generator().manual_seed(0)
    return (0.03 * torch.randn((steps, 8), generator=generator, dtype=torch.float64)).to(
        dtype=dtype, device=device)


def run(steps: int = 200, *, noise_draws=None, device="cuda", dtype=torch.float32):
    """The filter from a pose (0.5, -0.5, 0.3) off the truth with P = I:
    ``dict(errs, trace_P, g, true)``, the pose error after each step.
    ``noise_draws`` (steps, 8) replaces the seeded draws."""
    kw = device_kw(device, dtype)
    meas = landmark_meas(kw)
    twist = torch.tensor(TWIST, **kw)
    dyn = lambda t, g: twist
    Q, R = 0.01 * torch.eye(3, **kw), 0.001 * torch.eye(8, **kw)
    nm = noise(steps, **kw) if noise_draws is None else torch.as_tensor(noise_draws, **kw)
    tp = SE2.identity(**kw)
    st = ekf_reset(SE2, SE2.exp(torch.tensor([0.5, -0.5, 0.3], **kw)), torch.eye(3, **kw))
    errs = []
    for i in range(steps):
        tp = SE2.rplus(tp, DT * twist)
        st = ekf_predict(SE2, dyn, st, Q, DT, n_steps=1)
        st = ekf_update(SE2, meas, st, meas(tp) + nm[i], R)
        errs.append(torch.linalg.vector_norm(SE2.rminus(st.g, tp)))
    return dict(errs=torch.stack(errs), trace_P=torch.trace(st.P), g=st.g, true=tp)


def main(steps: int = 200, *, device="cuda", dtype=torch.float32):
    out = run(steps, device=device, dtype=dtype)
    errs = out["errs"].double().cpu()
    print(f"pose error: initial {float(errs[0]):.3f} -> final {float(errs[-1]):.4f}")
    print(f"final covariance trace: {float(out['trace_P']):.5f}")
    assert float(errs[-1]) < (0.1 if steps >= 200 else float(errs[0]))
    return out


if __name__ == "__main__":
    main()
