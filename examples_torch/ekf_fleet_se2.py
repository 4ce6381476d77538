#!/usr/bin/env python
"""SE(2) EKF *fleet* localization in the batch-trailing layout, on the
PyTorch port (examples/ekf_fleet_se2.py).

A fleet of B unicycles is tracked at once: ``ekf_fleet_*`` keeps the
covariance stack as (ndof, ndof, B), and the square-root variant
(``sqrt_ekf_fleet_*``) tracks the same fleet with a Cholesky factor, PSD by
construction.  Dense batched algebra: no ADMM kernel.
"""

import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
from torch.func import vmap

from examples_torch._common import device_kw
from examples_torch.ekf_se2_localization import DT, TWIST, landmark_meas
from smooth_feedback_tpu_torch.estimators import (
    ekf_fleet_predict,
    ekf_fleet_reset,
    ekf_fleet_update,
    sqrt_ekf_fleet_predict,
    sqrt_ekf_fleet_reset,
    sqrt_ekf_fleet_update,
)
from smooth_feedback_tpu_torch.groups import SE2


def draws(steps, B, generator=None, dtype=torch.float32, device="cuda"):
    """``(true0, est_offset, noise)``: the true poses' tangents 0.5 N(0, I3)
    (B, 3), the estimates' offsets 0.4 N(0, I3) (B, 3) and the measurement
    noise 0.03 N(0, I8) (steps, B, 8), from ``generator`` (a CPU
    ``torch.Generator``, seed 0 by default; not the JAX example's
    ``jax.random`` draws).  Both filters see the same noise."""
    generator = generator or torch.Generator().manual_seed(0)
    n = lambda *shape: torch.randn(shape, generator=generator, dtype=torch.float64)
    out = (0.5 * n(B, 3), 0.4 * n(B, 3), 0.03 * n(steps, B, 8))
    return tuple(a.to(dtype=dtype, device=device) for a in out)


def run(steps: int = 200, B: int = 64, *, fleet_draws=None, device="cuda", dtype=torch.float32):
    """Both filters over the fleet: ``dict(errs, errs_sqrt)``, (steps, B)
    pose errors after each step.  ``fleet_draws`` ``(true0, est_offset,
    noise)`` replaces the seeded draws."""
    kw = device_kw(device, dtype)
    meas = landmark_meas(kw)
    twist = torch.tensor(TWIST, **kw)
    dyn = lambda t, g: twist
    Q, R = 0.01 * torch.eye(3, **kw), 0.001 * torch.eye(8, **kw)
    v_true, offset, nm = draws(steps, B, **kw) if fleet_draws is None else (
        torch.as_tensor(a, **kw) for a in fleet_draws)
    true0 = vmap(SE2.exp)(v_true)
    est0 = vmap(SE2.rplus)(true0, offset)

    def loop(reset, predict, update):
        fl, tp, errs = reset(SE2, est0), true0, []
        for i in range(steps):
            tp = vmap(lambda g: SE2.rplus(g, DT * twist))(tp)
            fl = predict(SE2, dyn, fl, Q, DT, n_steps=1)
            fl = update(SE2, meas, fl, vmap(meas)(tp) + nm[i], R)
            errs.append(torch.linalg.vector_norm(vmap(SE2.rminus)(fl.g, tp), dim=-1))
        return torch.stack(errs)

    return dict(errs=loop(ekf_fleet_reset, ekf_fleet_predict, ekf_fleet_update),
                errs_sqrt=loop(sqrt_ekf_fleet_reset, sqrt_ekf_fleet_predict,
                               sqrt_ekf_fleet_update))


def main(steps: int = 200, B: int = 64, *, device="cuda", dtype=torch.float32):
    out = run(steps, B, device=device, dtype=dtype)
    errs, errs_sq = out["errs"].double().cpu(), out["errs_sqrt"].double().cpu()
    print(f"fleet of {B}: mean pose error {float(errs[0].mean()):.3f} -> "
          f"{float(errs[-1].mean()):.4f} (worst {float(errs[-1].max()):.4f})")
    print(f"sqrt fleet:     mean pose error {float(errs_sq[0].mean()):.3f} -> "
          f"{float(errs_sq[-1].mean()):.4f}")
    if steps >= 200:
        assert float(errs[-1].mean()) < 0.05 and float(errs_sq[-1].mean()) < 0.05
    else:
        assert float(errs[-1].mean()) < float(errs[0].mean())
    return out


if __name__ == "__main__":
    main()
