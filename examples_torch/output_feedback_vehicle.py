#!/usr/bin/env python
"""Output-feedback safe control: EKF -> MPC -> ASIF, on the PyTorch port
(examples/output_feedback_vehicle.py).

The SE(2) x R^3 vehicle of mpc_asif_vehicle.py is driven from NOISY
landmark + velocity measurements.  Each step runs

    EKF update (landmarks)  ->  MPC on the ESTIMATE  ->  ASIF safety filter
    ->  plant step with process noise  ->  EKF predict with the applied u

and safety (barrier h >= 0) is asserted on the TRUE state.  Both QPs take
``backend``: on ``"cuda"`` each is one ``admm_problem`` launch at B = 1.
"""

import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from examples_torch._common import device_kw, sync
from examples_torch.mpc_asif_vehicle import X, U, controllers, f
from smooth_feedback_tpu_torch.estimators import ekf_predict, ekf_reset, ekf_update
from smooth_feedback_tpu_torch.groups import SE2

DT = 0.025
LANDMARKS = ((3.0, 1.0), (-2.0, 4.0), (1.0, -3.0), (4.0, -1.0))


def output_feedback_path(dev, dtype=torch.float32, backend="cuda", K_mpc=30, K_asif=50, T=2.5):
    """The loop's parts: the vehicle, its landmark + velocity measurement,
    the sparse MPC (K_mpc, tf = 5) and the ASIF (K_asif, T, alpha 1,
    relax_cost 100), both QPs polish off on ``backend``, and the filter's Q
    and R."""
    kw = dict(dtype=dtype, device=dev)
    landmarks = torch.tensor(LANDMARKS, **kw)

    def meas(x):
        """Body-frame landmark positions and the measured body velocity."""
        inv = SE2.inverse(x[:4])
        Rt = torch.stack([torch.stack([inv[2], -inv[3]]), torch.stack([inv[3], inv[2]])])
        return torch.cat([(landmarks @ Rt.T + inv[:2]).reshape(-1), x[4:]])

    c = controllers(kw, backend, backend, K_mpc, K_asif, T)
    Q = torch.diag(torch.tensor([1e-4, 1e-4, 1e-4, 1e-3, 1e-6, 1e-3], **kw))
    return dict(X=X, U=U, f=f, meas=meas, h=c["fl"]["h"], fl=c["fl"], mpc=c["mpc"], mws=c["mws"],
                asif=c["asif"], aws=c["aws"], aprm=c["aprm"], Q=Q, R=1e-3 * torch.eye(11, **kw),
                kw=kw)


def output_feedback_start(p):
    """The true state (identity) and the estimate reset at (0.3, -0.3, 0.2)
    off it with P = 0.5 I."""
    X, kw = p["X"], p["kw"]
    x0 = X.identity(**kw)
    est0 = ekf_reset(X, X.rplus(x0, torch.tensor([0.3, -0.3, 0.2, 0.0, 0.0, 0.0], **kw)),
                     0.5 * torch.eye(6, **kw))
    return x0, est0


def noise(steps, generator=None, dtype=torch.float32, device="cuda"):
    """``(nm, nw)``: 0.03 N(0, I11) measurement noise and 0.02 N(0, I6)
    process noise on the velocity states for ``steps`` steps, from
    ``generator`` (a CPU ``torch.Generator``, seed 0 by default; not the JAX
    example's ``jax.random`` draws)."""
    generator = generator or torch.Generator().manual_seed(0)
    nm = 0.03 * torch.randn((steps, 11), generator=generator, dtype=torch.float64)
    nw = 0.02 * torch.randn((steps, 6), generator=generator, dtype=torch.float64)
    nw[:, :3] = 0.0
    return nm.to(dtype=dtype, device=device), nw.to(dtype=dtype, device=device)


def output_feedback_step(p, i, x, est, mws, aws, nm, nw):
    """Step ``i`` of the loop: measure the TRUE state, EKF update, MPC on
    the estimate, ASIF on its input, the plant with process noise, EKF
    predict through the applied input.  Returns ``(x, est, est_upd, m,
    a)``, ``est_upd`` the estimate both controllers saw."""
    X, kw = p["X"], p["kw"]
    t = torch.tensor(DT * i, **kw)
    est_upd = ekf_update(X, p["meas"], est, p["meas"](x) + nm, p["R"])
    m = p["mpc"](mws, t, est_upd.g)
    a = p["asif"](aws, est_upd.g, m.u)
    x = X.rplus(x, DT * f(x, a.u) + np.sqrt(DT) * nw)
    est = ekf_predict(X, lambda t_, g: f(g, a.u), est_upd, p["Q"], DT)
    return x, est, est_upd, m, a


def run(steps: int = 800, K_mpc: int = 30, K_asif: int = 50, *, noise_draws=None,
        device="cuda", dtype=torch.float32, backend="cuda"):
    """The loop: ``dict(xs, us, hs, errs, mpc_statuses, asif_statuses,
    err0, seconds)`` per step (state, filtered input, barrier on the true
    state, estimation error).  ``noise_draws`` ``(nm, nw)`` replaces the
    seeded draws."""
    kw = device_kw(device, dtype)
    p = output_feedback_path(kw["device"], dtype, backend, K_mpc, K_asif)
    nm, nw = noise(steps, **kw) if noise_draws is None else (
        torch.as_tensor(a, **kw) for a in noise_draws)
    x, est = output_feedback_start(p)
    err0 = torch.linalg.vector_norm(X.rminus(est.g, x))
    mws, aws = p["mws"], p["aws"]
    rows = {k: [] for k in ("xs", "us", "hs", "errs", "mpc_statuses", "asif_statuses")}
    t0 = time.perf_counter()
    for i in range(steps):
        x, est, _, m, a = output_feedback_step(p, i, x, est, mws, aws, nm[i], nw[i])
        mws, aws = m.warmstart, a.warmstart
        vals = (x, a.u, p["h"](torch.tensor(DT * i, **kw), x)[0],
                torch.linalg.vector_norm(X.rminus(est.g, x)), m.status, a.status)
        for k, v in zip(rows, vals):
            rows[k].append(v)
    sync(kw)
    return dict({k: torch.stack(v) for k, v in rows.items()}, err0=err0,
                seconds=time.perf_counter() - t0)


def main(steps: int = 800, K_mpc: int = 30, K_asif: int = 50, *, device="cuda",
         dtype=torch.float32, backend="cuda"):
    out = run(steps, K_mpc, K_asif, device=device, dtype=dtype, backend=backend)
    xs, hs, errs = (out[k].double().cpu() for k in ("xs", "hs", "errs"))
    print(f"wall: {out['seconds']:.1f}s for {steps} EKF+MPC+ASIF steps")
    print(f"min barrier value on TRUE state: {float(hs.min()):+.3f} (safe iff > 0)")
    print(f"estimation error: initial {float(errs[0]):.3f} -> final {float(errs[-1]):.4f}")
    for i in range(0, steps, max(1, steps // 5)):
        print(f"t={i * DT:5.1f}: pos=({float(xs[i, 0]):+.2f},{float(xs[i, 1]):+.2f}) "
              f"h={float(hs[i]):+.2f} esterr={float(errs[i]):.3f}")
    assert float(hs.min()) > 0.0, "safety violated under output feedback"
    assert float(errs[-1]) < float(errs[0]), "EKF did not reduce estimation error"
    return out


if __name__ == "__main__":
    main()
