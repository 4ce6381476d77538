#!/usr/bin/env python
"""SE(3) x R^3 rigid-body optimal control: a FLEET of screw-reach problems
solved by the batched SQP on a shared hp-refined mesh, on the PyTorch port
(examples/ocp_se3_nlp.py).

Each member tracks its own screw with a velocity/acceleration-controlled
rigid body; the fleet solves as one lockstep SQP per pass
(``solve_ocp_flat_batch``; on ``backend="cuda"`` one ``admm_problem``
launch per lockstep iteration), and the mesh refines on the fleet-max
interval dynamics error.
"""

import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from examples_torch._common import F32_TARGET_ERR, device_kw, f32_cut, sqp_params
from smooth_feedback_tpu_torch.groups import SE3, Bundle, Rn
from smooth_feedback_tpu_torch.nlp import NLPSolution
from smooth_feedback_tpu_torch.ocp import (
    OCP,
    SolveOCPParams,
    flatten_ocp,
    nlpsol_to_ocpsol,
    solve_ocp_flat_batch,
)
from smooth_feedback_tpu_torch.ocp.collocation import Mesh

X = Bundle(SE3, Rn(3))  # pose (7) + body linear velocity (3)
U = Rn(6)  # [linear acceleration (3), body angular velocity (3)]

TF = 3.0


def flat_factory(dtype=torch.float32, device="cuda"):
    """``make_flat(twist)``: the flat OCP of one tracked screw (runs under
    ``torch.func.vmap`` in ``twist``)."""
    kw = dict(dtype=dtype, device=device)
    bound_u = 2.0 * torch.ones(6, **kw)
    x_nom, u_nom = X.identity(**kw), torch.full((6,), 0.01, **kw)

    def make_flat(twist):
        def xdes(t):
            return torch.cat([SE3.exp(t * twist), twist[:3]])

        def f(t, x, u):
            # d(pose) = [v_body, w], d(v) = a
            return torch.cat([x[7:10], u[3:6], u[0:3]])

        def g(t, x, u):
            e = X.rminus(x, xdes(t))
            # 1-element: a 0-d float32 tensor times a Python scalar gets a
            # float64 tangent in torch's forward mode
            return 0.5 * torch.stack([e @ e + 0.1 * (u @ u)])

        ce_val = torch.cat([torch.full((1,), TF, **kw), torch.zeros(6, **kw), twist[:3]])
        ocp = OCP(
            X=X, U=U,
            theta=lambda tf, x0, xf, q: q[0],
            f=f, g=g,
            cr=lambda t, x, u: u, crl=-bound_u, cru=bound_u,
            ce=lambda tf, x0, xf, q: torch.cat([tf[None], X.log(x0)]),
            cel=ce_val, ceu=ce_val,
        )
        return flatten_ocp(ocp, lambda t: x_nom, lambda t: u_nom)

    return make_flat


def fleet_twists(B, generator=None, dtype=torch.float32, device="cuda"):
    """(B, 6) screws: (0.5, 0, 0.1, 0, 0, 0.3) + (0.1 N(I3), 0.05 N(I3)),
    drawn from ``generator`` (a CPU ``torch.Generator``, seed 0 by
    default; not the JAX example's ``jax.random`` draws)."""
    generator = generator or torch.Generator().manual_seed(0)
    base = torch.tensor([0.5, 0.0, 0.1, 0.0, 0.0, 0.3], dtype=torch.float64)
    dv = 0.1 * torch.randn((B, 3), generator=generator, dtype=torch.float64)
    dw = 0.05 * torch.randn((B, 3), generator=generator, dtype=torch.float64)
    return (base[None, :] + torch.cat([dv, dw], dim=1)).to(dtype=dtype, device=device)


def params(target_err, max_refine_iter, dtype, backend, verbose=True):
    """The example's refinement and SQP settings (max_iter 150, tol 1e-7;
    in float32 the tolerance and target of ``_common``)."""
    return SolveOCPParams(
        target_err=f32_cut("target_err", target_err, F32_TARGET_ERR, dtype),
        max_refine_iter=max_refine_iter,
        tf_guess=TF,
        sqp=sqp_params(150, 1e-7, dtype, backend),
        verbose=verbose,
    )


def run(target_err: float = 1e-4, max_refine_iter: int = 6, B: int = 8, *, twists=None,
        device="cuda", dtype=torch.float32, backend="cuda"):
    """The fleet's refinement.  ``twists`` (B, 6) replaces the seeded draws.
    Returns ``dict(nlpsol, mesh, info, twists, seconds, ts, xs)`` with
    member 0's state at 7 times."""
    kw = device_kw(device, dtype)
    twists = fleet_twists(B, **kw) if twists is None else torch.as_tensor(twists, **kw)
    make_flat = flat_factory(**kw)
    t0 = time.perf_counter()
    nlpsol, mesh, info = solve_ocp_flat_batch(
        make_flat, twists, Mesh(), params(target_err, max_refine_iter, dtype, backend), **kw)
    seconds = time.perf_counter() - t0
    sol0 = nlpsol_to_ocpsol(make_flat(twists[0]), mesh, NLPSolution(*(a[0] for a in nlpsol)))
    ts = torch.linspace(0.0, float(sol0.tf), 7, **kw)
    return dict(nlpsol=nlpsol, mesh=mesh, info=info, twists=twists, seconds=seconds, ts=ts,
                xs=torch.stack([sol0.x(t) for t in ts]))


def main(target_err: float = 1e-4, max_refine_iter: int = 6, B: int = 8, *, device="cuda",
         dtype=torch.float32, backend="cuda"):
    out = run(target_err, max_refine_iter, B, device=device, dtype=dtype, backend=backend)
    info, mesh = out["info"], out["mesh"]
    print(f"TOTAL TIME: {out['seconds']:.1f}s")
    st = info.statuses.cpu().numpy()
    print(f"fleet of {B}: {int((st == 0).sum())}/{B} Optimal, final mesh {mesh.N_ivals} "
          f"intervals / {mesh.N_colloc} points, dyn errors: "
          + " ".join(f"{e:.1e}" for e in info.errors))
    for t, x in zip(out["ts"].tolist(), out["xs"]):
        print(f"t={t:4.1f}: pos=({float(x[0]):+.2f},{float(x[1]):+.2f},{float(x[2]):+.2f}) "
              f"|v|={float(torch.linalg.vector_norm(x[7:])):.2f}")
    assert np.all(st == 0), "non-Optimal members in the fleet"
    return out


if __name__ == "__main__":
    main()
