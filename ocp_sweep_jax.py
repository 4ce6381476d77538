#!/usr/bin/env python3
"""The JAX package's SE(2) OCP sweep on a CPU, on chip_smoke.py's velocities.

benchmarks/ocp_se2.py's on-device protocol (float32, SQP tol 1e-4, the
compensated KKT, qp_budget 36000, inner QP eps 1e-6 with 1200 iterations,
polish, one refinement sweep, compensated checks; then rescue_nonoptimal
with budget_scale 4, adaptive rho and stall_scale 3), run by the JAX
package on the CPU with ``backend="xla"`` at B = 64 on Mesh.uniform(3, 5),
for the velocities ``chip_smoke.ocp_sweep_velocities`` draws with numpy.
Its Optimal share after rescue is the bar the port's ``ocp-sweep`` phase
meets on the card.  The problem is built here from the JAX package's API,
as benchmarks/ocp_se2.py:112-139 builds it (that module sets JAX's
configuration when imported, so it is not imported).

With ``--port BACKEND`` the same protocol runs through the PyTorch port
instead (chip_smoke.py's builders, float32 on the CPU, the sweep's
subproblems on ``backend=BACKEND``: "torch" is the loop JAX's "xla" mirrors,
"cuda" on CPU tensors runs admm_problem's plain version; the rescue on
"torch" as on the card), so the two packages' shares compare on one CPU.

Prints one JSON line: statuses, SQP and inner-QP iterations and KKT
residuals per member before and after rescue, the Optimal shares, times.

``--members 15,0`` keeps those members of the B velocities (each member's
solve is independent of the others'), ``--x64`` runs either package in
float64.

Run from the repository root:  python3 ocp_sweep_jax.py [--B 64] [--port torch]
[--members I,J,...] [--x64]
(``make_flat_nlp`` and ``sweep_params`` are also the JAX side of
tests/test_torch_ocp_sweep.py; importing this module changes no JAX
setting.)
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke as cs
from smooth_feedback_tpu.groups import SE2, Bundle, Rn
from smooth_feedback_tpu.ocp import OCP, flatten_ocp, ocp_to_nlp
from smooth_feedback_tpu.ocp.collocation import Mesh
from smooth_feedback_tpu.qp import QPSolverParams
from smooth_feedback_tpu.solvers import SQPParams, rescue_nonoptimal, solve_nlp_sqp_batch

X = Bundle(SE2, Rn(2))
U = Rn(2)


def make_flat_nlp(mesh, vel):
    """benchmarks/ocp_se2.py:112-139: the flat NLP of one tracked velocity."""

    def xdes(t):
        return jnp.concatenate([SE2.exp(t * vel), jnp.stack([vel[0], vel[2]])])

    def f(t, x, u):
        return jnp.stack([x[4], jnp.zeros(()), x[5], u[0], u[1]])

    def g(t, x, u):
        e = X.rminus(x, xdes(t))
        return jnp.array([0.5 * (e @ e + u @ u)])

    ocp = OCP(
        X=X, U=U,
        theta=lambda tf, x0, xf, q: tf + q[0],
        f=f, g=g,
        cr=lambda t, x, u: u,
        crl=jnp.array([-1.0, -1.0]),
        cru=jnp.array([1.0, 1.0]),
        ce=lambda tf, x0, xf, q: jnp.concatenate(
            [tf[None], X.log(x0) - jnp.concatenate([jnp.zeros(3), jnp.stack([vel[0], vel[2]])])]
        ),
        cel=jnp.array([5.0, 0, 0, 0, 0, 0]),
        ceu=jnp.array([5.0, 0, 0, 0, 0, 0]),
    )
    flat = flatten_ocp(ocp, lambda t: X.identity(), lambda t: jnp.full(2, 0.01))
    return ocp_to_nlp(flat, mesh)


def sweep_params(backend="xla"):
    """benchmarks/ocp_se2.py:166-194, unchunked (B <= 64), no probe, no stall."""
    return SQPParams(
        max_iter=60, tol=1e-4, compensated_kkt=True, qp_budget=36000,
        qp=QPSolverParams(eps_abs=1e-6, eps_rel=1e-6, max_iter=1200, polish=True,
                          kkt_refine_iters=1, backend=backend, compensated_check=True),
    )


def port_sweep(B, backend, members=None, x64=False):
    """The port's sweep and rescue on the CPU: ``(sol, merged, n_rescued,
    t_sweep, t_rescue)``."""
    import torch

    from smooth_feedback_tpu_torch.solvers import solve_nlp_sqp_batch as t_batch

    make, vels, z0 = cs.ocp_sweep_path("cpu", torch.float64 if x64 else torch.float32, B)
    if members is not None:
        vels, z0 = vels[members], z0[members]
    prm = cs.ocp_sweep_params(backend)
    t0 = time.perf_counter()
    sol = t_batch(make, vels, z0, prm)
    t_sweep = time.perf_counter() - t0
    t0 = time.perf_counter()
    merged, n_resc = cs.ocp_sweep_rescue(make, vels, sol, prm, z0)
    return sol, merged, n_resc, t_sweep, time.perf_counter() - t0


def main():
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=cs.OCP_B)
    ap.add_argument("--port", choices=("torch", "cuda"), default=None,
                    help="run the PyTorch port's sweep with this subproblem backend instead")
    ap.add_argument("--members", default=None, help="comma-separated members to keep")
    ap.add_argument("--x64", action="store_true", help="float64 instead of float32")
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", args.x64)
    members = None if args.members is None else [int(i) for i in args.members.split(",")]
    if args.port is not None:
        sol, merged, n_resc, t_sweep, t_rescue = port_sweep(args.B, args.port, members, args.x64)
        report(args, f"port/{args.port}", sol, merged, n_resc, t_sweep, t_rescue)
        return
    mesh = Mesh.uniform(*cs.OCP_MESH)
    dt = jnp.float64 if args.x64 else jnp.float32
    vels = jnp.asarray(cs.ocp_sweep_velocities(args.B), dt)
    if members is not None:
        vels = vels[jnp.asarray(members)]
    make = lambda vel: make_flat_nlp(mesh, vel)
    n = make(vels[0]).n
    z0 = jnp.zeros((vels.shape[0], n), dt).at[:, 0].set(5.0)
    prm = sweep_params()

    t0 = time.perf_counter()
    sol = jax.jit(lambda th, x: solve_nlp_sqp_batch(make, th, x, prm))(vels, z0)
    np.asarray(sol.status)
    t_sweep = time.perf_counter() - t0
    t0 = time.perf_counter()
    merged, n_resc = rescue_nonoptimal(make, vels, sol, prm, x0_cold=z0, budget_scale=4,
                                       adaptive_rho=True, stall_scale=3)
    np.asarray(merged.status)
    t_rescue = time.perf_counter() - t0
    report(args, "jax/xla", sol, merged, n_resc, t_sweep, t_rescue)


def report(args, route, sol, merged, n_resc, t_sweep, t_rescue):
    st, st_r = np.asarray(sol.status), np.asarray(merged.status)
    out = {
        "B": args.B, "members": args.members, "mesh": list(cs.OCP_MESH),
        "dtype": "float64" if args.x64 else "float32", "route": route,
        "x": np.asarray(sol.x).tolist(),
        "optimal_pct_sweep": float(np.mean(st == 0) * 100.0),
        "optimal_pct_rescued": float(np.mean(st_r == 0) * 100.0),
        "rescued": n_resc,
        "status": st.tolist(), "iters": np.asarray(sol.iters).tolist(),
        "qp_iters": np.asarray(sol.qp_iters).tolist(),
        "kkt": np.asarray(sol.kkt_res).tolist(),
        "status_rescued": st_r.tolist(), "kkt_rescued": np.asarray(merged.kkt_res).tolist(),
        "sweep_s": t_sweep, "rescue_s": t_rescue,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
