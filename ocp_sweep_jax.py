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

With ``--refine`` both packages run the mesh refinement instead (the
smoke's ``ocp-refine`` and ``ocp-solve`` protocol: from Mesh.uniform(3, 5)
to a dynamics error of 1e-3 (the fleet) or 1e-4 (the single OCP) in at
most 3 passes, tf guess 5, the sweep's SQP, rescue and fail_fast on):
``solve_ocp_flat_batch`` on the B velocities, each member starting from
(identity, (1, 0)), then ``solve_ocp`` on examples/ocp_se2_nlp.py's OCP.
It prints
one JSON line: per pass the mesh, the Optimal share before and after
rescue, the rescued count, SQP iterations and the fleet-max error (and the
per-interval errors of each pass that refined), the final mesh, and the
single OCP's passes, errors and x(0).  Its JAX readings are the bars
chip_smoke.py's refinement phases hold the card to.

Run from the repository root:  python3 ocp_sweep_jax.py [--B 64] [--port torch]
[--members I,J,...] [--x64] [--refine]
(``make_flat_nlp`` and ``sweep_params`` are also the JAX side of
tests/test_torch_ocp_sweep.py; importing this module changes no JAX
setting.)
"""

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke as cs
from smooth_feedback_tpu.groups import SE2, Bundle, Rn
from smooth_feedback_tpu.ocp import (
    OCP,
    SolveOCPParams,
    flatten_ocp,
    nlpsol_to_ocpsol,
    ocp_to_nlp,
    solve_ocp,
    solve_ocp_flat_batch,
)
from smooth_feedback_tpu.ocp.collocation import Mesh, mesh_dyn_error
from smooth_feedback_tpu.qp import QPSolverParams
from smooth_feedback_tpu.solvers import SQPParams, rescue_nonoptimal, solve_nlp_sqp_batch

X = Bundle(SE2, Rn(2))
U = Rn(2)


def tracking(vel):
    """The dynamics f and running cost g of the vehicle tracking the screw
    ``vel`` (chip_smoke.se2_tracking's twin)."""

    def f(t, x, u):
        return jnp.stack([x[4], jnp.zeros(()), x[5], u[0], u[1]])

    def g(t, x, u):
        e = X.rminus(x, jnp.concatenate([SE2.exp(t * vel), jnp.stack([vel[0], vel[2]])]))
        return jnp.array([0.5 * (e @ e + u @ u)])

    return f, g


def make_flat(vel, start=None):
    """benchmarks/ocp_se2.py:112-139: the flat OCP of one tracked velocity
    (``start`` fixes x0's speeds instead of the screw's, as
    chip_smoke.ocp_sweep_flat)."""
    x0_speeds = jnp.stack([vel[0], vel[2]]) if start is None else jnp.asarray(start)
    f, g = tracking(vel)
    ocp = OCP(
        X=X, U=U,
        theta=lambda tf, x0, xf, q: tf + q[0],
        f=f, g=g,
        cr=lambda t, x, u: u,
        crl=jnp.array([-1.0, -1.0]),
        cru=jnp.array([1.0, 1.0]),
        ce=lambda tf, x0, xf, q: jnp.concatenate(
            [tf[None], X.log(x0) - jnp.concatenate([jnp.zeros(3), x0_speeds])]
        ),
        cel=jnp.array([5.0, 0, 0, 0, 0, 0]),
        ceu=jnp.array([5.0, 0, 0, 0, 0, 0]),
    )
    return flatten_ocp(ocp, lambda t: X.identity(), lambda t: jnp.full(2, 0.01))


def make_flat_nlp(mesh, vel):
    """The flat NLP of one tracked velocity on ``mesh``."""
    return ocp_to_nlp(make_flat(vel), mesh)


def example_ocp():
    """examples/ocp_se2_nlp.py's OCP (vel (1, 0, 0.5), tf = 5, |u| <= 1,
    x0 fixed by the end constraints) and its nominal: the identity and
    u = 0.01."""
    f, g = tracking(jnp.array([1.0, 0.0, 0.5]))
    ocp = OCP(
        X=X, U=U,
        theta=lambda tf, x0, xf, q: tf + q[0],
        f=f, g=g,
        cr=lambda t, x, u: u,
        crl=jnp.array([-1.0, -1.0]), cru=jnp.array([1.0, 1.0]),
        ce=lambda tf, x0, xf, q: jnp.concatenate([tf[None], X.log(x0)]),
        cel=jnp.array([5.0, 0.0, 0.0, 0.0, 1.0, 0.0]),
        ceu=jnp.array([5.0, 0.0, 0.0, 0.0, 1.0, 0.0]),
    )
    return ocp, (lambda t: X.identity()), (lambda t: jnp.full(2, 0.01))


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
    ap.add_argument("--refine", action="store_true",
                    help="the mesh refinement of the fleet and of the single SE(2) OCP instead")
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", args.x64)
    members = None if args.members is None else [int(i) for i in args.members.split(",")]
    if args.refine:
        if members is not None:
            ap.error("--members does not combine with --refine (the fleet's mesh is shared)")
        print(json.dumps(port_refine(args) if args.port else jax_refine(args)))
        return
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


def refine_params(target_err=cs.OCP_FLEET_TARGET_ERR):
    """chip_smoke.ocp_refine_params through the JAX package's API."""
    return SolveOCPParams(target_err=target_err, max_refine_iter=cs.OCP_REFINE_ITER,
                          tf_guess=cs.OCP_TF_GUESS, sqp=sweep_params(), rescue=True, fail_fast=True)


def mesh_record(mesh):
    return {"ivals": mesh.N_ivals, "points": mesh.N_colloc, "intervals": [list(i) for i in mesh.intervals]}


def jax_refine(args):
    """The JAX package's solve_ocp_flat_batch on the smoke's family and
    velocities and its solve_ocp on examples/ocp_se2_nlp.py's OCP, with the
    smoke's refinement protocol.  A pass's Optimal share before rescue is
    1 - rescued / B (the rescue takes every non-Optimal member); each pass
    that refined is run again alone (max_refine_iter = its index + 1, the
    same compiled programs) for its per-interval fleet-max errors."""
    dt = jnp.float64 if args.x64 else jnp.float32
    vels = jnp.asarray(cs.ocp_sweep_velocities(args.B), dt)
    B = vels.shape[0]
    prm = refine_params()
    mesh0 = Mesh.uniform(*cs.OCP_MESH)
    fam = lambda vel: make_flat(vel, cs.OCP_REFINE_START)
    t0 = time.perf_counter()
    sol, mesh, info = solve_ocp_flat_batch(fam, vels, mesh0, prm)
    t_fleet = time.perf_counter() - t0
    errs = []
    for k in range(len(info.meshes) - 1):
        sk, mk, _ = solve_ocp_flat_batch(fam, vels, mesh0,
                                         dataclasses.replace(prm, max_refine_iter=k + 1))

        def one(th, s, mk=mk):
            flat = fam(th)
            o = nlpsol_to_ocpsol(flat, mk, s)
            return mesh_dyn_error(mk.increase_degrees(), flat.f, 0.0, o.tf, o.x, o.u)

        errs.append(np.asarray(jnp.max(jax.vmap(one)(vels, sk), axis=0)).tolist())
    st = np.asarray(info.statuses)
    n_pass = len(info.meshes)
    fleet = {
        "passes": [{
            "mesh": mesh_record(m),
            "optimal_pct_solve": 100.0 * (1.0 - info.rescued[k] / B),
            "optimal_pct_rescued": 100.0 * (float(np.mean(st == 0)) if k == n_pass - 1 else 1.0),
            "rescued": info.rescued[k],
            "iters_p50": float(np.percentile(np.asarray(info.nlp_iters[k]), 50)),
            "iters_max": int(np.max(np.asarray(info.nlp_iters[k]))),
            "max_err": info.errors[k],
            "errs": errs[k] if k < len(errs) else None,
        } for k, m in enumerate(info.meshes)],
        "final_mesh": mesh_record(mesh), "statuses": st.tolist(), "seconds": t_fleet,
    }
    ocp, xl, ul = example_ocp()
    t0 = time.perf_counter()
    ssol, smesh, sinfo = solve_ocp(ocp, xl, ul, mesh0, refine_params(cs.OCP_TARGET_ERR))
    single = {
        "status": int(sinfo.status), "meshes": [mesh_record(m) for m in sinfo.meshes],
        "nlp_iters": list(sinfo.nlp_iters), "errors": list(sinfo.errors),
        "x0": np.asarray(ssol.x(jnp.asarray(0.0, dt))).tolist(),
        "seconds": time.perf_counter() - t0,
    }
    return {"route": "jax/xla", "dtype": "float64" if args.x64 else "float32", "B": B,
            "fleet": fleet, "single": single}


def port_refine(args):
    """The port's drivers on the CPU, through chip_smoke's builders
    (``ocp_refine_run``, ``ocp_solve_run``): the subproblems on
    ``args.port``."""
    import torch

    dt = torch.float64 if args.x64 else torch.float32
    t0 = time.perf_counter()
    (sol, mesh, info), passes, _, _ = cs.ocp_refine_run("cpu", args.port, dt, args.B)
    t_fleet = time.perf_counter() - t0
    B = sol.x.shape[0]
    fleet = {
        "passes": [{
            "mesh": mesh_record(p["mesh"]),
            "optimal_pct_solve": 100.0 * float((p["solve"]["status"] == 0).float().mean()),
            "optimal_pct_rescued": 100.0 * float((p["rescue"]["status"] == 0).float().mean()),
            "rescued": p["n_rescued"],
            "not_optimal_after_solve": torch.nonzero(p["solve"]["status"] != 0).flatten().tolist(),
            "iters_p50": float(np.percentile(p["solve"]["iters"].numpy(), 50)),
            "iters_max": int(p["solve"]["iters"].max()),
            "qp_iters_max": int(p["solve"]["qp_iters"].max()),
            "max_err": max(p["errs"]) if "errs" in p else None,
            "errs": p.get("errs"),
            "seconds": {k[:-2]: p[k] for k in ("solve_s", "rescue_s", "error_s", "transfer_s")
                        if k in p},
        } for p in passes],
        "final_mesh": mesh_record(mesh), "statuses": sol.status.tolist(), "seconds": t_fleet,
        "errors": info.errors,
    }
    t0 = time.perf_counter()
    ssol, smesh, sinfo, x0 = cs.ocp_solve_run("cpu", args.port, dt)
    single = {
        "status": int(sinfo.status), "meshes": [mesh_record(m) for m in sinfo.meshes],
        "nlp_iters": list(sinfo.nlp_iters), "errors": list(sinfo.errors), "x0": x0.tolist(),
        "seconds": time.perf_counter() - t0,
    }
    return {"route": f"port/{args.port}", "dtype": str(dt), "B": B, "fleet": fleet,
            "single": single}


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
