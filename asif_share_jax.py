#!/usr/bin/env python3
"""The vehicle MPC + ASIF fleet's MPC Optimal share on a CPU, by the JAX
package and by the port, on chip_smoke.py's fleet.

benchmarks/asif_bench.py's configuration (:39-123: the SE(2) x R^3
vehicle's condensed MPC on one clock, K = 30, polish off, max_iter 200, a
check every 10; the ASIF, K = 50, on the lane backend with adaptive rho,
rho 0.02, max_iter 250) in float32 at chip_smoke.py's B = 256, initial
states (X.rplus(identity, 0.2 N(0, I6)), numpy seed 0) and steps
(ASIF_WARM + ASIF_STEPS, dt = 0.025), run by the JAX package on the CPU:
its MPC on ``backend="xla"`` (the plain loop the bench's Pallas kernel
runs).  The
problem is built here from the JAX package's API as the bench builds it
(that module sets JAX's configuration when imported, so it is not
imported).  With ``--port BACKEND`` the port runs the same loop instead
(chip_smoke.vehicle_asif_path, float32 on the CPU, the MPC on
``backend=BACKEND``: "torch" is the loop JAX's "xla" mirrors, "cuda" on
CPU tensors runs admm_shared's plain version; the ASIF on "lane" as on
the card), so the two packages' shares compare on one CPU.

Prints one JSON line: the MPC and ASIF Optimal shares over all steps and
members, the non-Optimal MPC solves per step, the first non-Optimal
(step, member) pairs, the min barrier, seconds.

Run from the repository root:  python3 asif_share_jax.py [--port torch|cuda]
"""

import argparse
import json
import time

import numpy as np

import chip_smoke as cs


STEPS = cs.ASIF_WARM + cs.ASIF_STEPS


def jax_run():
    """The JAX package's loop; returns per-step (B,) MPC and ASIF statuses
    and the min barrier."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from smooth_feedback_tpu.controllers import MPCParams, MPCWeights, make_mpc_step
    from smooth_feedback_tpu.controllers.asif import ASIFilterParams, ASIFtoQPParams, make_asif_step
    from smooth_feedback_tpu.groups import SE2, Bundle, Rn
    from smooth_feedback_tpu.qp import QPSolverParams
    from smooth_feedback_tpu.utils.bounds import ManifoldBounds

    dt = jnp.float32
    X, U = Bundle(SE2, Rn(3)), Rn(2)

    def f(x, u):
        v = x[4:]
        return jnp.stack([v[0], v[1], v[2], -0.2 * v[0] + u[0], jnp.zeros((), x.dtype),
                          -0.4 * v[2] + u[1]])

    vdes = jnp.array([1.0, 0.0, 0.4], dt)
    base = jnp.array([2.5, 0.0, 0.0, 1.0], dt)
    mpc, mws = make_mpc_step(
        X, U, f, lambda t: jnp.concatenate([SE2.rplus(base, t * vdes), vdes]),
        lambda t: jnp.zeros(2, dt), dxdes=lambda t: jnp.concatenate([vdes, jnp.zeros(3, dt)]),
        weights=MPCWeights(Q=jnp.eye(6, dtype=dt), Qtf=0.1 * jnp.eye(6, dtype=dt),
                           R=jnp.eye(2, dtype=dt)),
        params=MPCParams(K=cs.ASIF_MPC_K, tf=5.0, return_trajectories=False,
                         qp=QPSolverParams(polish=False, max_iter=200, stop_check_iter=10,
                                           backend="xla")),
        cr=lambda x, u: u, crl=jnp.array([-0.5, -0.5], dt), cru=jnp.array([0.5, 0.5], dt),
        dtype=dt, reuse_factors=True, condense=True, static_reference=True,
    )
    h = lambda t, x: jnp.array([jnp.linalg.norm(x[:2] - jnp.array([0.0, -2.3], dt)) - 0.7])
    bu = lambda t, x: jnp.stack([0.2 * x[4], -jnp.asarray(0.5, dt)])
    asif, aws = make_asif_step(
        X, U, f, h, bu,
        params=ASIFilterParams(T=cs.ASIF_T, asif=ASIFtoQPParams(K=50, dt=0.05, alpha=2.0,
                                                                  relax_cost=1000.0),
                               qp=QPSolverParams(polish=False, max_iter=250, stop_check_iter=10,
                                                 backend="lane", adaptive_rho=True, rho=0.02)),
        W_u=jnp.array([20.0, 1.0], dt),
        ulim=ManifoldBounds(A=jnp.eye(2, dtype=dt), c=jnp.zeros(2, dt),
                            l=jnp.array([-0.2, -0.5], dt), u=jnp.array([0.5, 0.5], dt)),
    )
    dx = jnp.asarray(initial_tangents(), dt)
    xs = jax.vmap(lambda d: X.rplus(X.identity().astype(dt), d))(dx)
    B = xs.shape[0]
    bmap = lambda ws: jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), ws)
    mws, aws = bmap(mws), bmap(aws)

    @jax.jit
    def step(xs, mws, aws, t):
        m = mpc.fleet_shared_t(mws, t, xs)
        a = asif.fleet(aws, xs, m.u)
        xs = jax.vmap(lambda x, u: X.rplus(x, cs.ASIF_DT * f(x, u)))(xs, a.u)
        return xs, m.warmstart, a.warmstart, m.status, a.status, jnp.min(
            jax.vmap(lambda x: h(t, x)[0])(xs))

    m_st, a_st, hmin = [], [], np.inf
    for i in range(STEPS):
        xs, mws, aws, ms, as_, hm = step(xs, mws, aws, jnp.asarray(cs.ASIF_DT * i, dt))
        m_st.append(np.asarray(ms))
        a_st.append(np.asarray(as_))
        hmin = min(hmin, float(hm))
    return np.stack(m_st), np.stack(a_st), hmin


def port_run(backend):
    """The port's loop (chip_smoke.vehicle_asif_phase's, on the CPU)."""
    import torch
    from torch.func import vmap

    torch.set_num_threads(1)
    dt = torch.float32
    dev = torch.device("cpu")
    X, f, h, mpc, mws, asif, aws = cs.vehicle_asif_path(backend, dev, dt)
    xs = torch.as_tensor(initial_tangents(), dtype=dt)
    xs = vmap(lambda d: X.rplus(X.identity(dtype=dt, device=dev), d))(xs)
    mws, aws = cs.batch_ws(mws, xs.shape[0]), cs.batch_ws(aws, xs.shape[0])
    m_st, a_st, hmin = [], [], np.inf
    for i in range(STEPS):
        t = cs.ASIF_DT * i
        m = mpc.fleet_shared_t(mws, t, xs)
        a = asif.fleet(aws, xs, m.u)
        xs = vmap(lambda x, u: X.rplus(x, cs.ASIF_DT * f(x, u)))(xs, a.u)
        hmin = min(hmin, float(vmap(lambda x: h(t, x)[0])(xs).min()))
        mws, aws = m.warmstart, a.warmstart
        m_st.append(m.status.numpy())
        a_st.append(a.status.numpy())
    return np.stack(m_st), np.stack(a_st), hmin


def initial_tangents():
    """chip_smoke.asif_initial's tangents (numpy seed 0)."""
    return 0.2 * np.random.default_rng(cs.SEED).standard_normal((cs.ASIF_B, 6))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", choices=("torch", "cuda"))
    a = ap.parse_args()
    t0 = time.perf_counter()
    m, s, hmin = port_run(a.port) if a.port else jax_run()
    bad = [(int(i), int(j)) for i, j in zip(*np.nonzero(m != 0))]
    print(json.dumps({
        "package": f"port ({a.port})" if a.port else "jax (xla)",
        "dtype": "float32", "B": m.shape[1], "steps": STEPS,
        "mpc_optimal_pct": 100.0 * float((m == 0).mean()),
        "asif_optimal_pct": 100.0 * float((s == 0).mean()),
        "mpc_not_optimal_per_step": [int(v) for v in (m != 0).sum(axis=1)],
        "mpc_statuses_not_optimal": sorted({int(v) for v in m[m != 0]}),
        "first_not_optimal": bad[:40], "min_barrier": hmin,
        "seconds": round(time.perf_counter() - t0, 3),
    }))


if __name__ == "__main__":
    main()
