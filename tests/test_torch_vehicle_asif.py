"""The slice as a whole, on the CPU: benchmarks/asif_bench.py's closed loop
(SE(2) x R^3 vehicle MPC on one clock, then the ASIF safety filter on every
vehicle's MPC input, then the plant step) through the JAX package and
through the port, at a small size.

Initial states come from numpy with a seed and go to both packages.  The
JAX side runs as asif_bench.py configures it (MPC on "pallas", the shared
kernel in interpret mode; ASIF on "lane" with adaptive rho); the port runs
its MPC on "cuda" (the shared kernel's wrapper runs its plain version on CPU
tensors) and its ASIF on "lane" with adaptive rho (the lane loop on CPU
tensors; on the card, the lane kernel).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import vmap

from smooth_feedback_tpu.controllers import MPCParams as JMPCParams
from smooth_feedback_tpu.controllers import MPCWeights as JMPCWeights
from smooth_feedback_tpu.controllers import make_mpc_step as j_make_mpc_step
from smooth_feedback_tpu.controllers.asif import ASIFilterParams as JASIFilterParams
from smooth_feedback_tpu.controllers.asif import ASIFtoQPParams as JASIFtoQPParams
from smooth_feedback_tpu.controllers.asif import make_asif_step as j_make_asif_step
from smooth_feedback_tpu.groups import SE2 as JSE2
from smooth_feedback_tpu.groups import Bundle as JBundle
from smooth_feedback_tpu.groups import Rn as JRn
from smooth_feedback_tpu.qp import QPSolverParams as JQPSolverParams
from smooth_feedback_tpu.utils.bounds import ManifoldBounds as JManifoldBounds
from smooth_feedback_tpu_torch import convert
from smooth_feedback_tpu_torch.controllers import (
    ASIFilterParams,
    ASIFtoQPParams,
    MPCParams,
    make_asif_step,
    make_mpc_step,
)
from smooth_feedback_tpu_torch.groups import SE2, Bundle, Rn
from smooth_feedback_tpu_torch.qp import (
    QPSolutionStatus, QPSolverParams, admm_iterate_cuda_shared, admm_solve_cuda_lane,
)

torch.set_num_threads(1)

weights_from_numpy = functools.partial(convert.weights_from_numpy, device="cpu")
bounds_from_numpy = functools.partial(convert.bounds_from_numpy, device="cpu")

DT = 0.025
# asif_bench.py's settings at a smaller size: MPC K = 8 (the bench: 30),
# ASIF K = 5 constraint times over T = 0.5 (the bench: 50 over 2.5, at the
# same dt = 0.05 and one substep a constraint interval)
MPC_K, ASIF_K, ASIF_T = 8, 5, 0.5
MPC_QP = dict(polish=False, max_iter=200, stop_check_iter=10)
ASIF_QP = dict(polish=False, max_iter=250, stop_check_iter=10, adaptive_rho=True, rho=0.02)
WEIGHTS = (np.eye(6), 0.1 * np.eye(6), np.eye(2))
ULIM = (np.eye(2), np.zeros(2), np.array([-0.2, -0.5]), np.array([0.5, 0.5]))
VDES = np.array([1.0, 0.0, 0.4])
BASE = np.array([2.5, 0.0, 0.0, 1.0])
OBSTACLE = np.array([0.0, -2.3])


def jax_fleet(dtype=jnp.float32):
    """asif_bench.py's build(), at the sizes above."""
    X, U = JBundle(JSE2, JRn(3)), JRn(2)
    f = lambda x, u: jnp.stack(
        [x[4], x[5], x[6], -0.2 * x[4] + u[0], jnp.zeros((), x.dtype), -0.4 * x[6] + u[1]]
    )
    vdes, base = jnp.asarray(VDES, dtype), jnp.asarray(BASE, dtype)
    xdes = lambda t: jnp.concatenate([JSE2.rplus(base, t * vdes), vdes])
    mpc, mws = j_make_mpc_step(
        X, U, f, xdes, lambda t: jnp.zeros(2, dtype),
        dxdes=lambda t: jnp.concatenate([vdes, jnp.zeros(3, dtype)]),
        weights=JMPCWeights(*(jnp.asarray(w, dtype) for w in WEIGHTS)),
        params=JMPCParams(K=MPC_K, tf=5.0, return_trajectories=False,
                          qp=JQPSolverParams(**MPC_QP, backend="pallas")),
        cr=lambda x, u: u, crl=jnp.array([-0.5, -0.5], dtype), cru=jnp.array([0.5, 0.5], dtype),
        dtype=dtype, reuse_factors=True, condense=True, static_reference=True,
        validate_reuse=False,
    )
    h = lambda t, x: jnp.array([jnp.linalg.norm(x[:2] - jnp.asarray(OBSTACLE, dtype)) - 0.7])
    bu = lambda t, x: jnp.stack([0.2 * x[4], -jnp.asarray(0.5, dtype)])
    asif, aws = j_make_asif_step(
        X, U, f, h, bu,
        params=JASIFilterParams(
            T=ASIF_T, asif=JASIFtoQPParams(K=ASIF_K, dt=0.05, alpha=2.0, relax_cost=1000.0),
            qp=JQPSolverParams(**ASIF_QP, backend="lane"),
        ),
        W_u=jnp.array([20.0, 1.0], dtype),
        ulim=JManifoldBounds(*(jnp.asarray(a, dtype) for a in ULIM)), dtype=dtype,
    )
    return X, f, h, mpc, mws, asif, aws


def torch_fleet(dtype=torch.float32, mpc_backend="cuda"):
    """The same fleet in the port."""
    X, U = Bundle(SE2, Rn(3)), Rn(2)
    kw = dict(dtype=dtype, device="cpu")
    f = lambda x, u: torch.stack(
        [x[4], x[5], x[6], -0.2 * x[4] + u[0], torch.zeros_like(x[4]), -0.4 * x[6] + u[1]]
    )
    vdes, base = torch.as_tensor(VDES, **kw), torch.as_tensor(BASE, **kw)
    xdes = lambda t: torch.cat([SE2.rplus(base, t * vdes), vdes])
    mpc, mws = make_mpc_step(
        X, U, f, xdes, lambda t: torch.zeros(2, **kw),
        dxdes=lambda t: torch.cat([vdes, torch.zeros(3, **kw)]),
        weights=weights_from_numpy(WEIGHTS, dtype=dtype),
        params=MPCParams(K=MPC_K, tf=5.0, return_trajectories=False,
                         qp=QPSolverParams(**MPC_QP, backend=mpc_backend)),
        cr=lambda x, u: u, crl=[-0.5, -0.5], cru=[0.5, 0.5],
        reuse_factors=True, condense=True, static_reference=True, validate_reuse=False, **kw,
    )
    obstacle = torch.as_tensor(OBSTACLE, **kw)
    h = lambda t, x: torch.linalg.vector_norm(x[:2] - obstacle)[None] - 0.7
    bu = lambda t, x: torch.stack([0.2 * x[4], torch.full_like(x[4], -0.5)])
    asif, aws = make_asif_step(
        X, U, f, h, bu,
        params=ASIFilterParams(
            T=ASIF_T, asif=ASIFtoQPParams(K=ASIF_K, dt=0.05, alpha=2.0, relax_cost=1000.0),
            qp=QPSolverParams(**ASIF_QP, backend="lane"),
        ),
        W_u=[20.0, 1.0], ulim=bounds_from_numpy(ULIM, dtype=dtype), **kw,
    )
    return X, f, h, mpc, mws, asif, aws


def test_closed_loop_mpc_asif_fleet_f32():
    """Four closed-loop steps of B = 4 vehicles, float32 in both packages,
    from the same states (X.rplus(identity, 0.2 N(0, I6)), seed 3).  Per step:
    MPC and ASIF statuses equal, MPC u within 1e-4 and filtered u within
    1e-3, states within 1e-3.  Why these: the MPC is PR 1's comparison (f32
    against f32 in another summation order, u within 1e-4); the ASIF QP runs
    at eps 1e-3 with adaptive rho, its input is the MPC u (so it inherits
    that 1e-4, weighted up to sqrt(20) by W_u = (20, 1)) and its transcription
    integrates 5 sensitivity steps in f32 on each side; the states integrate
    the filtered u over DT = 0.025.  Every post-step barrier is positive in
    both, as the bench's gate requires, and nothing launched a kernel."""
    B, steps = 4, 4
    JX, jf, jh, jmpc, jmws, jasif, jaws = jax_fleet()
    X, f, h, mpc, mws, asif, aws = torch_fleet()

    dx = 0.2 * np.random.default_rng(3).standard_normal((B, 6))
    jx = jax.vmap(lambda d: JX.rplus(JX.identity(jnp.float32), d))(jnp.asarray(dx, jnp.float32))
    tx = vmap(lambda d: X.rplus(X.identity(dtype=torch.float32), d))(
        torch.as_tensor(dx, dtype=torch.float32)
    )
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    bmap_j = lambda ws: jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), ws)
    bmap_t = lambda ws: type(ws)(*(a.expand((B,) + a.shape).contiguous() for a in ws))
    jmws, jaws, mws, aws = bmap_j(jmws), bmap_j(jaws), bmap_t(mws), bmap_t(aws)

    @jax.jit
    def jstep(x, mws_, aws_, t):
        m = jmpc.fleet_shared_t(mws_, t, x)
        a = jasif.fleet(aws_, x, m.u)
        x = jax.vmap(lambda xi, ui: JX.rplus(xi, DT * jf(xi, ui)))(x, a.u)
        return x, m, a

    admm_iterate_cuda_shared.launches = admm_solve_cuda_lane.launches = 0
    for i in range(steps):
        t = DT * i
        jx, jm, ja = jstep(jx, jmws, jaws, t)
        m = mpc.fleet_shared_t(mws, t, tx)
        a = asif.fleet(aws, tx, m.u)
        tx = vmap(lambda xi, ui: X.rplus(xi, DT * f(xi, ui)))(tx, a.u)
        np.testing.assert_array_equal(m.status.numpy(), np.asarray(jm.status))
        np.testing.assert_array_equal(a.status.numpy(), np.asarray(ja.status))
        np.testing.assert_allclose(m.u.numpy(), np.asarray(jm.u), atol=1e-4, rtol=0)
        np.testing.assert_allclose(a.u.numpy(), np.asarray(ja.u), atol=1e-3, rtol=0)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-3, rtol=0)
        assert bool((m.status == QPSolutionStatus.Optimal).all())
        assert bool((a.status == QPSolutionStatus.Optimal).all())
        hmin = float(vmap(lambda xi: h(t, xi))(tx).min())
        assert hmin > 0.0
        jmws, jaws, mws, aws = jm.warmstart, ja.warmstart, m.warmstart, a.warmstart
    assert admm_iterate_cuda_shared.launches == admm_solve_cuda_lane.launches == 0
