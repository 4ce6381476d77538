"""The composition on the CPU: examples/output_feedback_vehicle.py's loop
(EKF update from noisy landmark and velocity measurements of the TRUE
state, MPC on the estimate, ASIF safety filter on the MPC input, plant step
with process noise, EKF predict through the applied input) through the JAX
package and through the port, float64, at a small size.

The port's loop is chip_smoke.py's (``output_feedback_path``,
``output_feedback_step``), the one the card runs; the JAX loop is the
example's own functions at the same sizes.  Both take the same noise, made
with numpy from a seed.  The JAX side solves on "xla", the port on "torch".
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as cs
from smooth_feedback_tpu.controllers import MPCParams, MPCWeights, make_mpc_step
from smooth_feedback_tpu.controllers.asif import ASIFilterParams, ASIFtoQPParams, make_asif_step
from smooth_feedback_tpu.estimators import ekf_predict, ekf_reset, ekf_update
from smooth_feedback_tpu.groups import SE2
from smooth_feedback_tpu.qp import QPSolverParams
from smooth_feedback_tpu.utils.bounds import ManifoldBounds

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the example's sizes cut as tests/test_examples.py cuts them, further for
# the ASIF: MPC K = 8 (the example: 30), ASIF K = 5 over T = 0.5 (50 over
# 2.5, the same dt = 0.05)
K_MPC, K_ASIF, T_ASIF, STEPS = 8, 5, 0.5, 3


def _example():
    path = ROOT / "examples" / "output_feedback_vehicle.py"
    spec = importlib.util.spec_from_file_location("example_output_feedback_vehicle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_loop():
    """The example's construction (output_feedback_vehicle.py:55-98) at the
    sizes above, and its loop body as one jitted step."""
    ex = _example()
    X, U, f, meas = ex.X, ex.U, ex.f, ex.meas
    vdes = jnp.array([1.0, 0.0, 0.4])
    base = jnp.concatenate(
        [jnp.array([2.5, 0.0]), jnp.array([jnp.cos(jnp.pi / 2), jnp.sin(jnp.pi / 2)])]
    )
    mpc_step, mws = make_mpc_step(
        X, U, f, lambda t: jnp.concatenate([SE2.rplus(base, t * vdes), vdes]),
        lambda t: jnp.zeros(2), dxdes=lambda t: jnp.concatenate([vdes, jnp.zeros(3)]),
        weights=MPCWeights(Q=jnp.eye(6), Qtf=0.1 * jnp.eye(6), R=jnp.eye(2)),
        params=MPCParams(K=K_MPC, tf=5.0, qp=QPSolverParams(polish=False)),
        cr=lambda x, u: u, crl=jnp.array([-0.5, -0.5]), cru=jnp.array([0.5, 0.5]),
    )
    h = lambda t, x: jnp.array([jnp.linalg.norm(x[:2] - jnp.array([0.0, -2.3])) - 0.7])
    bu = lambda t, x: jnp.stack([0.2 * x[4], -jnp.asarray(0.5)])
    asif_step, aws = make_asif_step(
        X, U, f, h, bu,
        params=ASIFilterParams(
            T=T_ASIF, asif=ASIFtoQPParams(K=K_ASIF, dt=0.05, alpha=1.0, relax_cost=100.0),
            qp=QPSolverParams(polish=False),
        ),
        W_u=jnp.array([20.0, 1.0]),
        ulim=ManifoldBounds(A=jnp.eye(2), c=jnp.zeros(2), l=jnp.array([-0.2, -0.5]),
                            u=jnp.array([0.5, 0.5])),
    )
    dt = cs.OF_DT
    Q = jnp.diag(jnp.array([1e-4, 1e-4, 1e-4, 1e-3, 1e-6, 1e-3]))
    R = jnp.diag(jnp.concatenate([jnp.full(8, 1e-3), jnp.full(3, 1e-3)]))

    @jax.jit
    def step(x, est, mws, aws, t, nm, nw):
        est = ekf_update(X, meas, est, meas(x) + nm, R)
        m = mpc_step(mws, t, est.g)
        a = asif_step(aws, est.g, m.u)
        x = X.rplus(x, dt * f(x, a.u) + jnp.sqrt(dt) * nw)
        est = ekf_predict(X, lambda t_, g: f(g, a.u), est, Q, dt)
        return x, est, m, a

    x0 = X.identity()
    est0 = ekf_reset(X, X.rplus(x0, jnp.array([0.3, -0.3, 0.2, 0.0, 0.0, 0.0])), 0.5 * jnp.eye(6))
    return step, x0, est0, mws, aws


def test_output_feedback_loop_matches_jax():
    """Three steps of the EKF -> MPC -> ASIF -> plant -> EKF loop, float64,
    port against JAX from the same start and noise.  Per step: MPC and ASIF
    statuses and iteration counts equal; the MPC u within 1e-4, the
    filtered u within 1e-3, the true state and the estimate (g and P)
    within 1e-3 (test_torch_vehicle_asif.py's bounds); every barrier on the
    true state positive.  The MPC runs to max_iter on both sides (the
    example's MPC does at the full size too)."""
    step_j, xj, estj, mwsj, awsj = _jax_loop()
    p = cs.output_feedback_path("cpu", torch.float64, "torch", K_MPC, K_ASIF, T_ASIF)
    xt, estt = cs.output_feedback_start(p)
    mwst, awst = p["mws"], p["aws"]
    nm, nw = cs.output_feedback_noise(STEPS, p["kw"])
    np.testing.assert_allclose(estt.g.numpy(), np.asarray(estj.g), atol=1e-15)
    for i in range(STEPS):
        xj, estj, mj, aj = step_j(xj, estj, mwsj, awsj, cs.OF_DT * i, nm[i].numpy(), nw[i].numpy())
        xt, estt, _, mt, at = cs.output_feedback_step(p, i, xt, estt, mwst, awst, nm[i], nw[i])
        for what, a, b in (("MPC status", mt.status, mj.status),
                           ("MPC iters", mt.warmstart.iters, mj.warmstart.iters),
                           ("ASIF status", at.status, aj.status),
                           ("ASIF iters", at.warmstart.iters, aj.warmstart.iters)):
            assert int(a) == int(b), (i, what, int(a), int(b))
        for what, a, b, tol in (("MPC u", mt.u, mj.u, 1e-4), ("ASIF u", at.u, aj.u, 1e-3),
                                ("x", xt, xj, 1e-3), ("est g", estt.g, estj.g, 1e-3),
                                ("est P", estt.P, estj.P, 1e-3)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0,
                                       err_msg=f"step {i} {what}")
        assert float(p["h"](None, xt)[0]) > 0.0
        mwsj, awsj, mwst, awst = mj.warmstart, aj.warmstart, mt.warmstart, at.warmstart
