"""The port's examples (examples_torch/) against the JAX package's, on the
CPU in float64.

Each port example's ``run`` at tests/test_examples.py's SMOKE_KWARGS (the
SE(3) MPC at the first quarter of its steps),
device "cpu", float64, the torch loop (``backend="torch"``), against the
same quantities computed by the JAX package on the same inputs: the JAX
example's construction at those sizes, its loop body jitted once and
stepped on the host, its ``jax.random`` draws passed into the port's
``run``.  Tolerances are stated per case.

The refinement examples are held more cheaply: the JAX package re-traces
an SQP for every mesh, so the SE(3) fleet's, the SE(2) OCP's and the
double integrator's NLPs are held at one point (f, g and their first
derivatives, one JAX program each, as the refinement family's in
tests/test_torch_ocp_solve.py), and each port run is checked against its
own float64 KKT residual and its fixed ends.
"""

import functools
import importlib
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from smooth_feedback_tpu.controllers import MPCParams, MPCWeights, make_mpc_step
from smooth_feedback_tpu.controllers.asif import ASIFilterParams, ASIFtoQPParams, make_asif_step
from smooth_feedback_tpu.estimators import (
    ekf_fleet_predict, ekf_fleet_reset, ekf_fleet_update, ekf_predict, ekf_reset, ekf_update,
    sqrt_ekf_fleet_predict, sqrt_ekf_fleet_reset, sqrt_ekf_fleet_update,
)
from smooth_feedback_tpu.groups import SE2 as JSE2
from smooth_feedback_tpu.groups import SE3 as JSE3
from smooth_feedback_tpu.groups import Rn as JRn
from smooth_feedback_tpu.ocp import ocp_to_nlp as j_ocp_to_nlp
from smooth_feedback_tpu.ocp import ocp_to_qp as j_ocp_to_qp
from smooth_feedback_tpu.ocp import flatten_ocp as j_flatten_ocp
from smooth_feedback_tpu.ocp import qpsol_to_ocpsol as j_qpsol_to_ocpsol
from smooth_feedback_tpu.ocp.collocation import Mesh as JMesh
from smooth_feedback_tpu.qp import QPSolverParams as JQPSolverParams
from smooth_feedback_tpu.qp import solve_qp as j_solve_qp
from smooth_feedback_tpu.utils.bounds import ManifoldBounds as JManifoldBounds

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = dict(device="cpu", dtype=torch.float64)
TORCH = dict(CPU, backend="torch")


def _jax_example(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    return t.detach().to("cpu", torch.float64).numpy() if torch.is_tensor(t) else np.asarray(t)


# ------------------------------------------------------------------ MPC


# the SE(3) MPC's first 10 of SMOKE_KWARGS' 40 steps: the port's
# transcription takes ~0.6 s a step on a CPU core, on top of ~30 s of the
# JAX step's compile, and the new test files share a budget of ~150 s of
# tier-1's time
SE3_MPC_STEPS = 10


def test_mpc_se3_rigidbody_matches_jax():
    """The SE(3) x R^6 hover MPC, SE3_MPC_STEPS steps: statuses equal,
    states and hover errors within 1e-8 of the JAX example's loop (equal
    iteration counts every step keep the two on one path)."""
    from examples_torch import mpc_se3_rigidbody as ex

    jx = _jax_example("mpc_se3_rigidbody")
    X, f = jx.X, jx.f
    target = JSE3.exp(jnp.array([1.0, -0.5, 0.8, 0.0, 0.0, 0.6]))
    xd = jnp.concatenate([target, jnp.zeros(6)])
    step, ws = make_mpc_step(
        X, jx.U, f, lambda t: xd, lambda t: jnp.zeros(6), dxdes=lambda t: jnp.zeros(12),
        weights=MPCWeights(Q=jnp.eye(12), Qtf=5.0 * jnp.eye(12), R=0.1 * jnp.eye(6)),
        params=MPCParams(K=8, tf=2.0, qp=JQPSolverParams(polish=False)),
        cr=lambda x, u: u, crl=-2.0 * jnp.ones(6), cru=2.0 * jnp.ones(6),
    )

    @jax.jit
    def body(x, ws, t):
        res = step(ws, t, x)
        x = X.rplus(x, ex.DT * f(x, res.u))
        return x, res.warmstart, res.status, jnp.linalg.norm(X.rminus(x, xd))

    x = X.rplus(X.identity(), jnp.concatenate([jnp.zeros(6), jnp.array([0.3, -0.2, 0.1, 0.1, 0.2, -0.1])]))
    xs, st, errs = [], [], []
    for i in range(SE3_MPC_STEPS):
        x, ws, s, e = body(x, ws, i * ex.DT)
        xs.append(x), st.append(s), errs.append(e)
    out = ex.run(SE3_MPC_STEPS, **TORCH)
    np.testing.assert_array_equal(_np(out["statuses"]), np.asarray(st))
    np.testing.assert_allclose(_np(out["xs"]), np.asarray(xs), atol=1e-8)
    np.testing.assert_allclose(_np(out["errs"]), np.asarray(errs), atol=1e-8)


def test_mpc_doubleintegrator_matches_jax():
    """The condensed K = 20 MPC, 30 steps: statuses equal, states and inputs
    within 1e-9 of the JAX example's loop (RK4 plant)."""
    from examples_torch import mpc_doubleintegrator as ex

    f = lambda x, u: jnp.stack([x[1], u[0]])
    step, ws = make_mpc_step(
        JRn(2), JRn(1), f,
        lambda t: jnp.stack([-0.5 * jnp.sin(0.3 * t), -0.15 * jnp.cos(0.3 * t)]),
        lambda t: jnp.zeros(1),
        weights=MPCWeights(Q=jnp.eye(2), Qtf=0.1 * jnp.eye(2), R=0.1 * jnp.eye(1)),
        params=MPCParams(K=20, tf=5.0, qp=JQPSolverParams(polish=False, max_iter=300)),
        cr=lambda x, u: u, crl=jnp.array([-0.5]), cru=jnp.array([0.5]),
        reuse_factors=True, condense=True,
    )
    dt = ex.DT

    def rk4(x, u):
        k1 = f(x, u)
        k2 = f(x + 0.5 * dt * k1, u)
        k3 = f(x + 0.5 * dt * k2, u)
        k4 = f(x + dt * k3, u)
        return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    @jax.jit
    def body(x, ws, t):
        res = step(ws, t, x)
        return rk4(x, res.u), res.warmstart, res.u, res.status

    x, xs, us, st = jnp.array([1.0, 0.0]), [], [], []
    for i in range(30):
        x, ws, u, s = body(x, ws, i * dt)
        xs.append(x), us.append(u), st.append(s)
    out = ex.run(30, **TORCH)
    np.testing.assert_array_equal(_np(out["statuses"]), np.asarray(st))
    np.testing.assert_allclose(_np(out["xs"]), np.asarray(xs), atol=1e-9)
    np.testing.assert_allclose(_np(out["us"]), np.asarray(us), atol=1e-9)


def _jax_vehicle_filter(K_asif, T=2.5):
    """mpc_asif_vehicle.py's ASIF (alpha 1, relax_cost 100, W_u (20, 1))."""
    jx = _jax_example("mpc_asif_vehicle")
    h = lambda t, x: jnp.array([jnp.linalg.norm(x[:2] - jnp.array([0.0, -2.3])) - 0.7])
    bu = lambda t, x: jnp.stack([0.2 * x[4], -jnp.asarray(0.5)])
    asif, aws = make_asif_step(
        jx.X, jx.U, jx.f, h, bu,
        params=ASIFilterParams(T=T, asif=ASIFtoQPParams(K=K_asif, dt=0.05, alpha=1.0,
                                                         relax_cost=100.0),
                               qp=JQPSolverParams(polish=False)),
        W_u=jnp.array([20.0, 1.0]),
        ulim=JManifoldBounds(A=jnp.eye(2), c=jnp.zeros(2), l=jnp.array([-0.2, -0.5]),
                             u=jnp.array([0.5, 0.5])),
    )
    return jx, h, asif, aws


def test_mpc_asif_vehicle_matches_jax():
    """The vehicle MPC + ASIF, 3 steps at K_mpc 8, K_asif 10: statuses
    equal, states, the MPC's and the filtered inputs and the barrier within
    1e-9 of the JAX example's loop."""
    from examples_torch import mpc_asif_vehicle as ex

    jx, h, asif, aws = _jax_vehicle_filter(10)
    X, f = jx.X, jx.f
    vdes = jnp.array([1.0, 0.0, 0.4])
    base = jnp.array([2.5, 0.0, jnp.cos(jnp.pi / 2), jnp.sin(jnp.pi / 2)])
    mpc, mws = make_mpc_step(
        X, jx.U, f, lambda t: jnp.concatenate([JSE2.rplus(base, t * vdes), vdes]),
        lambda t: jnp.zeros(2), dxdes=lambda t: jnp.concatenate([vdes, jnp.zeros(3)]),
        weights=MPCWeights(Q=jnp.eye(6), Qtf=0.1 * jnp.eye(6), R=jnp.eye(2)),
        params=MPCParams(K=8, tf=5.0, qp=JQPSolverParams(polish=False)),
        cr=lambda x, u: u, crl=jnp.array([-0.5, -0.5]), cru=jnp.array([0.5, 0.5]),
    )

    @jax.jit
    def body(x, mws, aws, t):
        m = mpc(mws, t, x)
        a = asif(aws, x, m.u)
        x = X.rplus(x, ex.DT * f(x, a.u))
        return x, m.warmstart, a.warmstart, (x, m.u, a.u, h(t, x)[0], m.status, a.status)

    x, rows = X.identity(), []
    for i in range(3):
        x, mws, aws, r = body(x, mws, aws, i * ex.DT)
        rows.append(r)
    want = [np.stack(v) for v in zip(*rows)]
    out = ex.run(3, 8, 10, **TORCH, asif_backend="torch")
    for k, w in zip(("xs", "u_mpc", "u_asif", "hs"), want[:4]):
        np.testing.assert_allclose(_np(out[k]), w, atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(_np(out["mpc_statuses"]), want[4])
    np.testing.assert_array_equal(_np(out["asif_statuses"]), want[5])


@functools.lru_cache(maxsize=None)
def _jax_asif_di(steps):
    """The JAX example's filtered loop (states, inputs, statuses)."""
    from examples_torch import asif_doubleintegrator as ex

    f = lambda x, u: jnp.stack([x[1], u[0]])
    step, ws = make_asif_step(
        JRn(2), JRn(1), f, lambda t, x: jnp.stack([x[0] + 0.5 * x[1]]),
        lambda t, x: jnp.array([1.0]),
        params=ASIFilterParams(T=3.0, asif=ASIFtoQPParams(K=30, alpha=2.0, dt=0.05)),
        ulim=JManifoldBounds(A=jnp.eye(1), c=jnp.zeros(1), l=jnp.array([-1.0]),
                             u=jnp.array([1.0])),
    )

    @jax.jit
    def body(x, ws):
        res = step(ws, x, jnp.array([-1.0]))
        return x + ex.DT * f(x, res.u), res.warmstart, res.u, res.status

    x, xs, us, st = jnp.array([2.0, 0.0]), [], [], []
    for _ in range(steps):
        x, ws, u, s = body(x, ws)
        xs.append(x), us.append(u), st.append(s)
    return np.asarray(xs), np.asarray(us), np.asarray(st)


@pytest.mark.parametrize("backend", ["torch", "lane"])
def test_asif_doubleintegrator_matches_jax(backend):
    """The filtered double integrator, 40 steps under u_des = -1: states,
    filtered inputs and statuses of the port's torch loop and of its lane
    route (the card's) within 1e-9 of the JAX example's loop."""
    from examples_torch import asif_doubleintegrator as ex

    xs, us, st = _jax_asif_di(40)
    out = ex.run(40, **CPU, backend=backend)
    np.testing.assert_allclose(_np(out["xs"]), xs, atol=1e-9)
    np.testing.assert_allclose(_np(out["us"]), us, atol=1e-9)
    np.testing.assert_array_equal(_np(out["statuses"]), st)


# ------------------------------------------------------------------ EKF


def test_ekf_se2_localization_matches_jax():
    """The SE(2) EKF, 40 steps on the JAX example's own noise draws: pose
    errors, the final estimate and the covariance trace within 1e-9."""
    from examples_torch import ekf_se2_localization as ex

    landmarks = jnp.array(ex.LANDMARKS)

    def meas(g):
        inv = JSE2.inverse(g)
        R = jnp.array([[inv[2], -inv[3]], [inv[3], inv[2]]])
        return (landmarks @ R.T + inv[:2]).ravel()

    twist = jnp.array(ex.TWIST)
    k, noise = jax.random.PRNGKey(0), []
    for _ in range(40):
        k, kn = jax.random.split(k)
        noise.append(0.03 * jax.random.normal(kn, (8,)))
    Q, R = 0.01 * jnp.eye(3), 0.001 * jnp.eye(8)

    @jax.jit
    def body(st, tp, nm):
        tp = JSE2.rplus(tp, ex.DT * twist)
        st = ekf_predict(JSE2, lambda t, g: twist, st, Q, ex.DT, n_steps=1)
        st = ekf_update(JSE2, meas, st, meas(tp) + nm, R)
        return st, tp, jnp.linalg.norm(JSE2.rminus(st.g, tp))

    st, tp, errs = ekf_reset(JSE2, JSE2.exp(jnp.array([0.5, -0.5, 0.3])), jnp.eye(3)), JSE2.identity(), []
    for nm in noise:
        st, tp, e = body(st, tp, nm)
        errs.append(e)
    out = ex.run(40, noise_draws=np.stack(noise), **CPU)
    np.testing.assert_allclose(_np(out["errs"]), np.asarray(errs), atol=1e-9)
    np.testing.assert_allclose(_np(out["g"]), np.asarray(st.g), atol=1e-9)
    np.testing.assert_allclose(float(out["trace_P"]), float(jnp.trace(st.P)), atol=1e-9)


def test_ekf_fleet_se2_matches_jax():
    """The SE(2) EKF fleet, B = 8, 40 steps, both filters, on the JAX
    example's own draws (its true poses, offsets and noise): every member's
    pose error after every step within 1e-9."""
    from examples_torch import ekf_fleet_se2 as ex, ekf_se2_localization as single

    B, steps = 8, 40
    key = jax.random.PRNGKey(0)
    k1, k2, key = jax.random.split(key, 3)
    v_true = jax.vmap(lambda k: 0.5 * jax.random.normal(k, (3,)))(jax.random.split(k1, B))
    offset = 0.4 * jax.random.normal(k2, (B, 3))
    k, noise = key, []
    for _ in range(steps):
        k, kn = jax.random.split(k)
        noise.append(0.03 * jax.random.normal(kn, (B, 8)))
    landmarks = jnp.array(single.LANDMARKS)

    def meas(g):
        inv = JSE2.inverse(g)
        R = jnp.array([[inv[2], -inv[3]], [inv[3], inv[2]]])
        return (landmarks @ R.T + inv[:2]).ravel()

    twist = jnp.array(ex.TWIST)
    Q, R = 0.01 * jnp.eye(3), 0.001 * jnp.eye(8)
    true0 = jax.vmap(JSE2.exp)(v_true)
    est0 = jax.vmap(JSE2.rplus)(true0, offset)
    want = {}
    for key_, (reset, predict, update) in (
            ("errs", (ekf_fleet_reset, ekf_fleet_predict, ekf_fleet_update)),
            ("errs_sqrt", (sqrt_ekf_fleet_reset, sqrt_ekf_fleet_predict, sqrt_ekf_fleet_update))):

        @jax.jit
        def body(fl, tp, nm, predict=predict, update=update):
            tp = jax.vmap(lambda g: JSE2.rplus(g, ex.DT * twist))(tp)
            fl = predict(JSE2, lambda t, g: twist, fl, Q, ex.DT, n_steps=1)
            fl = update(JSE2, meas, fl, jax.vmap(meas)(tp) + nm, R)
            return fl, tp, jnp.linalg.norm(jax.vmap(JSE2.rminus)(fl.g, tp), axis=-1)

        fl, tp, errs = reset(JSE2, est0), true0, []
        for nm in noise:
            fl, tp, e = body(fl, tp, nm)
            errs.append(e)
        want[key_] = np.stack(errs)
    out = ex.run(steps, B, fleet_draws=(np.array(v_true), np.array(offset), np.stack(noise)), **CPU)
    for k_, w in want.items():
        np.testing.assert_allclose(_np(out[k_]), w, atol=1e-9, err_msg=k_)


def test_pid_se2_matches_jax():
    """The SE(2) PID loop, 60 steps: tracking errors within 1e-10 of the JAX
    example's loop."""
    from examples_torch import pid_se2 as ex
    from smooth_feedback_tpu.controllers import PIDParams, pid_gains, pid_init, pid_step

    twist = jnp.array([0.4, 0.0, 0.3])
    gains, prm = pid_gains(JSE2, kp=2.0, kd=2.5, ki=0.2), PIDParams(windup_limit=1.0)
    dt = ex.PID_DT

    @jax.jit
    def body(x, v, st, t):
        u, st = pid_step(JSE2, prm, gains, st, t, x, v, JSE2.exp(t * twist), twist, jnp.zeros(3))
        v = v + dt * u
        x = JSE2.rplus(x, dt * v)
        return x, v, st, jnp.linalg.norm(JSE2.rminus(x, JSE2.exp((t + dt) * twist)))

    x, v, st, errs = JSE2.exp(jnp.array([1.0, -0.5, 0.8])), jnp.zeros(3), pid_init(JSE2), []
    for i in range(60):
        x, v, st, e = body(x, v, st, i * dt)
        errs.append(e)
    np.testing.assert_allclose(_np(ex.run(60, **CPU)["errs"]), np.asarray(errs), atol=1e-10)


def test_output_feedback_vehicle_run_is_the_checked_loop():
    """The example's ``run`` steps the loop tests/test_torch_output_feedback.py
    holds to the JAX example (``output_feedback_step`` on
    ``output_feedback_path``, the functions chip_smoke.py imports): 3 steps
    at K_mpc 8, K_asif 10 on given noise equal that loop stepped by hand."""
    from examples_torch import output_feedback_vehicle as ex

    nm = 0.03 * np.random.default_rng(1).standard_normal((3, 11))
    nw = 0.02 * np.random.default_rng(2).standard_normal((3, 6))
    out = ex.run(3, 8, 10, noise_draws=(nm, nw), **TORCH)
    p = cs.output_feedback_path("cpu", torch.float64, "torch", 8, 10)
    x, est = cs.output_feedback_start(p)
    mws, aws = p["mws"], p["aws"]
    for i in range(3):
        x, est, _, m, a = cs.output_feedback_step(p, i, x, est, mws, aws, torch.tensor(nm[i]),
                                                  torch.tensor(nw[i]))
        mws, aws = m.warmstart, a.warmstart
        np.testing.assert_allclose(_np(out["xs"][i]), _np(x), atol=1e-12)
        np.testing.assert_allclose(_np(out["us"][i]), _np(a.u), atol=1e-12)
    assert cs.OF_DT == ex.DT and float(out["err0"]) > 0.0


# --------------------------------------------------------- QP transcriptions


def _qp_case(port_problem, jax_problem, n_times, eps=1e-6):
    """solve_qp of the port's and the JAX package's transcription (eps 1e-6,
    max_iter 20000, polish): the QPs within 1e-10, status and iteration
    count equal, the primal within 1e-8, x(t) at ``n_times`` times."""
    ocp, mesh, tf, xl, ul, dxl = jax_problem
    qp = jax.jit(lambda: j_ocp_to_qp(ocp, mesh, tf, xl, ul, dxl))()
    sol = j_solve_qp(qp, JQPSolverParams(eps_abs=eps, eps_rel=eps, max_iter=20000))
    osol = j_qpsol_to_ocpsol(ocp, mesh, sol, tf, xl, ul)
    xs = np.stack([np.asarray(osol.x(jnp.asarray(t))) for t in np.linspace(0.0, tf, n_times)])
    out = port_problem()
    for a, b in zip(out["qp"], qp):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-10)
    assert int(out["sol"].status) == int(sol.status) == 0
    assert int(out["sol"].iters) == int(sol.iters)
    np.testing.assert_allclose(_np(out["sol"].primal), np.asarray(sol.primal), atol=1e-8)
    np.testing.assert_allclose(_np(out["xs"]), xs, atol=1e-8)
    return out, sol


def test_ocp_doubleintegrator_qp_matches_jax():
    from examples_torch import ocp_doubleintegrator_qp as ex
    from smooth_feedback_tpu.ocp import OCP

    ocp = OCP(
        X=JRn(2), U=JRn(1),
        theta=lambda tf, x0, xf, q: q[0] + 0.05 * (xf @ xf),
        f=lambda t, x, u: jnp.stack([x[1], u[0]]),
        g=lambda t, x, u: jnp.array([0.5 * (x @ x) + 0.05 * (u @ u)]),
        cr=lambda t, x, u: u, crl=jnp.array([-1.0]), cru=jnp.array([1.0]),
        ce=lambda tf, x0, xf, q: x0, cel=jnp.array([1.0, 0.0]), ceu=jnp.array([1.0, 0.0]),
    )
    problem = (ocp, JMesh.uniform(3, 4, Kmin=4, Kmax=4), 5.0, lambda t: jnp.zeros(2),
               lambda t: jnp.zeros(1), None)
    _qp_case(lambda: ex.run(3, **TORCH), problem, 11)


def test_ocp_se2_qp_matches_jax():
    """Also the deviation norm |primal| the example prints."""
    from examples_torch import ocp_se2_qp as ex

    jx = _jax_example("ocp_se2_qp")
    from smooth_feedback_tpu.ocp import OCP

    X = jx.X

    def g(t, x, u):
        e = X.rminus(x, jx.xdes(t))
        return jnp.array([0.5 * (e @ e + u @ u)])

    ocp = OCP(
        X=X, U=jx.U, theta=lambda tf, x0, xf, q: q[0],
        f=lambda t, x, u: jnp.stack([x[4], jnp.zeros(()), x[5], u[0], u[1]]), g=g,
        cr=lambda t, x, u: u, crl=jnp.array([-1.0, -1.0]), cru=jnp.array([1.0, 1.0]),
        ce=lambda tf, x0, xf, q: X.log(x0),
        cel=jnp.array([0.0, 0.0, 0.0, 1.0, 0.0]), ceu=jnp.array([0.0, 0.0, 0.0, 1.0, 0.0]),
    )
    problem = (ocp, JMesh.uniform(2, 5, Kmin=5, Kmax=5), 5.0, jx.xdes, lambda t: jnp.zeros(2),
               lambda t: jnp.concatenate([jx.vel, jnp.zeros(2)]))
    out, sol = _qp_case(lambda: ex.run(2, **TORCH), problem, 6)
    np.testing.assert_allclose(float(out["dev"]), float(jnp.linalg.norm(sol.primal)), atol=1e-8)


# ------------------------------------------------------------ refinement


def _nlp_at_a_point(port_nlp, jax_nlp, seed):
    """f, g, grad f and the Jacobian of g at one point (the NLP's initial
    guess plus a seeded perturbation), one JAX program: within 1e-9."""
    z = np.random.default_rng(seed).standard_normal(jax_nlp.n) * 0.1
    jf = jax.jit(lambda x: (jax_nlp.f(x), jax_nlp.g(x), jax.grad(jax_nlp.f)(x),
                            jax.jacrev(jax_nlp.g)(x)))
    want = jf(jnp.asarray(z))
    zt = torch.tensor(z)
    got = (port_nlp.f(zt), port_nlp.g(zt), torch.func.grad(port_nlp.f)(zt),
           torch.func.jacrev(port_nlp.g)(zt))
    assert (port_nlp.n, port_nlp.m) == (jax_nlp.n, jax_nlp.m)
    for a, b, name in zip(got, want, ("f", "g", "grad f", "jac g")):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-9, rtol=1e-9, err_msg=name)
    for a, b in zip((port_nlp.xl, port_nlp.xu, port_nlp.gl, port_nlp.gu),
                    (jax_nlp.xl, jax_nlp.xu, jax_nlp.gl, jax_nlp.gu)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_ocp_se3_nlp_flat_nlp_matches_jax():
    """The SE(3) x R^3 fleet member's flat NLP on a two-interval mesh (the
    example's Mesh() refined once), at one point: the JAX example's
    ``make_flat``."""
    from examples_torch import ocp_se3_nlp as ex
    from smooth_feedback_tpu_torch.ocp import ocp_to_nlp
    from smooth_feedback_tpu_torch.ocp.collocation import Mesh

    jx = _jax_example("ocp_se3_nlp")
    twist = np.array([0.55, -0.05, 0.12, 0.02, -0.03, 0.31])
    make_flat = ex.flat_factory(torch.float64, "cpu")
    _nlp_at_a_point(ocp_to_nlp(make_flat(torch.tensor(twist)), Mesh.uniform(2, 5), torch.float64,
                               "cpu"),
                    j_ocp_to_nlp(jx.make_flat(jnp.asarray(twist)), JMesh.uniform(2, 5)), 3)


def test_ocp_se3_nlp_fleet_run():
    """The port's SE(3) fleet at B = 2, one pass (SMOKE_KWARGS), float64 on
    the torch loop: every member Optimal, its KKT residual recomputed in
    float64 within the SQP's 1e-7, the mesh the one solved on, member 0's
    start at the identity with its screw's speeds."""
    from examples_torch import ocp_se3_nlp as ex
    from smooth_feedback_tpu_torch.ocp import ocp_to_nlp

    out = ex.run(1e-2, 1, 2, **TORCH)
    info, mesh = out["info"], out["mesh"]
    assert bool((info.statuses == 0).all()) and len(info.meshes) == 1
    assert (mesh.N_ivals, mesh.N_colloc) == (info.meshes[0].N_ivals, info.meshes[0].N_colloc)
    make_flat = ex.flat_factory(torch.float64, "cpu")
    kkt = cs.nlp_kkt_f64(lambda th: ocp_to_nlp(make_flat(th), mesh, torch.float64, "cpu"),
                         out["twists"], out["nlpsol"])
    assert float(kkt.max()) <= 1e-7, kkt
    x0 = _np(out["xs"][0])
    np.testing.assert_allclose(x0[:6], 0.0, atol=1e-7)
    np.testing.assert_allclose(x0[6:], _np(out["twists"][0, :3]), atol=1e-7)


@pytest.mark.parametrize("name", ["ocp_se2_nlp", "ocp_doubleintegrator_nlp"])
def test_single_ocp_nlp_matches_jax_and_runs(name):
    """The single refinement examples: the flat NLP on Mesh() at one point
    against the JAX example's ``flatten_ocp`` of its OCP; then the port's
    run at SMOKE_KWARGS (target 1e-2, one pass) on the torch loop: Optimal,
    the error within the target, the ends the OCP fixes held to 1e-6."""
    ex = importlib.import_module(f"examples_torch.{name}")
    jx = _jax_example(name)
    from smooth_feedback_tpu_torch.ocp import flatten_ocp, ocp_to_nlp
    from smooth_feedback_tpu_torch.ocp.collocation import Mesh

    if name == "ocp_se2_nlp":
        ocp, xl, ul = ex.ocp_example(torch.float64, "cpu")
        jflat = j_flatten_ocp(jx.make_ocp(), lambda t: jx.X.identity(), lambda t: jnp.full(2, 0.01))
        ends = [(0.0, (0.0, 0.0, 1.0, 0.0, 1.0, 0.0))]
    else:
        ocp = ex.make_ocp(torch.float64, "cpu")
        z2, z1 = torch.zeros(2, dtype=torch.float64), torch.zeros(1, dtype=torch.float64)
        xl, ul = (lambda t: z2), (lambda t: z1)
        jflat = j_flatten_ocp(jx.make_ocp(), lambda t: jnp.zeros(2), lambda t: jnp.zeros(1))
        ends = [(0.0, (1.0, 1.0)), (5.0, (0.1, 0.0))]
    _nlp_at_a_point(ocp_to_nlp(flatten_ocp(ocp, xl, ul), Mesh(), torch.float64, "cpu"),
                    j_ocp_to_nlp(jflat, JMesh()), 5)
    out = ex.run(1e-2, 1, **TORCH)
    info = out["info"]
    assert info.status == 0 and len(info.meshes) == 1 and info.errors[-1] <= 1e-2
    for t, want in ends:
        got = out["sol"].x(torch.tensor(t, dtype=torch.float64))
        np.testing.assert_allclose(_np(got), want, atol=1e-6)
