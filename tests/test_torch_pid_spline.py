"""The PyTorch port's PID controller and Lie-group splines against the JAX
package, on the CPU (float64).

PID: the windup, first-call and tracking cases of tests/test_pid.py, with
the inputs made by numpy from a seed and handed to both packages, u within
1e-12; and examples/pid_se2.py's closed loop at 300 steps.  Splines: fits
with c2 False and True on SE(2) and SO(3) knots, positions, body velocities
and body accelerations within 1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smooth_feedback_tpu.controllers as jc
import smooth_feedback_tpu_torch.controllers as tc
from smooth_feedback_tpu.groups import SE2 as JSE2
from smooth_feedback_tpu.groups import SO3 as JSO3
from smooth_feedback_tpu.utils import spline as jsp
from smooth_feedback_tpu_torch.groups import SE2, SO3
from smooth_feedback_tpu_torch.utils import spline as tsp

torch.set_num_threads(1)

KW = dict(dtype=torch.float64, device="cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a), **KW)


def _close(got, ref, tol=1e-12, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=tol, rtol=0, err_msg=msg)


@pytest.mark.parametrize("case", ["windup", "first-call", "tracking"])
def test_pid_matches_jax(case):
    """The controller's u (and integral state) equal the JAX package's
    within 1e-12 (f64): the windup clamp (1 s of large error clamped at
    0.05); the first call, which skips the integral (t_last = nan), then
    calls that accumulate it and reset_integral clearing it (PID class);
    the tracking law with all three gains."""
    rng = np.random.default_rng({"windup": 0, "first-call": 1, "tracking": 2}[case])
    z = np.zeros(3)
    if case == "windup":
        jg, tg = jc.pid_gains(JSE2, kp=0.0, kd=0.0, ki=1.0), tc.pid_gains(SE2, 0.0, 0.0, 1.0, **KW)
        prm_j, prm_t = jc.PIDParams(windup_limit=0.05), tc.PIDParams(windup_limit=0.05)
        js, ts = jc.pid_init(JSE2), tc.pid_init(SE2, **KW)
        xd = np.array([10.0, 0.0, 1.0, 0.0])  # SE2.exp([10, 0, 0])
        for t in (0.0, 1.0, 1.5):
            ju, js = jc.pid_step(JSE2, prm_j, jg, js, t, JSE2.identity(), z, xd, z, z)
            tu, ts = tc.pid_step(SE2, prm_t, tg, ts, t, SE2.identity(**KW), _t(z), _t(xd),
                                 _t(z), _t(z))
            _close(tu, ju)
            _close(ts.i_err, js.i_err)
        assert float(ts.i_err.abs().max()) <= 0.05 + 1e-12
    elif case == "first-call":
        jpid, tpid = jc.PID(JSE2), tc.PID(SE2, **KW)
        for pid in (jpid, tpid):
            pid.set_kp(1.0), pid.set_kd(0.5), pid.set_ki(2.0)
        assert bool(torch.isnan(tpid.state.t_last))
        for t in (5.0, 6.0, 7.0, 8.0, "reset", 9.0):
            if t == "reset":
                jpid.reset_integral(), tpid.reset_integral()
                continue
            x = np.asarray(JSE2.exp(jnp.asarray(rng.standard_normal(3))))
            v = rng.standard_normal(3)
            _close(tpid(t, _t(x), _t(v)), jpid(t, jnp.asarray(x), jnp.asarray(v)), msg=str(t))
            _close(tpid.state.i_err, jpid.state.i_err)
    else:
        xd, x = (np.asarray(JSE2.exp(jnp.asarray(rng.standard_normal(3)))) for _ in range(2))
        vd, ad, v = (rng.standard_normal(3) for _ in range(3))
        jg = jc.pid_gains(JSE2, kp=2.0, kd=3.0, ki=0.5)
        tg = tc.pid_gains(SE2, kp=2.0, kd=3.0, ki=0.5, **KW)
        js, ts = jc.pid_init(JSE2), tc.pid_init(SE2, **KW)
        for t in (1.0, 1.2):
            ju, js = jc.pid_step(JSE2, jc.PIDParams(), jg, js, t, x, v, xd, vd, ad)
            tu, ts = tc.pid_step(SE2, tc.PIDParams(), tg, ts, t, *(_t(a) for a in (x, v, xd, vd, ad)))
            _close(tu, ju)
        expected = ad + 3.0 * (vd - v) + 2.0 * np.asarray(JSE2.rminus(xd, x))
        _close(tc.pid_step(SE2, tc.PIDParams(), tg, tc.pid_init(SE2, **KW), 1.0,
                           *(_t(a) for a in (x, v, xd, vd, ad)))[0], expected)


def test_pid_closed_loop_matches_jax():
    """examples/pid_se2.py's closed loop (kp 2, kd 2.5, ki 0.2, windup 1,
    dt = 0.01, a screw reference) for 300 steps: the tracking errors of the
    port equal the JAX package's within 1e-10 (f64) at every step, and
    shrink."""
    steps, dt = 300, 0.01
    twist = np.array([0.4, 0.0, 0.3])
    jgains, jprm = jc.pid_gains(JSE2, kp=2.0, kd=2.5, ki=0.2), jc.PIDParams(windup_limit=1.0)

    @jax.jit
    def rollout(x0):
        tw = jnp.asarray(twist)

        def body(carry, i):
            x, v, st = carry
            t = i * dt
            u, st = jc.pid_step(JSE2, jprm, jgains, st, t, x, v, JSE2.exp(t * tw), tw, jnp.zeros(3))
            v = v + dt * u
            x = JSE2.rplus(x, dt * v)
            return (x, v, st), JSE2.rminus(x, JSE2.exp((t + dt) * tw))

        return jax.lax.scan(body, (x0, jnp.zeros(3), jc.pid_init(JSE2)), jnp.arange(steps))[1]

    x0 = np.asarray(JSE2.exp(jnp.array([1.0, -0.5, 0.8])))
    ref = np.asarray(rollout(jnp.asarray(x0)))
    tgains = tc.pid_gains(SE2, kp=2.0, kd=2.5, ki=0.2, **KW)
    tprm, tw = tc.PIDParams(windup_limit=1.0), _t(twist)
    x, v, st, errs = _t(x0), torch.zeros(3, **KW), tc.pid_init(SE2, **KW), []
    for i in range(steps):
        t = torch.tensor(i * dt, **KW)
        u, st = tc.pid_step(SE2, tprm, tgains, st, t, x, v, SE2.exp(t * tw), tw, torch.zeros(3, **KW))
        v = v + dt * u
        x = SE2.rplus(x, dt * v)
        errs.append(SE2.rminus(x, SE2.exp((t + dt) * tw)))
    errs = torch.stack(errs).numpy()
    _close(errs, ref, tol=1e-10)
    norms = np.linalg.norm(errs, axis=1)
    assert norms[-1] < 0.5 * norms[0]


GROUPS = {"SE2": (SE2, JSE2), "SO3": (SO3, JSO3)}
TS = [0.0, 0.7, 1.5, 2.0, 3.1]
TIMES = [0.3, 0.7, 1.2, 1.99, 3.05, 3.5]  # interior, at a knot, past the end


@functools.lru_cache(maxsize=None)
def _knots(name):
    G, J = GROUPS[name]
    vs = 0.5 * np.random.default_rng(len(name) + G.ndof).standard_normal((len(TS), G.ndof))
    return np.asarray(jax.vmap(J.exp)(jnp.asarray(vs)))


@pytest.mark.parametrize("c2", [False, True], ids=["c1", "c2"])
@pytest.mark.parametrize("name", ["SE2", "SO3"])
def test_spline_matches_jax(name, c2):
    """fit_spline (Catmull-Rom knot velocities, or the Newton solve on the
    acceleration jumps) and spline_eval on 5 knots: the fitted segment
    data, and position, body velocity and body acceleration at interior
    times, at a knot and past the last knot, within 1e-9 of the JAX
    package's (f64).  With c2 the acceleration is continuous at interior
    knots.

    Deliberate divergence at exactly the first and last knot time: JAX
    clamps t with jnp.clip, whose derivative at a tie is 1/2, so its
    velocity there is half the spline's and its acceleration a quarter; the
    port's clamp passes the derivative whole, so it returns the one-sided
    limit from inside the interval (checked against t = ts[0] + 1e-12)."""
    G, J = GROUPS[name]
    gs = _knots(name)
    if c2:  # a host Newton loop: not jittable
        jspl = jsp.fit_spline(J, TS, jnp.asarray(gs), c2=True)
    else:
        jspl = jax.jit(lambda g: jsp.fit_spline(J, TS, g, c2=False))(jnp.asarray(gs))
    tspl = tsp.fit_spline(G, TS, _t(gs), c2=c2)
    for a, b in zip(tspl[1:], jspl[1:]):
        _close(a, b, tol=1e-9)
    jeval = jax.jit(lambda t: jsp.spline_eval(J, jspl, t))
    for t in TIMES:
        for what, a, b in zip(("g", "v", "a"), tsp.spline_eval(G, tspl, t), jeval(t)):
            _close(a, b, tol=1e-9, msg=f"{what} at {t}")
    if c2:
        for k in (1, 3):
            left = tsp.spline_eval(G, tspl, TS[k] - 1e-9)[2]
            right = tsp.spline_eval(G, tspl, TS[k] + 1e-9)[2]
            _close(left, right, tol=1e-6, msg=f"acceleration jump at knot {k}")
    g0, v0, a0 = tsp.spline_eval(G, tspl, TS[0])
    _, v_in, a_in = tsp.spline_eval(G, tspl, TS[0] + 1e-12)
    _close(v0, v_in, tol=1e-9)
    _close(a0, a_in, tol=1e-9)
    _, jv0, ja0 = jeval(TS[0])
    _close(0.5 * v0, jv0, tol=1e-9)
    _close(0.25 * a0, ja0, tol=1e-9)
    _close(g0, gs[0], tol=1e-12)
