"""The rest of the port's MPC against the JAX package, on the CPU: the ``MPC``
class, ``time_varying`` dynamics and constraints, and the sparse
common-clock fleet step ``step.fleet_shared_t`` (mirrors of
tests/test_mpc.py's ``test_mpc_class_api``, ``test_time_varying_cr`` and
``test_fleet_shared_t_se2_matches_fleet``).

States come from numpy with a seed and go to both packages; both run
float64, JAX on "xla", the port on "torch".
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from smooth_feedback_tpu.controllers import MPC as JMPC
from smooth_feedback_tpu.controllers import MPCParams as JMPCParams
from smooth_feedback_tpu.controllers import MPCWeights as JMPCWeights
from smooth_feedback_tpu.controllers import make_mpc_step as j_make_mpc_step
from smooth_feedback_tpu.groups import SE2 as JSE2
from smooth_feedback_tpu.groups import Rn as JRn
from smooth_feedback_tpu.qp import QPSolverParams as JQPSolverParams
from smooth_feedback_tpu_torch import convert
from smooth_feedback_tpu_torch.controllers import MPC, MPCParams, default_weights, make_mpc_step
from smooth_feedback_tpu_torch.groups import SE2, Rn
from smooth_feedback_tpu_torch.qp import QPSolutionStatus, QPSolverParams

torch.set_num_threads(1)

weights_from_numpy = functools.partial(convert.weights_from_numpy, device="cpu")
f64 = dict(dtype=torch.float64, device="cpu")


def test_mpc_class_matches_jax():
    """The MPC class on SE(2) with an input box and default solver
    parameters (polish on), holding its warm start over three calls with
    nothing set (identity reference, default weights): statuses Optimal and
    u within 1e-9 of JAX's MPC class at every call (f64).  Then new weights
    and references (relative time, body velocity by autodiff): the class
    equals make_mpc_step built with the same settings and carried by hand,
    exactly; reset_warmstart zeroes the carry."""
    f = lambda x, u: torch.stack([u[0], torch.zeros_like(u[0]), u[1]])
    jm = JMPC(JSE2, JRn(2), lambda x, u: jnp.stack([u[0], jnp.zeros(()), u[1]]),
              params=JMPCParams(K=8, tf=2.0), cr=lambda x, u: u, crl=-jnp.ones(2), cru=jnp.ones(2),
              dtype=jnp.float64)
    box = dict(cr=lambda x, u: u, crl=[-1.0, -1.0], cru=[1.0, 1.0])
    tm = MPC(SE2, Rn(2), f, params=MPCParams(K=8, tf=2.0), **box, **f64)
    for w, d in zip(tm.weights, default_weights(SE2, Rn(2), **f64)):
        np.testing.assert_array_equal(w.numpy(), d.numpy())
    x = SE2.exp(torch.as_tensor([0.2, -0.1, 0.3], dtype=torch.float64))
    for t in (1.0, 1.1, 1.2):
        ju, jst = jm(t, jnp.asarray(x.numpy()))
        tu, tst = tm(t, x)
        assert tst == jst == QPSolutionStatus.Optimal
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-9, rtol=0)
        np.testing.assert_allclose(tm._ws.primal.numpy(), np.asarray(jm._ws.primal), atol=1e-9)
        x = SE2.rplus(x, 0.1 * f(x, tu))

    W = (np.eye(3), 2.0 * np.eye(3), 0.5 * np.eye(2))
    twist = torch.tensor([1.0, 0.0, 1.0], dtype=torch.float64)
    tm.set_weights(weights_from_numpy(W))
    tm.set_udes(lambda t: 0.5 * torch.ones(2, dtype=torch.float64))
    tm.set_xdes_rel(lambda t: SE2.exp(t * twist), t0=1.5)
    tm.reset_warmstart()
    assert all(bool((a == 0).all()) for a in tm._ws)
    step, ws = make_mpc_step(
        SE2, Rn(2), f, lambda t: SE2.exp((t - 1.5) * twist),
        lambda t: 0.5 * torch.ones(2, dtype=torch.float64), weights=weights_from_numpy(W),
        params=MPCParams(K=8, tf=2.0), **box, **f64,
    )
    for t in (2.0, 2.1):
        tu, tst = tm(t, x)
        r = step(ws, t, x)
        ws = r.warmstart
        assert tst == int(r.status) == QPSolutionStatus.Optimal
        torch.testing.assert_close(tu, r.u, rtol=0, atol=0)
        assert tm.last_result.u is tu


def _di_time_varying(K=8):
    """tests/test_mpc.py's time-windowed input freeze: cr(t, x, u) =
    win(t) u in [-1, 1], win = 100 for t in [1, 2] (|u| <= 0.01), else 1."""
    win_j = lambda t: jnp.where((t >= 1.0) & (t <= 2.0), 100.0, 1.0)
    jstep, jws = j_make_mpc_step(
        JRn(2), JRn(1), lambda t, x, u: jnp.stack([x[1], (1.0 + 0.5 * jnp.sin(0.7 * t)) * u[0]]),
        lambda t: jnp.stack([-0.5 * jnp.sin(0.3 * t), -0.15 * jnp.cos(0.3 * t)]),
        lambda t: jnp.zeros(1),
        weights=JMPCWeights(Q=jnp.eye(2), Qtf=0.1 * jnp.eye(2), R=0.01 * jnp.eye(1)),
        params=JMPCParams(K=K, tf=2.0, qp=JQPSolverParams(polish=False)),
        cr=lambda t, x, u: win_j(t) * u, crl=jnp.array([-1.0]), cru=jnp.array([1.0]),
        time_varying=True,
    )
    win_t = lambda t: torch.where((t >= 1.0) & (t <= 2.0), 100.0, 1.0).to(t.dtype)
    tstep, tws = make_mpc_step(
        Rn(2), Rn(1), lambda t, x, u: torch.stack([x[1], (1.0 + 0.5 * torch.sin(0.7 * t)) * u[0]]),
        lambda t: torch.stack([-0.5 * torch.sin(0.3 * t), -0.15 * torch.cos(0.3 * t)]),
        lambda t: torch.zeros(1, dtype=torch.float64),
        weights=weights_from_numpy((np.eye(2), 0.1 * np.eye(2), 0.01 * np.eye(1))),
        params=MPCParams(K=K, tf=2.0, qp=QPSolverParams(polish=False)),
        cr=lambda t, x, u: win_t(t) * u, crl=[-1.0], cru=[1.0], time_varying=True, **f64,
    )
    return (jstep, jws), (tstep, tws)


def test_time_varying_matches_jax():
    """time_varying=True: f(t, x, u) with a time-varying input gain and
    cr(t, x, u) with a time window.  Before the window u is free, inside it
    |u| <= 0.0101; the QPs (P, q, A, l, u) within 1e-12 of JAX's
    transcription, statuses and iterations equal, u within 1e-9 (f64);
    reuse_factors is refused as in JAX."""
    (jstep, jws), (tstep, tws) = _di_time_varying()
    x = np.array([1.0, 0.0])
    jfn = jax.jit(lambda t: (jstep(jws, t, jnp.asarray(x)), jstep.transcribe(t, jnp.asarray(x))))
    for t in (0.0, 1.2):
        (jr, jqp) = jfn(t)
        tqp = tstep.transcribe(t, torch.as_tensor(x))
        for name, a, b in zip("PqAlu", tqp, jqp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=0, err_msg=name)
        tr = tstep(tws, t, torch.as_tensor(x))
        assert int(tr.status) == int(jr.status) == QPSolutionStatus.Optimal
        assert int(tr.warmstart.iters) == int(jr.warmstart.iters)
        np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), atol=1e-9, rtol=0)
        if t > 1.0:
            assert abs(float(tr.u[0])) <= 0.0101
        else:
            assert abs(float(tr.u[0])) > 0.05
    try:
        make_mpc_step(Rn(2), Rn(1), lambda t, x, u: x, lambda t: x, lambda t: x,
                      weights=weights_from_numpy((np.eye(2), np.eye(2), np.eye(1))),
                      time_varying=True, reuse_factors=True, **f64)
    except ValueError as e:
        assert "reuse_factors" in str(e)
    else:
        raise AssertionError("time_varying with reuse_factors was accepted")


TWIST = np.array([0.5, 0.0, 0.3])


def test_sparse_fleet_shared_t_matches_jax():
    """The sparse common-clock fleet step on SE(2), exact for a
    non-commutative state: against JAX's fleet_shared_t (default solver
    parameters, polish on), statuses and iterations equal, u and primal
    within 1e-9 (f64); against the port's own per-member fleet step at the
    same clock, u and primal within 1e-6 (the two QPs differ in their
    initial-condition rows, not in their solution; each is polished to it).
    (The reuse_factors variant, on the template's shared factors, is held
    against the per-member fleet in test_torch_mpc.py.)"""
    tw_j, tw_t = jnp.asarray(TWIST), torch.as_tensor(TWIST)
    W = (np.eye(3), 5 * np.eye(3), 0.1 * np.eye(2))
    jstep, jws0 = j_make_mpc_step(
        JSE2, JRn(2), lambda x, u: jnp.stack([u[0], jnp.zeros(()), u[1]]),
        lambda t: JSE2.exp(t * tw_j), lambda t: jnp.stack([tw_j[0], tw_j[2]]), dxdes=lambda t: tw_j,
        weights=JMPCWeights(*(jnp.asarray(w) for w in W)),
        params=JMPCParams(K=8, tf=3.0),
    )
    tstep, tws0 = make_mpc_step(
        SE2, Rn(2), lambda x, u: torch.stack([u[0], torch.zeros_like(u[0]), u[1]]),
        lambda t: SE2.exp(t * tw_t), lambda t: torch.stack([tw_t[0], tw_t[2]]), dxdes=lambda t: tw_t,
        weights=weights_from_numpy(W), params=MPCParams(K=8, tf=3.0), **f64,
    )
    B, t = 4, 0.7
    offs = 0.4 * np.random.default_rng(4).standard_normal((B, 3))
    xs = torch.stack([SE2.rplus(SE2.exp(t * tw_t), torch.as_tensor(o)) for o in offs])
    jw = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jws0)
    tw = type(tws0)(*(a.expand((B,) + a.shape) for a in tws0))
    jr = jax.jit(jstep.fleet_shared_t)(jw, t, jnp.asarray(xs.numpy()))
    tr = tstep.fleet_shared_t(tw, t, xs)
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.warmstart.iters.numpy(), np.asarray(jr.warmstart.iters))
    assert bool((tr.status == QPSolutionStatus.Optimal).all())
    for a, b in ((tr.u, jr.u), (tr.warmstart.primal, jr.warmstart.primal), (tr.x_traj, jr.x_traj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9, rtol=0)
    tf = tstep.fleet(tw, torch.full((B,), t, dtype=torch.float64), xs)
    np.testing.assert_allclose(tr.u.numpy(), tf.u.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tr.warmstart.primal.numpy(), tf.warmstart.primal.numpy(), atol=1e-6)
