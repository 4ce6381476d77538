"""The PyTorch port's sparse MPC paths on SE(2) against the JAX package, on the
CPU: the README Quickstart's vehicle, transcribed per member and solved on
per-member clocks (``step.fleet``).

Clocks, states and noise come from numpy with a seed and go to both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from smooth_feedback_tpu.controllers import MPCParams as JMPCParams
from smooth_feedback_tpu.controllers import MPCWeights as JMPCWeights
from smooth_feedback_tpu.controllers import make_mpc_step as j_make_mpc_step
from smooth_feedback_tpu.groups import SE2 as JSE2
from smooth_feedback_tpu.groups import Rn as JRn
from smooth_feedback_tpu.qp import QPSolverParams as JQPSolverParams
from smooth_feedback_tpu_torch import convert
from smooth_feedback_tpu_torch.controllers import MPCParams, make_mpc_step
from smooth_feedback_tpu_torch.groups import SE2, Rn
from smooth_feedback_tpu_torch.qp import QPSolutionStatus, QPSolverParams, admm_iterate_cuda

torch.set_num_threads(1)

# the port's entry points default to the card; these tests run on the CPU
solution_from_numpy = functools.partial(convert.solution_from_numpy, device="cpu")
weights_from_numpy = functools.partial(convert.weights_from_numpy, device="cpu")

TWIST = np.array([0.5, 0.0, 0.3])
WEIGHTS = (np.eye(3), 5 * np.eye(3), 0.1 * np.eye(2))
FLEET_QP = dict(polish=False, stop_check_iter=10)
DT = 0.05


def _jax_vehicle(qp, K=8, dtype=jnp.float64, **kw):
    tw = jnp.asarray(TWIST, dtype)
    return j_make_mpc_step(
        JSE2, JRn(2), lambda x, u: jnp.stack([u[0], jnp.zeros((), u.dtype), u[1]]),
        xdes=lambda t: JSE2.exp(t * tw), udes=lambda t: jnp.stack([tw[0], tw[2]]),
        weights=JMPCWeights(*(jnp.asarray(w, dtype) for w in WEIGHTS)),
        params=JMPCParams(K=K, tf=3.0, qp=qp), dtype=dtype, **kw,
    )


def _torch_vehicle(qp, K=8, dtype=torch.float64, **kw):
    tw = torch.as_tensor(TWIST, dtype=dtype)
    return make_mpc_step(
        SE2, Rn(2), lambda x, u: torch.stack([u[0], torch.zeros_like(u[0]), u[1]]),
        lambda t: SE2.exp(t * tw), lambda t: torch.stack([tw[0], tw[2]]),
        weights=weights_from_numpy(WEIGHTS, dtype=dtype),
        params=MPCParams(K=K, tf=3.0, qp=qp), dtype=dtype, device="cpu", **kw,
    )


def _fleet_states(seed, B):
    """Clocks ~ U(0, 10) and states xdes(t) (+) 0.3 N(0, I3), as numpy."""
    rng = np.random.default_rng(seed)
    ts = rng.uniform(0.0, 10.0, B)
    noise = 0.3 * rng.standard_normal((B, 3))
    xs = np.stack([np.asarray(JSE2.rplus(JSE2.exp(t * jnp.asarray(TWIST)), jnp.asarray(e)))
                   for t, e in zip(ts, noise)])
    return ts, xs


def test_se2_transcription_matches_jax_f64():
    """ocp_to_qp of the SE(2) tracking OCP at K=8 (the non-commutative
    ad-correction included) gives P, q, A, l and u within 1e-12 of JAX (f64),
    at states on and off the reference; ocp_to_qp_vectors gives its q, l, u
    and the vmap'd transcription its QPs, member by member."""
    jstep, jws0 = _jax_vehicle(JQPSolverParams(**FLEET_QP))
    tstep, tws0 = _torch_vehicle(QPSolverParams(**FLEET_QP))
    assert tws0.primal.shape == jws0.primal.shape and tws0.dual.shape == jws0.dual.shape
    ts, xs = _fleet_states(3, 3)
    xs[0] = np.asarray(JSE2.exp(ts[0] * jnp.asarray(TWIST)))  # on the reference
    for t, x in zip(ts, xs):
        jqp = jax.jit(jstep.transcribe)(t, jnp.asarray(x))
        tqp = tstep.transcribe(t, torch.as_tensor(x))
        for name in ("P", "q", "A", "l", "u"):
            np.testing.assert_allclose(getattr(tqp, name).numpy(), np.asarray(getattr(jqp, name)),
                                       atol=1e-12, rtol=0, err_msg=name)
        tv = tstep.transcribe_vectors(t, torch.as_tensor(x))
        for a, b in zip(tv, (tqp.q, tqp.l, tqp.u)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-15)
    # the fleet transcribes under vmap: the same QPs member by member
    tqps = vmap(tstep.transcribe)(torch.as_tensor(ts), torch.as_tensor(xs))
    one = tstep.transcribe(ts[2], torch.as_tensor(xs[2]))
    for a, b in zip(tqps, one):
        torch.testing.assert_close(a[2], b, rtol=0, atol=1e-15)


def _closed_loop(j_fleet, t_fleet, jws0, tws0, seed, B, steps, on_step):
    """Both fleets ``steps`` closed-loop steps on per-member clocks (x <- x
    (+) dt f(x, u), t <- t + dt), each from its own warm-start carry."""
    ts, xs = _fleet_states(seed, B)
    dt_t = tws0.primal.dtype
    jws = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jws0)
    tws = type(tws0)(*(a.expand((B,) + a.shape).contiguous() for a in tws0))
    jx, jt = jnp.asarray(xs, jws.primal.dtype), jnp.asarray(ts, jws.primal.dtype)
    tx, tt = torch.as_tensor(xs, dtype=dt_t), torch.as_tensor(ts, dtype=dt_t)
    f_j = lambda x, u: jnp.stack([u[0], jnp.zeros((), u.dtype), u[1]])
    f_t = lambda x, u: torch.stack([u[0], torch.zeros_like(u[0]), u[1]])
    for i in range(steps):
        jr = j_fleet(jws, jt, jx)
        tr = t_fleet(tws, tt, tx)
        on_step(i, jr, tr)
        jx = jax.vmap(lambda x, u: JSE2.rplus(x, DT * f_j(x, u)))(jx, jr.u)
        tx = vmap(lambda x, u: SE2.rplus(x, DT * f_t(x, u)))(tx, tr.u)
        jt, tt = jt + DT, tt + DT
        jws, tws = jr.warmstart, tr.warmstart


def test_fleet_per_member_clocks_f64():
    """step.fleet end to end in f64 at K=8, B=4, two closed-loop steps (a cold
    start, then a step from the carried warm start):
    the port on "torch" against JAX on "xla": statuses and iterations equal
    at every step, u within 1e-9 (f64, summation order only); the
    single-controller step is the fleet step at B = 1."""
    jstep, jws0 = _jax_vehicle(JQPSolverParams(**FLEET_QP))
    tstep, tws0 = _torch_vehicle(QPSolverParams(**FLEET_QP))

    def check(i, jr, tr):
        np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
        np.testing.assert_array_equal(tr.warmstart.iters.numpy(), np.asarray(jr.warmstart.iters))
        np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), atol=1e-9, rtol=0)
        np.testing.assert_allclose(tr.x_traj.numpy(), np.asarray(jr.x_traj), atol=1e-9, rtol=0)
        assert bool((tr.status == QPSolutionStatus.Optimal).all())

    _closed_loop(jax.jit(jstep.fleet), tstep.fleet, jws0, tws0, 0, 4, 2, check)

    ts, xs = _fleet_states(1, 1)
    x, t = torch.as_tensor(xs[0]), float(ts[0])
    r1 = tstep(tws0, t, x)
    rB = tstep.fleet(type(tws0)(*(a[None] for a in tws0)), torch.tensor([t], dtype=torch.float64),
                     x[None])
    torch.testing.assert_close(r1.u, rB.u[0], rtol=0, atol=0)
    assert int(r1.status) == int(rB.status[0]) and r1.x_traj.shape == rB.x_traj.shape[1:]


def test_fleet_per_member_clocks_f32_kernel_backend():
    """step.fleet in f32 at K=8, B=4, two closed-loop steps (a cold start,
    then a step from the carried warm start): JAX on
    "pallas" (the per-problem Pallas kernel in interpret mode) against the
    port on "cuda", whose per-problem wrapper runs the kernel's plain version
    on CPU tensors (no launch).  Statuses equal at every step; u within
    5e-4, not 1e-4, for a reason this test also checks: the JAX side
    transcribes in f64 before casting to f32, the port in f32, and every row
    of the QP is an equality at rho = 100, which magnifies the QPs' one-ulp
    differences in the solve.  So at the first step each f32 u is held
    within 2.5e-4 of the exact answer (the port's f64 u, equal to JAX's
    within 1e-9 in the f64 test) instead."""
    jstep, jws0 = _jax_vehicle(JQPSolverParams(**FLEET_QP, backend="pallas"), dtype=jnp.float32)
    tstep, tws0 = _torch_vehicle(QPSolverParams(**FLEET_QP, backend="cuda"), dtype=torch.float32)
    n_opt = []

    def check(i, jr, tr):
        np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
        np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), atol=5e-4, rtol=0)
        n_opt.append(int((tr.status == QPSolutionStatus.Optimal).sum()))
        if i == 0:
            first.extend([np.asarray(jr.u), tr.u.numpy()])

    first = []
    admm_iterate_cuda.launches = 0
    _closed_loop(jax.jit(jstep.fleet), tstep.fleet, jws0, tws0, 2, 4, 2, check)
    assert admm_iterate_cuda.launches == 0
    assert sum(n_opt) == 8

    t64, tws64 = _torch_vehicle(QPSolverParams(**FLEET_QP))
    ts, xs = _fleet_states(2, 4)
    tws = type(tws64)(*(a.expand((4,) + a.shape) for a in tws64))
    u64 = t64.fleet(tws, torch.as_tensor(ts), torch.as_tensor(xs)).u.numpy()
    for u32 in first:
        np.testing.assert_allclose(u32, u64, atol=2.5e-4, rtol=0)


def test_reuse_factors_sparse_f64():
    """reuse_factors=True without condensation (f64, K=8).  For SE(2) the
    initial-condition rows vary with the state, so step.fleet still
    factorizes per member and equals the reuse_factors=False fleet exactly
    (in JAX both are the same code path).  For a commutative state (the
    double integrator on R^2) every member iterates against the template's
    shared factors: statuses and iterations equal JAX's, u within 1e-9."""
    qp = dict(FLEET_QP, max_iter=2000)
    ts, xs = _fleet_states(4, 3)
    tws0 = _torch_vehicle(QPSolverParams(**qp))[1]
    tws = type(tws0)(*(a.expand((3,) + a.shape) for a in tws0))
    fleets = [_torch_vehicle(QPSolverParams(**qp), reuse_factors=r)[0].fleet for r in (True, False)]
    r_reuse, r_plain = (f(tws, torch.as_tensor(ts), torch.as_tensor(xs)) for f in fleets)
    for a, b in zip(r_reuse, r_plain):
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bool((r_reuse.status == QPSolutionStatus.Optimal).all())

    jstep, jws0 = j_make_mpc_step(
        JRn(2), JRn(1), lambda x, u: jnp.stack([x[1], u[0]]),
        lambda t: jnp.stack([-0.5 * jnp.sin(0.3 * t), -0.15 * jnp.cos(0.3 * t)]),
        lambda t: jnp.zeros(1),
        weights=JMPCWeights(jnp.eye(2), 0.1 * jnp.eye(2), 0.1 * jnp.eye(1)),
        params=JMPCParams(K=8, tf=5.0, qp=JQPSolverParams(**qp)),
        cr=lambda x, u: u, crl=jnp.array([-0.5]), cru=jnp.array([0.5]),
        reuse_factors=True,
    )
    tstep, tws0 = make_mpc_step(
        Rn(2), Rn(1), lambda x, u: torch.stack([x[1], u[0]]),
        lambda t: torch.stack([-0.5 * torch.sin(0.3 * t), -0.15 * torch.cos(0.3 * t)]),
        lambda t: torch.zeros(1, dtype=torch.float64),
        weights=weights_from_numpy((np.eye(2), 0.1 * np.eye(2), 0.1 * np.eye(1))),
        params=MPCParams(K=8, tf=5.0, qp=QPSolverParams(**qp)),
        cr=lambda x, u: u, crl=[-0.5], cru=[0.5], device="cpu", reuse_factors=True,
    )
    rng = np.random.default_rng(5)
    ts, xs = rng.uniform(0.0, 10.0, 3), 0.5 * rng.standard_normal((3, 2))
    jws = jax.tree.map(lambda a: jnp.broadcast_to(a, (3,) + a.shape), jws0)
    tws = type(tws0)(*(a.expand((3,) + a.shape) for a in tws0))
    jr = jax.jit(jstep.fleet)(jws, jnp.asarray(ts), jnp.asarray(xs))
    tr = tstep.fleet(tws, torch.as_tensor(ts), torch.as_tensor(xs))
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.warmstart.iters.numpy(), np.asarray(jr.warmstart.iters))
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), atol=1e-9, rtol=0)
    assert bool((tr.status == QPSolutionStatus.Optimal).all())
