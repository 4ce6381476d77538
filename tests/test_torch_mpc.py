"""The PyTorch port's transcription, condensation and condensed MPC fleet step
against the JAX package (the reference), on the CPU.

The double-integrator tracking problem of tests/test_mpc.py and bench.py is
built in both packages; states and noise come from numpy with a seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smooth_feedback_tpu.controllers import MPCParams as JMPCParams
from smooth_feedback_tpu.controllers import MPCWeights as JMPCWeights
from smooth_feedback_tpu.controllers import make_mpc_step as j_make_mpc_step
from smooth_feedback_tpu.controllers.mpc import _build_condensation as j_build_condensation
from smooth_feedback_tpu.groups import Rn as JRn
from smooth_feedback_tpu.ocp import OCP as JOCP
from smooth_feedback_tpu.ocp import variable_layout as j_variable_layout
from smooth_feedback_tpu.ocp.collocation import Mesh as JMesh
from smooth_feedback_tpu.qp import QPSolverParams as JQPSolverParams
from smooth_feedback_tpu_torch.controllers import MPCParams, make_mpc_step
from smooth_feedback_tpu_torch.controllers.mpc import _build_condensation
from smooth_feedback_tpu_torch import convert
from smooth_feedback_tpu_torch.groups import Rn
from smooth_feedback_tpu_torch.ocp import OCP, variable_layout
from smooth_feedback_tpu_torch.ocp.collocation import Mesh
from smooth_feedback_tpu_torch.qp import QPSolutionStatus, QPSolverParams

torch.set_num_threads(1)

# the port's entry points default to the card; these tests run on the CPU
qp_from_numpy = functools.partial(convert.qp_from_numpy, device="cpu")
solution_from_numpy = functools.partial(convert.solution_from_numpy, device="cpu")
weights_from_numpy = functools.partial(convert.weights_from_numpy, device="cpu")

# bench.py's solver settings (bench.py:75-93)
BENCH_QP = dict(scaling=True, polish=False, rho=2.0, rho_eq_scale=15.0,
                max_iter=100, stop_check_iter=10)
WEIGHTS = (np.eye(2), 0.1 * np.eye(2), 0.1 * np.eye(1))


def _jax_step(K, qp, dtype=None, return_trajectories=True):
    return j_make_mpc_step(
        JRn(2), JRn(1), lambda x, u: jnp.stack([x[1], u[0]]),
        lambda t: jnp.stack([-0.5 * jnp.sin(0.3 * t), -0.15 * jnp.cos(0.3 * t)]),
        lambda t: jnp.zeros(1, dtype),
        weights=JMPCWeights(*(jnp.asarray(w, dtype) for w in WEIGHTS)),
        params=JMPCParams(K=K, tf=5.0, qp=qp, return_trajectories=return_trajectories),
        cr=lambda x, u: u, crl=jnp.array([-0.5], dtype), cru=jnp.array([0.5], dtype),
        dtype=dtype, reuse_factors=True, condense=True,
    )


def _torch_step(K, qp, dtype=torch.float64, return_trajectories=True):
    return make_mpc_step(
        Rn(2), Rn(1), lambda x, u: torch.stack([x[1], u[0]]),
        lambda t: torch.stack([-0.5 * torch.sin(0.3 * t), -0.15 * torch.cos(0.3 * t)]),
        lambda t: torch.zeros(1, dtype=dtype),
        weights=weights_from_numpy(WEIGHTS, dtype=dtype),
        params=MPCParams(K=K, tf=5.0, qp=qp, return_trajectories=return_trajectories),
        cr=lambda x, u: u, crl=[-0.5], cru=[0.5],
        dtype=dtype, device="cpu", reuse_factors=True, condense=True,
    )


def test_transcription_and_condensation_f64():
    """ocp_to_qp / ocp_to_qp_vectors of the DI tracking OCP at K=12 give P,
    q, A, l and u within 1e-12 of JAX (f64, same formulas); the one-time
    condensation's matrices agree within 1e-10 (f64 inverses of a matrix
    with cond ~1e3)."""
    qp_prm = dict(polish=False)
    j_step, _ = _jax_step(12, JQPSolverParams(**qp_prm))
    t_step, _ = _torch_step(12, QPSolverParams(**qp_prm))
    rng = np.random.default_rng(5)
    # one JAX compile for both transcriptions
    j_both = jax.jit(lambda t, x: (j_step.transcribe(t, x), j_step.transcribe_vectors(t, x)))
    for t in (0.0, 0.8):
        x = 0.7 * rng.standard_normal(2)
        jqp, jv = j_both(t, jnp.asarray(x))
        tqp = t_step.transcribe(t, torch.as_tensor(x))
        for name in ("P", "q", "A", "l", "u"):
            np.testing.assert_allclose(
                getattr(tqp, name).numpy(), np.asarray(getattr(jqp, name)),
                atol=1e-12, rtol=0, err_msg=name,
            )
        tv = t_step.transcribe_vectors(t, torch.as_tensor(x))
        for a, b in zip(tv, jv):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=0)

    # condensation of the template transcribed at x = xdes(0)
    xd0 = np.array([0.0, -0.15])
    jqp0, _ = j_both(0.0, jnp.asarray(xd0))
    jlay = j_variable_layout(
        JOCP(X=JRn(2), U=JRn(1), theta=None, f=None, g=None, cr=None,
             crl=jnp.zeros(1), cru=jnp.zeros(1), ce=None, cel=jnp.zeros(2), ceu=jnp.zeros(2)),
        JMesh.uniform(3, 4, Kmin=4, Kmax=4),
    )
    lay = variable_layout(
        OCP(X=Rn(2), U=Rn(1), theta=None, f=None, g=None, cr=None,
            crl=torch.zeros(1), cru=torch.zeros(1), ce=None,
            cel=torch.zeros(2), ceu=torch.zeros(2)),
        Mesh.uniform(3, 4, Kmin=4, Kmax=4),
    )
    assert lay == jlay
    jc = j_build_condensation(jqp0, jlay, jnp.float64)
    tc = _build_condensation(qp_from_numpy(jax.tree.map(np.asarray, jqp0)), lay,
                             torch.float64, "cpu")
    assert set(tc) == set(jc)
    for name in jc:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-10, rtol=0, err_msg=name)


def _closed_loop(j_fleet, t_fleet, jws0, tws0, xs0, steps, on_step):
    """Run both fleets ``steps`` closed-loop steps on bench.py's plant update
    (x <- x + dt (x1, u)), each from its own warm-start carry."""
    B = xs0.shape[0]
    jws = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jws0)
    tws = solution_from_numpy(jax.tree.map(lambda a: np.broadcast_to(np.asarray(a), (B,) + a.shape), jws0),
                              dtype=tws0.primal.dtype)
    jx = jnp.asarray(xs0, jws.primal.dtype)
    tx = torch.as_tensor(xs0, dtype=tws0.primal.dtype)
    dt = 0.05
    for i in range(steps):
        jr = j_fleet(jws, dt * i, jx)
        tr = t_fleet(tws, dt * i, tx)
        on_step(i, jr, tr)
        jx = jx + dt * jnp.stack([jx[:, 1], jr.u[:, 0]], axis=1)
        tx = tx + dt * torch.stack([tx[:, 1], tr.u[:, 0]], dim=1)
        jws, tws = jr.warmstart, tr.warmstart


def test_fleet_closed_loop_f64():
    """The slice end to end in f64: bench.py's QP settings at K=8, B=16, a
    10-step closed loop (cold start, then nine warm-started steps); the port on "torch" against JAX on "xla".  Statuses
    and iterations equal at every step; u within 1e-8 (f64, summation order
    only)."""
    j_step, jws0 = _jax_step(8, JQPSolverParams(**BENCH_QP))
    t_step, tws0 = _torch_step(8, QPSolverParams(**BENCH_QP))
    xs0 = 0.5 * np.random.default_rng(0).standard_normal((16, 2))

    def check(i, jr, tr):
        np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
        np.testing.assert_array_equal(tr.warmstart.iters.numpy(), np.asarray(jr.warmstart.iters))
        np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), atol=1e-8, rtol=0)
        np.testing.assert_allclose(tr.x_traj.numpy(), np.asarray(jr.x_traj), atol=1e-8, rtol=0)
        np.testing.assert_allclose(tr.warmstart.objective.numpy(),
                                   np.asarray(jr.warmstart.objective), atol=1e-8, rtol=0)

    _closed_loop(jax.jit(j_step.fleet_shared_t), t_step.fleet_shared_t,
                 jws0, tws0, xs0, 10, check)

    # the single-controller step is the fleet step at B = 1
    x = torch.tensor([0.3, -0.2], dtype=torch.float64)
    r1 = t_step(tws0, 0.1, x)
    rB = t_step.fleet_shared_t(type(tws0)(*(a[None] for a in tws0)), 0.1, x[None])
    torch.testing.assert_close(r1.u, rB.u[0])
    assert int(r1.status) == int(rB.status[0])


def test_fleet_closed_loop_f32_kernel_backend():
    """The slice in f32: JAX on "pallas" (interpret mode) against the port on
    "cuda", whose wrapper runs the kernel's plain version on CPU tensors.
    Statuses equal at every step of a 10-step closed loop; u within 1e-4 (f32
    with another summation order, and the JAX side transcribes in f64 before
    casting)."""
    jq = JQPSolverParams(**BENCH_QP, backend="pallas")
    tq = QPSolverParams(**BENCH_QP, backend="cuda")
    j_step, jws0 = _jax_step(8, jq, dtype=jnp.float32, return_trajectories=False)
    t_step, tws0 = _torch_step(8, tq, dtype=torch.float32, return_trajectories=False)
    xs0 = 0.5 * np.random.default_rng(1).standard_normal((16, 2))
    n_opt = []

    def check(i, jr, tr):
        np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
        np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), atol=1e-4, rtol=0)
        n_opt.append(int((tr.status == QPSolutionStatus.Optimal).sum()))

    _closed_loop(jax.jit(j_step.fleet_shared_t), t_step.fleet_shared_t,
                 jws0, tws0, xs0, 10, check)
    assert sum(n_opt) > 0


def test_static_reference_f64():
    """static_reference=True hoists the template vectors to construction: for
    a constant-velocity reference it equals the per-step transcription and
    JAX's static_reference step (statuses equal, u within 1e-8: f64,
    summation order only); a sinusoidal reference is rejected."""
    qp = dict(BENCH_QP, max_iter=2000)
    xdes_j = lambda t: jnp.stack([0.2 + 0.3 * t, 0.3 + 0.0 * t])
    xdes_t = lambda t: torch.stack([0.2 + 0.3 * t, 0.3 + 0.0 * t])

    def build_t(static, xdes=xdes_t):
        return make_mpc_step(
            Rn(2), Rn(1), lambda x, u: torch.stack([x[1], u[0]]), xdes,
            lambda t: torch.zeros(1, dtype=torch.float64),
            weights=weights_from_numpy(WEIGHTS),
            params=MPCParams(K=8, tf=5.0, qp=QPSolverParams(**qp)),
            cr=lambda x, u: u, crl=[-0.5], cru=[0.5], device="cpu",
            reuse_factors=True, condense=True, static_reference=static,
        )

    j_step, jws = j_make_mpc_step(
        JRn(2), JRn(1), lambda x, u: jnp.stack([x[1], u[0]]), xdes_j, lambda t: jnp.zeros(1),
        weights=JMPCWeights(*(jnp.asarray(w) for w in WEIGHTS)),
        params=JMPCParams(K=8, tf=5.0, qp=JQPSolverParams(**qp)),
        cr=lambda x, u: u, crl=jnp.array([-0.5]), cru=jnp.array([0.5]),
        reuse_factors=True, condense=True, static_reference=True,
    )
    (t_dyn, tws), (t_st, _) = build_t(False), build_t(True)
    xs = 0.4 * np.random.default_rng(7).standard_normal((4, 2))
    tw = type(tws)(*(a.expand((4,) + a.shape) for a in tws))
    jw = jax.tree.map(lambda a: jnp.broadcast_to(a, (4,) + a.shape), jws)
    for t in (0.0, 1.3):
        rd = t_dyn.fleet_shared_t(tw, t, torch.as_tensor(xs))
        rs = t_st.fleet_shared_t(tw, t, torch.as_tensor(xs))
        rj = jax.jit(j_step.fleet_shared_t)(jw, t, jnp.asarray(xs))
        assert bool((rs.status == QPSolutionStatus.Optimal).all())
        np.testing.assert_array_equal(rs.status.numpy(), np.asarray(rj.status))
        np.testing.assert_array_equal(rs.status.numpy(), rd.status.numpy())
        np.testing.assert_allclose(rs.u.numpy(), np.asarray(rj.u), atol=1e-8, rtol=0)
        np.testing.assert_allclose(rs.u.numpy(), rd.u.numpy(), atol=1e-8, rtol=0)

    sinusoid = lambda t: torch.stack([-0.5 * torch.sin(0.3 * t), -0.15 * torch.cos(0.3 * t)])
    with pytest.raises(ValueError, match="static_reference"):
        build_t(True, xdes=sinusoid)


def test_unported_paths_raise():
    """The combinations the JAX package refuses raise as there: per-member
    clocks on the condensed path (NotImplementedError), condense without
    reuse_factors and time_varying with reuse_factors (ValueError).  The
    paths earlier slices refused now run: time_varying, and the sparse
    common-clock fleet step (here on the template's shared factors, equal to
    the per-member fleet on one clock)."""
    qp = QPSolverParams(**BENCH_QP)

    def build(f=lambda x, u: torch.stack([x[1], u[0]]), **kw):
        return make_mpc_step(
            Rn(2), Rn(1), f,
            lambda t: torch.zeros(2, dtype=torch.float64),
            lambda t: torch.zeros(1, dtype=torch.float64),
            weights=weights_from_numpy(WEIGHTS), params=MPCParams(K=8, qp=qp),
            device="cpu", **kw,
        )

    with pytest.raises(ValueError, match="reuse_factors"):
        build(condense=True)
    tv_f = lambda t, x, u: torch.stack([x[1], u[0]])
    with pytest.raises(ValueError, match="reuse_factors"):
        build(tv_f, time_varying=True, reuse_factors=True)
    tv, ws0 = build(tv_f, time_varying=True)
    assert int(tv(ws0, 0.0, torch.tensor([0.3, 0.0], dtype=torch.float64)).status) == 0
    sparse, ws0 = build(reuse_factors=True)
    xs = torch.tensor([[0.3, 0.0], [-0.2, 0.1]], dtype=torch.float64)
    ws = type(ws0)(*(a.expand((2,) + a.shape) for a in ws0))
    r_shared = sparse.fleet_shared_t(ws, 0.0, xs)
    r_fleet = sparse.fleet(ws, 0.0, xs)
    torch.testing.assert_close(r_shared.u, r_fleet.u, rtol=0, atol=1e-12)
    t_step, ws0 = _torch_step(8, qp)
    with pytest.raises(NotImplementedError):
        t_step.fleet(ws0, 0.0, torch.zeros(1, 2, dtype=torch.float64))
