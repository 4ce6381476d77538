"""benchmarks/ocp_se2.py's SE(2) OCP sweep at a small size, the port's
problem as chip_smoke.py builds it (``ocp_sweep_problem``,
``ocp_sweep_params``, ``ocp_sweep_rescue``, ``ocp_kkt_f64``) against the
JAX package's twin (``ocp_sweep_jax.make_flat_nlp``, built from the JAX
package's API), on the same numpy velocities, Mesh.uniform(1, 3) (NLP
n = m = 28), B = 3.

float64 on the CPU, port "torch" against JAX "xla": the same statuses and
SQP iteration counts per member, x within 1e-7 (after the rescue 1e-5, see
its test), KKT <= tol, for the lockstep sweep, the rescue after a starved
sweep and the single form.
float32 on the CPU, the card's route: backend "cuda" on CPU tensors runs
admm_iterate_cuda's plain version once per lockstep iteration and ends
with the statuses of the float64 solve."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as cs
import ocp_sweep_jax as oj
from smooth_feedback_tpu.nlp import NLPSolution as JNLPSolution
from smooth_feedback_tpu.ocp.collocation import Mesh as JMesh
from smooth_feedback_tpu.solvers import rescue_nonoptimal as j_rescue
from smooth_feedback_tpu.solvers import solve_nlp_sqp_batch as j_batch
from smooth_feedback_tpu_torch.convert import nlp_solution_from_numpy
from smooth_feedback_tpu_torch.nlp import NLPSolutionStatus
from smooth_feedback_tpu_torch.ocp.collocation import Mesh as TMesh
from smooth_feedback_tpu_torch.solvers import solve_nlp_sqp, solve_nlp_sqp_batch

torch.set_num_threads(1)

MESH = (1, 3)
B = 3
OPTIMAL = int(NLPSolutionStatus.Optimal)


def _port(dtype=torch.float64, backend="torch"):
    make, vels, z0 = cs.ocp_sweep_path("cpu", dtype, B, MESH)
    return make, vels, z0, cs.ocp_sweep_params(backend)


def _jax_family():
    """The JAX package's twin family, velocities, start and float64 "xla"
    sweep parameters."""
    mesh = JMesh.uniform(*MESH)
    make = lambda vel: oj.make_flat_nlp(mesh, vel)
    vels = jnp.asarray(cs.ocp_sweep_velocities(B))
    z0 = jnp.zeros((B, make(vels[0]).n)).at[:, 0].set(5.0)
    return make, vels, z0, oj.sweep_params("xla")


@functools.lru_cache(maxsize=None)
def _jax_sweep():
    """The JAX package's fleet solve on the same velocities and start,
    float64, "xla"."""
    make, vels, z0, prm = _jax_family()
    return jax.jit(lambda th, x: j_batch(make, th, x, prm))(vels, z0)


@functools.lru_cache(maxsize=None)
def _port_sweep():
    """The port's float64 fleet solve, which test_sweep_matches_jax holds
    to the JAX package's member by member."""
    return solve_nlp_sqp_batch(*_port())


def _agree(sj, st, tol=cs.OCP_TOL, x_tol=1e-7):
    np.testing.assert_array_equal(st.status.numpy(), np.asarray(sj.status))
    np.testing.assert_array_equal(st.iters.numpy(), np.asarray(sj.iters))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), atol=x_tol, rtol=0)
    opt = st.status.numpy() == OPTIMAL
    assert np.all(st.kkt_res.numpy()[opt] <= tol) and np.all(np.asarray(sj.kkt_res)[opt] <= tol)


def test_sweep_matches_jax():
    """The lockstep sweep: every member Optimal, member by member the JAX
    package's iterations and point; ocp_kkt_f64 (the card's check) reads
    the JAX package's own residuals at its solution."""
    sj = _jax_sweep()
    make, vels, z0, prm = _port()
    st = _port_sweep()
    _agree(sj, st)
    assert bool((st.status == OPTIMAL).all())
    kkt = cs.ocp_kkt_f64(vels, nlp_solution_from_numpy(tuple(np.asarray(a) for a in sj), "cpu"),
                         TMesh.uniform(*MESH))
    np.testing.assert_allclose(kkt.numpy(), np.asarray(sj.kkt_res), rtol=1e-6, atol=1e-12)


def test_sweep_rescue_matches_jax():
    """A sweep starved at 3 SQP iterations, then the rescue with
    benchmarks/ocp_se2.py's settings (chip_smoke.ocp_sweep_rescue; budget
    scale 4, adaptive rho, stall scale 3, cold start z0) in both packages
    from that one fleet solution: the same members rescued, the same
    statuses and SQP iterations.  The starved sweep is the port's (the
    lockstep loop test_sweep_matches_jax holds to the JAX package's
    iteration by iteration), so the JAX package builds its rescue's
    programs and no starved sweep of its own.  The points agree within
    1e-5, not 1e-7 (measured 1.2e-6): the rescue's inner QPs adapt rho at
    checks whose outcome follows rounding (the JAX package's own single and
    batched forms take different inner iteration counts on one member), so
    two runs meet at the inner QP's eps 1e-6, not closer."""
    make_j, vels_j, z0_j, prm_j = _jax_family()
    make, vels, z0, prm = _port()
    starved = dataclasses.replace(prm, max_iter=3)
    st = solve_nlp_sqp_batch(make, vels, z0, starved)
    assert (st.status.numpy() != OPTIMAL).any()
    sj = JNLPSolution(*(jnp.asarray(a.numpy()) for a in st))
    mj, nj = j_rescue(make_j, vels_j, sj, dataclasses.replace(prm_j, max_iter=3), x0_cold=z0_j,
                      budget_scale=4, adaptive_rho=True, stall_scale=3)
    mt, nt = cs.ocp_sweep_rescue(make, vels, st, starved, z0)
    assert nt == nj > 0
    _agree(mj, mt, x_tol=1e-5)


def test_single_form_matches_the_fleet():
    """solve_nlp_sqp on member 1 alone takes the fleet's iterations for
    that member to its point (the port's float64 fleet, the JAX package's
    member by member: test_sweep_matches_jax)."""
    sj = _port_sweep()
    make, vels, z0, prm = _port()
    s1 = solve_nlp_sqp(make(vels[1]), z0[1], prm)
    assert int(s1.status) == int(sj.status[1]) == OPTIMAL
    assert int(s1.iters) == int(sj.iters[1])
    np.testing.assert_allclose(s1.x.numpy(), sj.x[1].numpy(), atol=1e-7, rtol=0)


def test_kernel_route_on_cpu_float32(monkeypatch):
    """The card's route in float32 on CPU tensors: admm_iterate_cuda (its
    plain version here) solves each lockstep iteration's subproblem batch
    once; every member ends Optimal as in float64, at a point within 1e-3
    of the float64 one (f32 rounding through 1200-iteration subproblems;
    the port's float64 fleet, the JAX package's member by member:
    test_sweep_matches_jax)."""
    from smooth_feedback_tpu_torch.qp import cuda_kernel

    calls = []
    inner = cuda_kernel.admm_iterate_cuda
    monkeypatch.setattr(cuda_kernel, "admm_iterate_cuda",
                        lambda *a: calls.append(a[1].shape) or inner(*a))
    make, vels, z0, prm = _port(torch.float32, "cuda")
    st = solve_nlp_sqp_batch(make, vels, z0, prm)
    assert len(calls) == int(st.iters.max()) and calls[0] == (B, 28, 28)
    s64 = _port_sweep()
    np.testing.assert_array_equal(st.status.numpy(), s64.status.numpy())
    np.testing.assert_allclose(st.x.numpy(), s64.x.numpy(), atol=1e-3, rtol=0)
    kkt = cs.ocp_kkt_f64(vels, st, TMesh.uniform(*MESH))
    assert bool((kkt <= cs.OCP_TOL).all())
