"""The hp-adaptive OCP driver (ocp/solve.py) and qpsol_to_ocpsol, port
against the JAX package.

float64 on the CPU, port "torch" against JAX "xla", on the same numpy
inputs: the double integrator of tests/test_ocp_nlp.py (single and as a
family over the start position) and examples/ocp_se2_nlp.py's SE(2) OCP
(chip_smoke.ocp_example and ocp_sweep_jax.example_ocp); chip_smoke's
refinement fleet at B = 2 (``ocp_refine_run``, the driver call the card
runs) against its own records and float64 checks, and its family's NLP
against the JAX twin.  Each JAX result is computed once per
module.  The meshes are the
smallest that still refine once, and the inner QPs run without adaptive
rho: the JAX package compiles one SQP program per mesh, and adaptive rho
makes each compile take minutes.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import ocp_sweep_jax as oj
from smooth_feedback_tpu.groups import Rn as JRn
from smooth_feedback_tpu.ocp import OCP as JOCP
from smooth_feedback_tpu.ocp import SolveOCPParams as JP
from smooth_feedback_tpu.ocp import ocp_to_nlp as j_ocp_to_nlp
from smooth_feedback_tpu.ocp import qpsol_to_ocpsol as j_qpsol_to_ocpsol
from smooth_feedback_tpu.ocp import solve_ocp as j_solve_ocp
from smooth_feedback_tpu.ocp import solve_ocp_flat as j_solve_flat
from smooth_feedback_tpu.ocp import solve_ocp_flat_batch as j_solve_batch
from smooth_feedback_tpu.ocp.collocation import Mesh as JMesh
from smooth_feedback_tpu.qp import QPSolverParams as JQ
from smooth_feedback_tpu.solvers import SQPParams as JS
from smooth_feedback_tpu_torch.groups import Rn
from smooth_feedback_tpu_torch.nlp import NLPSolution, NLPSolutionStatus
from smooth_feedback_tpu_torch.ocp import (
    OCP,
    SolveOCPParams,
    nlp_layout,
    nlpsol_to_ocpsol,
    qpsol_to_ocpsol,
    solve_ocp,
    solve_ocp_flat,
    solve_ocp_flat_batch,
)
from smooth_feedback_tpu_torch.ocp import solve as t_solve_module
from smooth_feedback_tpu_torch.ocp.collocation import Mesh
from smooth_feedback_tpu_torch.qp import QPSolution
from smooth_feedback_tpu_torch.qp import QPSolverParams as TQ
from smooth_feedback_tpu_torch.solvers import SQPParams as TS

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
OPTIMAL = int(NLPSolutionStatus.Optimal)
LIMIT = int(NLPSolutionStatus.IterationLimit)
# the double integrator: one interval of degree 3 (error 4.0e-2) refines
# to three (2.9e-3), so a target of 1e-2 takes exactly two passes
DI_MESH = (1, 3, 3, 4)  # Mesh.uniform(n, k, Kmin, Kmax)
DI_TARGET = 1e-2
TIMES = np.linspace(0.0, 5.0, 7)


def _sqp(lib, **kw):
    """An exact-Hessian SQP (50 iterations, tol 1e-8) whose inner QPs (eps
    1e-10, 2000 iterations, polish) run without adaptive rho."""
    S, Q = (JS, JQ) if lib is jnp else (TS, TQ)
    kw = dict(dict(max_iter=50, tol=1e-8), **kw)
    return S(qp=Q(eps_abs=1e-10, eps_rel=1e-10, max_iter=2000, polish=False), **kw)


def _params(lib, target=DI_TARGET, refine=3, sqp_kw=None, **kw):
    P = JP if lib is jnp else SolveOCPParams
    return P(target_err=target, max_refine_iter=refine, tf_guess=5.0,
             sqp=_sqp(lib, **(sqp_kw or {})), **kw)


def _mesh(lib, spec=DI_MESH):
    n, k, kmin, kmax = spec
    return (JMesh if lib is jnp else Mesh).uniform(n, k, Kmin=kmin, Kmax=kmax)


def _di(lib, p0=None, xf=0.0):
    """tests/test_ocp_nlp.py's double integrator: min the integral of x'x +
    u'u, tf = 5, |v| <= 1.5, |u| <= 1, from (1, 0) to (xf, 0); with ``p0``
    (traceable) from (p0, 0) through the end constraints instead."""
    if lib is jnp:
        st, cat, O, R = jnp.stack, jnp.concatenate, JOCP, JRn
        a = lambda v: jnp.stack([jnp.asarray(e, jnp.float64) for e in v])
    else:
        a = lambda v: torch.tensor(v, **F64)
        st, cat, O, R = torch.stack, torch.cat, OCP, Rn
    if p0 is None:
        ce = lambda tf, x0, xf_, q: cat([tf[None], x0, xf_])
        ends = a([5.0, 1.0, 0.0, xf, 0.0])
    else:
        ce = lambda tf, x0, xf_, q: cat([tf[None], x0 - st([p0, 0.0 * p0]), xf_])
        ends = a([5.0, 0.0, 0.0, xf, 0.0])
    return O(
        X=R(2), U=R(1),
        theta=lambda tf, x0, xf_, q: q[0],
        f=lambda t, x, u: st([x[1], u[0]]),
        g=lambda t, x, u: st([x @ x + u @ u]),
        cr=lambda t, x, u: st([x[1], u[0]]),
        crl=a([-1.5, -1.0]), cru=a([1.5, 1.0]),
        ce=ce, cel=ends, ceu=ends,
    )


def _at(fn, lib, times=TIMES):
    """``fn`` at ``times``: one compiled vmapped call on the JAX side (eager
    JAX dispatches, and compiles, every operation on its own)."""
    if lib is jnp:
        return np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(times)))
    return np.stack([fn(torch.tensor(s, **F64)).numpy() for s in times])


def _meshes(ms):
    return [tuple(m.intervals) for m in ms]


@functools.lru_cache(maxsize=None)
def _jax_single():
    sol, mesh, info = j_solve_flat(_di(jnp), _mesh(jnp), _params(jnp))
    return mesh, info, _at(sol.x, jnp), _at(sol.u, jnp)


P0S = (1.0, 0.7, 1.3)
# SQP iterations that leave a member of the family non-Optimal
STARVE = 3


@functools.lru_cache(maxsize=None)
def _jax_batch():
    """The JAX fleet driver on the double-integrator family over p0."""
    return j_solve_batch(lambda p: _di(jnp, p), jnp.asarray(P0S), _mesh(jnp), _params(jnp))


def test_solve_ocp_flat_matches_jax():
    """Two passes (the target lies between the passes' errors): the same
    meshes, status and SQP iterations per pass, errors within 1e-9
    relative, x(t) and u(t) at 7 times within 1e-8."""
    jmesh, jinfo, jx, ju = _jax_single()
    sol, mesh, info = solve_ocp_flat(_di(torch), _mesh(torch), _params(torch), **F64)
    assert len(info.meshes) == 2
    assert _meshes(info.meshes) == _meshes(jinfo.meshes) and mesh.intervals == jmesh.intervals
    assert int(info.status) == int(jinfo.status) == OPTIMAL
    assert info.nlp_iters == [int(i) for i in jinfo.nlp_iters]
    np.testing.assert_allclose(info.errors, jinfo.errors, rtol=1e-9, atol=0)
    assert info.errors[0] > DI_TARGET >= info.errors[1]
    np.testing.assert_allclose(_at(sol.x, torch), jx, atol=1e-8, rtol=0)
    np.testing.assert_allclose(_at(sol.u, torch), ju, atol=1e-8, rtol=0)


def test_solve_ocp_flat_fail_fast():
    """tests/test_ocp_nlp.py::test_refinement_fail_fast_on_non_optimal on
    the port: one SQP iteration leaves the first solve IterationLimit, so
    the driver stops with one mesh and a NaN error; with fail_fast off it
    refines on for max_refine_iter passes."""
    prm = _params(torch, target=1e-12, refine=4, sqp_kw=dict(max_iter=1))
    _, _, info = solve_ocp_flat(_di(torch), Mesh.uniform(3, 5), prm, **F64)
    assert int(info.status) == LIMIT
    assert len(info.meshes) == 1 and np.isnan(info.errors[-1])
    prm2 = dataclasses.replace(prm, fail_fast=False, max_refine_iter=2)
    _, _, info2 = solve_ocp_flat(_di(torch), Mesh.uniform(3, 5), prm2, **F64)
    assert len(info2.meshes) == 2 and int(info2.status) == LIMIT


# the SE(2) OCP refines once at this target; BFGS spares the JAX package
# tracing the Lagrangian Hessian of the group's dynamics on every mesh
SE2_PARAMS = dict(target=1e-3, sqp_kw=dict(hessian="bfgs"))


@functools.lru_cache(maxsize=None)
def _jax_se2():
    ocp, xl, ul = oj.example_ocp()
    sol, mesh, info = j_solve_ocp(ocp, xl, ul, JMesh(), _params(jnp, **SE2_PARAMS))
    return mesh, info, _at(sol.x, jnp)


def test_solve_ocp_se2_matches_jax():
    """The Lie-group one call (flatten, refine, unflatten) on
    examples/ocp_se2_nlp.py's OCP from Mesh(): one refinement, the same
    meshes, status and SQP iterations as JAX, x(t) on the group within
    1e-8, x(0) the fixed start."""
    jmesh, jinfo, jx = _jax_se2()
    ocp, xl, ul = cs.ocp_example(**F64)
    sol, mesh, info = solve_ocp(ocp, xl, ul, Mesh(), _params(torch, **SE2_PARAMS), **F64)
    assert len(info.meshes) == 2
    assert _meshes(info.meshes) == _meshes(jinfo.meshes) and mesh.intervals == jmesh.intervals
    assert int(info.status) == int(jinfo.status) == OPTIMAL
    assert info.nlp_iters == [int(i) for i in jinfo.nlp_iters]
    np.testing.assert_allclose(info.errors, jinfo.errors, rtol=1e-9, atol=0)
    xt = _at(sol.x, torch)
    np.testing.assert_allclose(xt, jx, atol=1e-8, rtol=0)
    np.testing.assert_allclose(xt[0], [0.0, 0.0, 1.0, 0.0, 1.0, 0.0], atol=1e-8)


def _member(sol, i):
    return NLPSolution(*(a[i] for a in sol))


@functools.lru_cache(maxsize=None)
def _port_batch():
    """The port's fleet driver on the same family, which
    test_solve_ocp_flat_batch_matches_jax holds to the JAX package's."""
    return solve_ocp_flat_batch(lambda p: _di(torch, p), np.asarray(P0S), _mesh(torch),
                                _params(torch), **F64)


def test_solve_ocp_flat_batch_matches_jax():
    """The fleet driver on the double-integrator family (B = 3), two
    passes: the same meshes, per-pass SQP iterations and rescued counts,
    statuses, errors within 1e-9 relative and nlpsol.x within 1e-8; member
    1's trajectory rebuilt on the returned mesh (the docstring's recipe)
    meets its boundary conditions."""
    jsol, jmesh, jinfo = _jax_batch()
    make_flat = lambda p: _di(torch, p)
    sol, mesh, info = _port_batch()
    assert len(info.meshes) == 2
    assert _meshes(info.meshes) == _meshes(jinfo.meshes) and mesh.intervals == jmesh.intervals
    for it, jit in zip(info.nlp_iters, jinfo.nlp_iters):
        np.testing.assert_array_equal(it.numpy(), np.asarray(jit))
    assert info.rescued == list(jinfo.rescued) == [0, 0]
    np.testing.assert_array_equal(info.statuses.numpy(), np.asarray(jinfo.statuses))
    assert bool((info.statuses == OPTIMAL).all())
    np.testing.assert_allclose(info.errors, jinfo.errors, rtol=1e-9, atol=0)
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(jsol.x), atol=1e-8, rtol=0)
    assert mesh == info.meshes[-1]
    assert nlp_layout(make_flat(torch.tensor(0.7, **F64)), mesh).n == sol.x.shape[1]
    o = nlpsol_to_ocpsol(make_flat(torch.tensor(P0S[1], **F64)), mesh, _member(sol, 1))
    np.testing.assert_allclose(o.x(torch.tensor(0.0, **F64)).numpy(), [P0S[1], 0.0], atol=1e-8)
    np.testing.assert_allclose(o.x(torch.tensor(5.0, **F64)).numpy(), [0.0, 0.0], atol=1e-8)


def test_solve_ocp_flat_batch_rescue_and_chunking(monkeypatch):
    """tests/test_ocp_nlp.py::test_solve_ocp_flat_batch_rescue_and_chunking
    on the port: SQP iterations capped at STARVE leave a member
    non-Optimal, the driver's rescue re-solves it (rescued[0] >= 1) and the
    fleet ends all Optimal on the un-starved run's meshes, within 1e-6 of
    its x (the port's un-starved run, the JAX package's within 1e-8:
    test_solve_ocp_flat_batch_matches_jax); with chunk_size 2 the second
    pass is sorted by the first pass's qp_iters (the sort key handed to
    solve_nlp_sqp_batch)."""
    jsol, jmesh, jinfo = _port_batch()
    keys = []
    inner = t_solve_module.solve_nlp_sqp_batch

    def spy(*a, sort_key=None, **kw):
        keys.append(sort_key.clone())
        out = inner(*a, sort_key=sort_key, **kw)
        keys.append(out.qp_iters.clone())
        return out

    monkeypatch.setattr(t_solve_module, "solve_nlp_sqp_batch", spy)
    prm = _params(torch, sqp_kw=dict(max_iter=STARVE, chunk_size=2))
    sol, mesh, info = solve_ocp_flat_batch(lambda p: _di(torch, p), np.asarray(P0S),
                                           _mesh(torch), prm, **F64)
    assert info.rescued[0] >= 1
    assert bool((info.statuses == OPTIMAL).all())
    assert _meshes(info.meshes) == _meshes(jinfo.meshes)
    np.testing.assert_allclose(sol.x.numpy(), jsol.x.numpy(), atol=1e-6, rtol=0)
    # pass 0 in the identity order, pass 1 by pass 0's qp_iters, which the
    # rescue raised for the members it re-solved
    assert len(keys) == 4 and not bool(keys[0].any())
    assert bool((keys[2] >= keys[1]).all()) and int((keys[2] > keys[1]).sum()) == info.rescued[0]


def test_solve_ocp_flat_batch_fail_fast():
    """tests/test_ocp_nlp.py::test_solve_ocp_flat_batch_fail_fast on the
    port: without rescue, one SQP iteration leaves every member
    IterationLimit and the fleet stops with one mesh and a NaN error."""
    prm = _params(torch, target=1e-12, refine=4, sqp_kw=dict(max_iter=1), rescue=False)
    _, _, info = solve_ocp_flat_batch(lambda p: _di(torch, p), np.array([1.0, 0.9]),
                                      Mesh.uniform(3, 5), prm, **F64)
    assert bool((info.statuses == LIMIT).all())
    assert len(info.meshes) == 1 and np.isnan(info.errors[-1]) and info.rescued == [0]


def test_no_stale_reuse_across_calls():
    """Two fleet solves in one process with the same make_flat and mesh
    but other bounds (xf = 0.5 through the end-constraint bounds, then
    xf = 0): each equals the JAX package's answer for its own bounds (one
    JAX fleet whose members carry the two targets in their data)."""
    bounds = [0.5]
    make_flat = lambda p: _di(torch, p, bounds[0])
    prm = _params(torch, refine=1)
    sb, _, _ = solve_ocp_flat_batch(make_flat, np.asarray(P0S[:1]), _mesh(torch), prm, **F64)
    bounds[0] = 0.0
    sa, _, _ = solve_ocp_flat_batch(make_flat, np.asarray(P0S[:1]), _mesh(torch), prm, **F64)
    thetas = jnp.asarray([[P0S[0], 0.5], [P0S[0], 0.0]])
    js, _, _ = j_solve_batch(lambda th: _di(jnp, th[0], th[1]), thetas, _mesh(jnp),
                             _params(jnp, refine=1))
    np.testing.assert_allclose(sb.x[0].numpy(), np.asarray(js.x[0]), atol=1e-8, rtol=0)
    np.testing.assert_allclose(sa.x[0].numpy(), np.asarray(js.x[1]), atol=1e-8, rtol=0)
    assert abs(float(sa.objective[0]) - float(sb.objective[0])) > 1e-6


def test_qpsol_to_ocpsol_matches_jax():
    """tests/test_ocp_to_qp.py::test_transcribed_qp_solves's problem and
    mesh, a seeded primal interpolated by both packages: x and u at the
    nodes and at off-node times within 1e-8, x at the nodes the primal's
    node values."""
    ocp_j, ocp_t = _di(jnp), _di(torch)
    mesh_j, mesh_t = JMesh.uniform(5, 4, Kmin=4, Kmax=4), Mesh.uniform(5, 4, Kmin=4, Kmax=4)
    xl_j, ul_j = (lambda t: jnp.zeros(2)), (lambda t: jnp.zeros(1))
    xl_t, ul_t = (lambda t: torch.zeros(2, **F64)), (lambda t: torch.zeros(1, **F64))
    N = mesh_t.N_colloc
    primal = np.random.default_rng(0).standard_normal(2 * (N + 1) + N)
    o_j = j_qpsol_to_ocpsol(ocp_j, mesh_j, SimpleNamespace(primal=jnp.asarray(primal)), 5.0, xl_j,
                            ul_j)
    o_t = qpsol_to_ocpsol(ocp_t, mesh_t, QPSolution(torch.tensor(primal, **F64), *([None] * 6)),
                          5.0, xl_t, ul_t)
    nodes = 5.0 * np.asarray(mesh_t.all_nodes())
    for times in (nodes, np.array([0.13, 1.7, 2.5, 3.33, 4.91])):
        np.testing.assert_allclose(_at(o_t.x, torch, times), _at(o_j.x, jnp, times), atol=1e-8,
                                   rtol=0)
        np.testing.assert_allclose(_at(o_t.u, torch, times[:-1]), _at(o_j.u, jnp, times[:-1]),
                                   atol=1e-8, rtol=0)
    np.testing.assert_allclose(_at(o_t.x, torch, nodes), primal[: 2 * len(nodes)].reshape(-1, 2),
                               atol=1e-12)


# chip_smoke's refinement fleet at B = 2 from one degree-5 interval
REFINE_B = 2
REFINE_MESH = (1, 5)


def test_smoke_refinement_composition():
    """chip_smoke.ocp_refine_run (the ocp-refine phase's driver call, its
    stage hook included) at B = 2 in float64 on "torch": it refines at
    least once and returns the mesh its solution was solved on; the hook's
    records agree with the returned info; each pass's error estimate equals
    chip_smoke.ocp_refine_errors_f64 (the card's float64 check) and
    ocp_kkt_f64 on the final mesh reads every member within tol.  The
    family's NLP is held against the JAX package's twin below; the driver
    against JAX above."""
    (sol, mesh, info), passes, make_flat, vels = cs.ocp_refine_run(
        "cpu", "torch", torch.float64, REFINE_B, mesh=REFINE_MESH)
    assert len(info.meshes) >= 2 and mesh == info.meshes[-1]
    assert nlp_layout(make_flat(vels[0]), mesh).n == sol.x.shape[1]
    assert [p["mesh"] for p in passes] == info.meshes
    assert all(torch.equal(p["solve"]["iters"], it) for p, it in zip(passes, info.nlp_iters))
    assert [p["n_rescued"] for p in passes] == info.rescued
    last = passes[-1].get("rescue", passes[-1]["solve"])
    assert torch.equal(last["status"], info.statuses) and bool((info.statuses == OPTIMAL).all())
    assert [max(p["errs"]) for p in passes] == pytest.approx(info.errors, rel=1e-12)
    assert all(p["mesh_new"] == q for p, q in zip(passes, info.meshes[1:]))
    for p in passes:
        e64 = cs.ocp_refine_errors_f64(vels, p["sol"], p["mesh"])
        np.testing.assert_allclose(p["errs"], e64.numpy(), rtol=1e-12, atol=0)
    kkt = cs.ocp_kkt_f64(vels, sol, mesh, cs.OCP_REFINE_START)
    assert bool((kkt <= cs.OCP_TOL).all())


def test_refinement_family_nlp_matches_jax():
    """The refinement fleet's family (chip_smoke.ocp_sweep_problem with x0's
    speeds OCP_REFINE_START) against the JAX package's twin
    (ocp_sweep_jax.make_flat with the same start) on REFINE_MESH for the
    first REFINE_B velocities: bounds, f, g, the gradient and the
    constraint Jacobian at a seeded point, within 1e-10 (one JAX program
    for the whole fleet).  ``start`` shifts an end constraint by a
    constant, so the Lagrangian Hessian is the one test_torch_nlp.py holds
    against JAX."""
    vels = cs.ocp_sweep_velocities(REFINE_B)
    jmesh, tmesh = JMesh.uniform(*REFINE_MESH), Mesh.uniform(*REFINE_MESH)
    make_t = cs.ocp_sweep_problem(tmesh, torch.float64, "cpu", cs.OCP_REFINE_START)
    nts = [make_t(torch.tensor(v, **F64)) for v in vels]
    rng = np.random.default_rng(1)
    z = 0.2 * rng.standard_normal((REFINE_B, nts[0].n))
    z[:, 0] = 5.0

    @jax.jit
    @jax.vmap
    def jax_side(vel, x):
        nj = j_ocp_to_nlp(oj.make_flat(vel, cs.OCP_REFINE_START), jmesh)
        return (nj.xl, nj.xu, nj.gl, nj.gu, nj.f(x), nj.g(x), jax.grad(nj.f)(x),
                jax.jacrev(nj.g)(x))

    got = jax_side(jnp.asarray(vels), jnp.asarray(z))
    for b, nt in enumerate(nts):
        zt = torch.tensor(z[b], **F64)
        want = (nt.xl, nt.xu, nt.gl, nt.gu, nt.f(zt), nt.g(zt), torch.func.grad(nt.f)(zt),
                torch.func.jacrev(nt.g)(zt))
        for a, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(a[b]), w.numpy(), rtol=1e-10, atol=1e-10)


def test_entry_points_default_to_the_card():
    """solve_ocp, solve_ocp_flat and solve_ocp_flat_batch run on the card
    in float32 unless told otherwise; without a card the default call
    raises from torch instead of falling back to the CPU."""
    import inspect

    for fn in (solve_ocp, solve_ocp_flat, solve_ocp_flat_batch):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda" and params["dtype"].default == torch.float32
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        solve_ocp_flat(_di(torch), _mesh(torch), _params(torch))
