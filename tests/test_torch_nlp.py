"""The NLP layer, port against the JAX package on the same numpy inputs,
float64: nlp.py (with_hessians), ocp.py's test_ocp_derivatives (the
finite-difference self-check), flatten.py and to_nlp.py (layout, bounds,
f, g and their gradient, Jacobian and Lagrangian Hessian for
benchmarks/ocp_se2.py's problem as chip_smoke.py builds it, the solution
round trips).  Values and derivatives agree within 1e-10."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, jacfwd, jacrev

import chip_smoke as cs
import ocp_sweep_jax as oj
from smooth_feedback_tpu import groups as jgroups
from smooth_feedback_tpu.nlp import NLP as JNLP
from smooth_feedback_tpu.nlp import NLPSolution as JSol
from smooth_feedback_tpu.nlp import with_hessians as j_with_hessians
from smooth_feedback_tpu.ocp import OCP as JOCP
from smooth_feedback_tpu.ocp import OCPSolution as JOCPSol
from smooth_feedback_tpu.ocp import flatten_ocp as j_flatten
from smooth_feedback_tpu.ocp import to_nlp as jtn
from smooth_feedback_tpu.ocp.collocation import Mesh as JMesh
from smooth_feedback_tpu.ocp.flatten import unflatten_ocpsol as j_unflatten
from smooth_feedback_tpu_torch import groups as tgroups
from smooth_feedback_tpu_torch.nlp import NLP as TNLP
from smooth_feedback_tpu_torch.nlp import NLPSolution as TSol
from smooth_feedback_tpu_torch.nlp import with_hessians as t_with_hessians
from smooth_feedback_tpu_torch.ocp import OCP as TOCP
from smooth_feedback_tpu_torch.ocp import OCPSolution as TOCPSol
from smooth_feedback_tpu_torch.ocp import flatten_ocp as t_flatten
from smooth_feedback_tpu_torch.ocp import to_nlp as ttn
from smooth_feedback_tpu_torch.ocp.collocation import Mesh as TMesh
from smooth_feedback_tpu_torch.ocp.flatten import unflatten_ocpsol as t_unflatten

torch.set_num_threads(1)

TOL = 1e-10
F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=tol, rtol=0)


def _chain(lib, n):
    """benchmarks/sqp_bench.py:26-44: a Rosenbrock chain with a coupling
    equality and box bounds, in either package."""
    inf = float("inf")
    arr = (lambda a: jnp.asarray(a, jnp.float64)) if lib is jnp else _t
    NLP = JNLP if lib is jnp else TNLP
    return NLP(
        n=n, m=2,
        f=lambda x: lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2),
        g=lambda x: lib.stack([lib.sum(x) - 0.9 * n, x[0] * x[1]]),
        xl=arr(-5.0 * np.ones(n)), xu=arr(5.0 * np.ones(n)),
        gl=arr([0.0, -inf]), gu=arr([0.0, 2.0]),
    )


def test_with_hessians_matches_jax():
    rng = np.random.default_rng(0)
    x, lam = rng.standard_normal(6), rng.standard_normal(2)
    hj, ht = j_with_hessians(_chain(jnp, 6)), t_with_hessians(_chain(torch, 6))
    _close(hj.d2f_dx2(jnp.asarray(x)), ht.d2f_dx2(_t(x)))
    _close(hj.d2g_dx2(jnp.asarray(x), jnp.asarray(lam)), ht.d2g_dx2(_t(x), _t(lam)))


# ------------------------------------------------- OCPs on groups, flattened


def _group(lib, name):
    g = jgroups if lib is jnp else tgroups
    return {"SE2": g.SE2, "SO3": g.SO3, "Bundle": g.Bundle(g.SE2, g.Rn(2))}[name]


def _ocp(lib, name, seed=7):
    """A smooth state- and input-dependent OCP on the group (as
    tests/test_ocp_flatten.py builds it), the nominal xl(t) = exp(t twist)
    (0 on an R^n part) and ul = 0.1."""
    G = _group(lib, name)
    rng = np.random.default_rng(seed)
    arr = (lambda a: jnp.asarray(a, jnp.float64)) if lib is jnp else _t
    Wx, wv = arr(rng.standard_normal((G.ndof, 2))), arr(rng.standard_normal(G.ndof))
    twist = arr(0.5 * rng.standard_normal(G.ndof))
    OCP = JOCP if lib is jnp else TOCP
    cat = jnp.concatenate if lib is jnp else torch.cat
    ocp = OCP(
        X=G, U=(jgroups if lib is jnp else tgroups).Rn(2),
        theta=lambda tf, x0, xf, q: tf * q[0] + (G.log(xf) ** 2).sum(),
        f=lambda t, x, u: 0.3 * lib.sin(G.log(x)) + Wx @ u + 0.2 * wv * lib.cos(t),
        g=lambda t, x, u: lib.stack([u @ u + (G.log(x) ** 2).sum()]),
        cr=lambda t, x, u: u * lib.cos(t),
        crl=arr(-np.ones(2)), cru=arr(np.ones(2)),
        ce=lambda tf, x0, xf, q: cat([tf[None], G.log(x0)]),
        cel=arr(np.zeros(1 + G.ndof)), ceu=arr(np.zeros(1 + G.ndof)),
    )
    xl = lambda t: G.exp(t * twist)
    ul = lambda t: arr([0.1, 0.1]) + 0.0 * t
    return ocp, xl, ul, twist


@pytest.mark.parametrize("name", ["SE2", "SO3", "Bundle"])
def test_flat_ocp_matches_jax(name):
    """The flat f, g, cr, theta and ce at random deviations, and the flat
    dynamics' Jacobian in (e, v), equal the JAX package's."""
    ocpj, xlj, ulj, _ = _ocp(jnp, name)
    ocpt, xlt, ult, _ = _ocp(torch, name)
    fj, ft = j_flatten(ocpj, xlj, ulj), t_flatten(ocpt, xlt, ult)
    nx = ocpt.X.ndof
    rng = np.random.default_rng(1)
    t, tf = 0.7, 1.9
    e, e2, v, q = (0.3 * rng.standard_normal(k) for k in (nx, nx, 2, 1))

    @jax.jit
    def jax_side(t, tf, e, e2, v, q):
        return (fj.f(t, e, v), fj.g(t, e, v), fj.cr(t, e, v), fj.theta(tf, e, e2, q),
                fj.ce(tf, e, e2, q), jax.jacfwd(lambda w: fj.f(t, w[:nx], w[nx:]))(
                    jnp.concatenate([e, v])))

    T = tuple(_t(a) for a in (t, tf, e, e2, v, q))
    torch_side = (ft.f(T[0], T[2], T[4]), ft.g(T[0], T[2], T[4]), ft.cr(T[0], T[2], T[4]),
                  ft.theta(T[1], T[2], T[3], T[5]), ft.ce(T[1], T[2], T[3], T[5]),
                  jacfwd(lambda w: ft.f(T[0], w[:nx], w[nx:]))(torch.cat([T[2], T[4]])))
    for a, b in zip(jax_side(*(jnp.asarray(a, jnp.float64) for a in (t, tf, e, e2, v, q))),
                    torch_side):
        _close(a, b)


def test_flat_dynamics_at_zero_and_unflatten():
    """At e = 0, v = 0 the flat dynamics are f - dxl (the nominal's defect),
    and unflatten_ocpsol composes with rplus as the JAX package does."""
    ocp, xl, ul, twist = _ocp(torch, "SE2")
    flat = t_flatten(ocp, xl, ul)
    t = _t(0.3)
    de = flat.f(t, torch.zeros(3, dtype=F64), torch.zeros(2, dtype=F64))
    torch.testing.assert_close(de, ocp.f(t, xl(t), ul(t)) - twist, atol=1e-12, rtol=0)

    ocpj, xlj, ulj, _ = _ocp(jnp, "SE2")
    e_traj = lambda lib: (lambda s: lib.stack([0.1 * s, 0.0 * s, -0.05 * s]))
    v_traj = lambda lib: (lambda s: lib.stack([0.01 * s, 0.02 * s]))
    sj = j_unflatten(JOCPSol(t0=0.0, tf=jnp.asarray(2.0), x=e_traj(jnp), u=v_traj(jnp)), ocpj, xlj, ulj)
    st = t_unflatten(TOCPSol(t0=0.0, tf=_t(2.0), x=e_traj(torch), u=v_traj(torch)), ocp, xl, ul)
    _close(sj.x(jnp.asarray(1.2)), st.x(_t(1.2)))
    _close(sj.u(jnp.asarray(1.2)), st.u(_t(1.2)))


def test_ocp_derivatives_self_check_passes():
    """The port's test_ocp_derivatives (first and second order against
    finite differences) passes on the group OCP and its flattening, twice
    from the same generator state (hidden state would show)."""
    from smooth_feedback_tpu_torch.ocp.ocp import test_ocp_derivatives as check

    ocp, xl, ul, _ = _ocp(torch, "SE2")
    for probe in (ocp, t_flatten(ocp, xl, ul)):
        for _ in range(2):
            check(probe, torch.Generator().manual_seed(5), num=2)


def test_ocp_derivatives_self_check_catches_bad_hessian():
    """A running cost whose first derivative is right and second is wrong
    (u^3 written as 3 u w^2 - 2 w^3 with w = u detached: the autodiff
    Hessian is 0, not 6u) is flagged."""
    from smooth_feedback_tpu_torch.ocp.ocp import test_ocp_derivatives as check

    ocp, _, _, _ = _ocp(torch, "SE2")

    def cube(u):
        w = u.detach()
        return 3.0 * u * w * w - 2.0 * w * w * w

    bad = ocp._replace(g=lambda t, x, u: torch.stack([cube(u[0]) + u @ u]))
    with pytest.raises(AssertionError):
        check(bad, torch.Generator().manual_seed(5), num=3)


# ---------------------------------------------------- the transcription


MESH = (1, 3)


@functools.lru_cache(maxsize=None)
def _sweep_nlps(k):
    """Member k of chip_smoke's velocity draw: the JAX package's flat NLP
    and the port's (chip_smoke.ocp_sweep_problem), float64."""
    vel = cs.ocp_sweep_velocities(4)[k]
    nj = oj.make_flat_nlp(JMesh.uniform(*MESH), jnp.asarray(vel))
    nt = cs.ocp_sweep_problem(TMesh.uniform(*MESH), F64, "cpu")(_t(vel))
    return nj, nt


def _point(nlp, seed):
    rng = np.random.default_rng(seed)
    z = 0.2 * rng.standard_normal(nlp.n)
    z[0] = 5.0
    return z, rng.standard_normal(nlp.m)


def test_nlp_layout_bounds_and_initial_guess_match_jax():
    nj, nt = _sweep_nlps(0)
    ocpj, ocpt = _flat_bundle_ocps()
    assert jtn.nlp_layout(ocpj, JMesh.uniform(*MESH)) == ttn.nlp_layout(ocpt, TMesh.uniform(*MESH))
    assert (nj.n, nj.m) == (nt.n, nt.m)
    for name in ("xl", "xu", "gl", "gu"):
        np.testing.assert_array_equal(np.asarray(getattr(nj, name)), getattr(nt, name).numpy())
    np.testing.assert_array_equal(
        np.asarray(jtn.nlp_initial_guess(ocpj, JMesh.uniform(*MESH), 4.5)),
        ttn.nlp_initial_guess(ocpt, TMesh.uniform(*MESH), 4.5).numpy(),
    )


@pytest.mark.parametrize("dtype", [None, torch.float32])
def test_initial_guess_follows_the_ocp_bounds(dtype):
    """nlp_initial_guess takes the dtype and device of the OCP's bounds
    (float64 here, not torch's float32 default), as ocp_to_nlp does, unless
    a dtype is given; node_scalings the dtype and device it is given."""
    _, ocpt = _flat_bundle_ocps()
    mesh = TMesh.uniform(*MESH)
    z0 = ttn.nlp_initial_guess(ocpt, mesh, 4.5, dtype)
    nlp = ttn.ocp_to_nlp(ocpt, mesh)
    want = ocpt.crl.dtype if dtype is None else dtype
    assert (z0.dtype, z0.device, z0.shape) == (want, ocpt.crl.device, (nlp.n,))
    if dtype is None:
        assert (nlp.xl.dtype, nlp.xl.device) == (z0.dtype, z0.device) == (F64, torch.device("cpu"))
    assert float(z0[ttn.nlp_layout(ocpt, mesh).tf_B]) == 4.5
    s = ttn.node_scalings(mesh, want, "cpu")
    assert (s.dtype, s.device, s.shape) == (want, torch.device("cpu"), (mesh.N_colloc,))


@functools.lru_cache(maxsize=None)
def _flat_bundle_ocps():
    """_ocp's SE(2) x R^2 problem flattened about the identity and u =
    0.01, in both packages: a flat OCP on R^5 x R^2 like the sweep's."""
    ocp_j, _, _, _ = _ocp(jnp, "Bundle")
    ocp_t, _, _, _ = _ocp(torch, "Bundle")
    xj = lambda t: ocp_j.X.identity()
    xt = lambda t: ocp_t.X.identity(dtype=F64)
    uj = lambda t: jnp.full(2, 0.01)
    ut = lambda t: torch.full((2,), 0.01, dtype=F64)
    return j_flatten(ocp_j, xj, uj), t_flatten(ocp_t, xt, ut)


@functools.lru_cache(maxsize=None)
def _jax_sweep_derivatives():
    """The JAX package's f, g, gradient, constraint Jacobian and Lagrangian
    Hessian of the sweep's NLP, one program for every member (the velocity
    is an argument)."""
    mesh = JMesh.uniform(*MESH)

    @jax.jit
    def jax_side(vel, x, lam):
        nj = oj.make_flat_nlp(mesh, vel)
        h = jax.hessian(lambda xx: nj.f(xx) + lam @ nj.g(xx))(x)
        return nj.f(x), nj.g(x), jax.grad(nj.f)(x), jax.jacrev(nj.g)(x), h

    return jax_side


@pytest.mark.parametrize("k", [0, 3])
def test_sweep_nlp_derivatives_match_jax(k):
    """f, g, the gradient, the constraint Jacobian and the Lagrangian
    Hessian of the sweep's NLP at a random point and multipliers."""
    _, nt = _sweep_nlps(k)
    z, lam = _point(nt, k)
    zt, lt = _t(z), _t(lam)
    vel = jnp.asarray(cs.ocp_sweep_velocities(4)[k])
    torch_side = (nt.f(zt), nt.g(zt), grad(nt.f)(zt), jacrev(nt.g)(zt),
                  hessian(lambda x: nt.f(x) + lt @ nt.g(x))(zt))
    for a, b in zip(_jax_sweep_derivatives()(vel, jnp.asarray(z), jnp.asarray(lam)), torch_side):
        _close(a, b)


def test_sweep_nlp_float32_hessian_stays_float32():
    """torch 2.13's forward mode gives a 0-d float32 tensor times a Python
    scalar a float64 tangent; the float32 transcription (hessian =
    jacfwd(jacrev)) stays float32 and lands within 1e-5 of float64
    (measured 3.9e-7 at |H| ~ 6 on this CPU)."""
    from chip_smoke import ocp_sweep_problem

    vel = cs.ocp_sweep_velocities(4)[1]
    n64 = ocp_sweep_problem(TMesh.uniform(*MESH), F64, "cpu")(_t(vel))
    n32 = ocp_sweep_problem(TMesh.uniform(*MESH), torch.float32, "cpu")(_t(vel).float())
    z, lam = _point(n64, 2)
    h64 = hessian(lambda x: n64.f(x) + _t(lam) @ n64.g(x))(_t(z))
    h32 = hessian(lambda x: n32.f(x) + _t(lam).float() @ n32.g(x))(_t(z).float())
    assert h32.dtype == torch.float32
    torch.testing.assert_close(h32.double(), h64, atol=1e-5, rtol=0)


def test_solution_round_trips_match_jax():
    """nlpsol_to_ocpsol then ocpsol_to_nlpsol with multipliers: on the same
    mesh the point and multipliers come back; on a refined mesh both
    packages sample the same warm start."""
    ocpj, ocpt = _flat_bundle_ocps()
    m1j, m1t = JMesh.uniform(*MESH), TMesh.uniform(*MESH)
    lay = ttn.nlp_layout(ocpt, m1t)
    z, lam = _point(lay, 4)
    zeros = np.zeros(lay.n)
    sol_j = JSol(status=0, iters=0, x=jnp.asarray(z), zl=jnp.asarray(zeros), zu=jnp.asarray(zeros),
                 lam=jnp.asarray(lam), objective=0.0, kkt_res=0.0)
    sol_t = TSol(status=0, iters=0, x=_t(z), zl=_t(zeros), zu=_t(zeros), lam=_t(lam),
                 objective=0.0, kkt_res=0.0)
    oj_, ot = jtn.nlpsol_to_ocpsol(ocpj, m1j, sol_j), ttn.nlpsol_to_ocpsol(ocpt, m1t, sol_t)
    z1, l1 = ttn.ocpsol_to_nlpsol(ocpt, m1t, ot, F64, multipliers=True)
    torch.testing.assert_close(z1, _t(z), atol=1e-12, rtol=0)
    torch.testing.assert_close(l1, _t(lam), atol=1e-12, rtol=0)
    m2j, m2t = JMesh.uniform(3, 4), TMesh.uniform(3, 4)
    z2j, l2j = jtn.ocpsol_to_nlpsol(ocpj, m2j, oj_, jnp.float64, multipliers=True)
    z2t, l2t = ttn.ocpsol_to_nlpsol(ocpt, m2t, ot, F64, multipliers=True)
    _close(z2j, z2t)
    _close(l2j, l2t)
