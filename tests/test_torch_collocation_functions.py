"""Functions over a collocation mesh, port against the JAX package:
mesh_eval, mesh_integrate, global_diffmat, mesh_dyn, mesh_dyn_error and
mesh_interp (every order, with and without the final node, under vmap
over the interpolation times, and its autodiff derivative in time), on
the same numpy inputs, float64, within 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from smooth_feedback_tpu.ocp.collocation import Mesh as JMesh
from smooth_feedback_tpu.ocp.collocation import functions as jfn
from smooth_feedback_tpu_torch.ocp.collocation import Mesh as TMesh
from smooth_feedback_tpu_torch.ocp.collocation import functions as tfn

torch.set_num_threads(1)

TOL = 1e-10
MESHES = {
    "uniform(2, 4)": ((4, 0.0), (4, 0.5)),
    "uneven": ((3, 0.0), (6, 0.3), (5, 0.8)),
}


def _meshes(name):
    ivs = MESHES[name]
    return JMesh(Kmin=3, Kmax=10, intervals=ivs), TMesh(Kmin=3, Kmax=10, intervals=ivs)


def _fn(lib):
    """(t, x, u) -> (2,): smooth, nonlinear in every argument."""
    return lambda t, x, u: lib.stack([lib.sin(t) * x[0] + u[0] * x[1], x[1] * u[0] ** 2 + t])


def _data(mesh, seed=0):
    rng = np.random.default_rng(seed)
    N = mesh.N_colloc
    return rng.standard_normal((N + 1, 2)), rng.standard_normal((N, 1))


def _t(a):
    return torch.tensor(a, dtype=torch.float64)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_eval_and_integrate_match_jax(name):
    jm, tm = _meshes(name)
    X, U = _data(jm)
    t0, tf = 0.3, 1.7
    _close(jfn.mesh_eval(jm, _fn(jnp), t0, tf, jnp.asarray(X), jnp.asarray(U)),
           tfn.mesh_eval(tm, _fn(torch), _t(t0), _t(tf), _t(X), _t(U)))
    _close(jfn.mesh_integrate(jm, _fn(jnp), t0, tf, jnp.asarray(X), jnp.asarray(U)),
           tfn.mesh_integrate(tm, _fn(torch), _t(t0), _t(tf), _t(X), _t(U)))
    np.testing.assert_array_equal(jfn.global_diffmat(jm), tfn.global_diffmat(tm))


@pytest.mark.parametrize("weighted", [True, False])
def test_mesh_dyn_matches_jax(weighted):
    jm, tm = _meshes("uneven")
    X, U = _data(jm, 1)
    _close(jfn.mesh_dyn(jm, _fn(jnp), 0.0, 2.5, jnp.asarray(X), jnp.asarray(U), weighted),
           tfn.mesh_dyn(tm, _fn(torch), _t(0.0), _t(2.5), _t(X), _t(U), weighted))


def test_mesh_dyn_error_matches_jax():
    """The per-interval error of trajectories that do not satisfy the
    dynamics (nonzero, different in every interval)."""
    jm, tm = _meshes("uneven")

    def traj(lib):
        return (lambda t: lib.stack([lib.sin(t), lib.cos(2.0 * t)]),
                lambda t: lib.stack([t * t]))

    ej = jfn.mesh_dyn_error(jm, _fn(jnp), 0.0, 2.0, *traj(jnp))
    et = tfn.mesh_dyn_error(tm, _fn(torch), 0.0, _t(2.0), *traj(torch))
    assert bool(np.all(np.asarray(ej) > 1e-4))
    _close(ej, et)


TAUS = np.array([-0.1, 0.0, 0.05, 0.3, 0.31, 0.5, 0.77, 0.8, 0.95, 1.0, 1.2])


@pytest.mark.parametrize("extend", [True, False])
@pytest.mark.parametrize("deriv", [0, 1, 2])
def test_mesh_interp_matches_jax(extend, deriv):
    """At node times, interval boundaries, inside and outside [0, 1]
    (clamped), one vmap over the times on each side."""
    jm, tm = _meshes("uneven")
    X, U = _data(jm, 2)
    V = X if extend else np.concatenate([U, 2.0 * U], axis=1)
    vj = jax.vmap(lambda t: jfn.mesh_interp(jm, jnp.asarray(V), t, extend, deriv))(jnp.asarray(TAUS))
    vt = vmap(lambda t: tfn.mesh_interp(tm, _t(V), t, extend, deriv))(_t(TAUS))
    _close(vj, vt)


def test_mesh_interp_time_derivative_matches_jax():
    """Autodiff in time inside (0, 1), where the clamp is inactive: JAX's
    jacfwd, the port's jacfwd and the analytic first derivative agree."""
    jm, tm = _meshes("uneven")
    X, _ = _data(jm, 3)
    inner = TAUS[(TAUS > 0.0) & (TAUS < 1.0)]
    dj = jax.vmap(jax.jacfwd(lambda t: jfn.mesh_interp(jm, jnp.asarray(X), t)))(jnp.asarray(inner))
    dt = vmap(jacfwd(lambda t: tfn.mesh_interp(tm, _t(X), t)))(_t(inner))
    _close(dj, dt)
    d1 = vmap(lambda t: tfn.mesh_interp(tm, _t(X), t, deriv=1))(_t(inner))
    np.testing.assert_allclose(dt.numpy(), d1.numpy(), atol=1e-9)


@pytest.mark.parametrize("transform", ["hessian", "vmap"])
def test_constants_first_made_inside_a_transform_stay_plain(transform):
    """A mesh constant first made inside a torch.func transform is cached as
    a plain tensor, not as that transform's wrapper: later calls outside the
    transform (and inside others) use it.  The mesh is one no other test
    builds, so its constants are made here first."""
    from torch.func import grad, hessian

    mesh = TMesh(intervals=((4, 0.0), (2, 0.3)))
    X = torch.linspace(0.0, 1.0, mesh.N_colloc + 1, dtype=torch.float64)[:, None]
    U = torch.zeros((mesh.N_colloc, 1), dtype=torch.float64)
    fn = lambda t, x, u: x * x + t

    def integral(tf):
        return tfn.mesh_integrate(mesh, fn, torch.zeros_like(tf), tf, X, U)[0]

    tf = torch.tensor(2.0, dtype=torch.float64)
    if transform == "hessian":
        hessian(integral)(tf)
    else:
        vmap(integral)(tf[None])
    w = np.asarray(mesh.all_weights()[:-1])
    tau = np.asarray(mesh.all_nodes()[:-1])
    x2 = X[:-1, 0].numpy() ** 2
    # integral(tf) = tf sum w (x^2 + tf tau); its derivative sum w (x^2 + 2 tf tau)
    np.testing.assert_allclose(float(integral(tf)), 2.0 * (w * (x2 + 2.0 * tau)).sum(), rtol=1e-12)
    np.testing.assert_allclose(float(grad(integral)(tf)), (w * (x2 + 4.0 * tau)).sum(), rtol=1e-12)
    np.testing.assert_allclose(float(vmap(hessian(integral))(tf[None])[0]), 2.0 * (w * tau).sum(),
                               rtol=1e-12)
