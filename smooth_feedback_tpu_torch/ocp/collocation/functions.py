"""Functions over a collocation mesh (PyTorch port of
``smooth_feedback_tpu/ocp/collocation/functions.py``).

Every mesh operation is an ordinary torch function of the stacked node
values; derivatives come from ``torch.func`` applied to these functions,
and per-node evaluation is one ``torch.func.vmap`` over the nodes.

Shapes: for a mesh with N collocation nodes,
  * ``X`` holds state (tangent) values at the N+1 node points: (N+1, nx)
  * ``U`` holds input values at the N collocation points: (N, nu)
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
from torch.func import vmap

from ..._precision import ieee_f32_matmul
from .mesh import (
    Mesh,
    bary_weights_colloc,
    bary_weights_plus_one,
    diffmat_local,
    lgr_nodes,
    lgr_plus_one,
)


def constant_like(a, ref, dtype=None):
    """numpy ``a`` as a tensor of ``ref``'s dtype (or ``dtype``) and device,
    made once per value: a copy from the host to the card waits for the
    card's queue, so the mesh's constants are not copied on every call."""
    a = np.ascontiguousarray(a)
    return _const(a.tobytes(), a.dtype.str, a.shape, dtype or ref.dtype, ref.device)


@functools.lru_cache(maxsize=1024)
def _const(data, np_dtype, shape, dtype, device):
    a = np.frombuffer(data, dtype=np_dtype).reshape(shape)
    # made outside any torch.func transform: a tensor made inside one is
    # that transform's wrapper, which must not outlive it in the cache
    with torch._C._DisableFuncTorch():
        return torch.as_tensor(a.copy(), dtype=dtype, device=device)


def mesh_eval(mesh: Mesh, fn: Callable, t0, tf, X, U):
    """Stack ``fn(t_i, x_i, u_i)`` over all N collocation nodes. Returns (N, nf)."""
    taus = constant_like(mesh.all_nodes()[:-1], X)
    ts = t0 + (tf - t0) * taus
    return vmap(fn)(ts, X[:-1], U)


def mesh_integrate(mesh: Mesh, fn: Callable, t0, tf, X, U):
    """Quadrature ``sum_i w_i (tf - t0) fn(t_i, x_i, u_i)``. Returns (nf,)."""
    w = constant_like(mesh.all_weights()[:-1], X)
    vals = mesh_eval(mesh, fn, t0, tf, X, U)
    with ieee_f32_matmul():
        return (tf - t0) * torch.einsum("i,i...->...", w, vals)


def global_diffmat(mesh: Mesh) -> np.ndarray:
    """Static dense (N, N+1) differentiation matrix of the whole mesh:
    ``dX/dtau at the N collocation nodes = global_diffmat(mesh) @ X``."""
    N = mesh.N_colloc
    Dfull = np.zeros((N, N + 1))
    offsets = mesh.interval_offsets()
    for ival in range(mesh.N_ivals):
        K = mesh.N_colloc_ival(ival)
        alpha, Dloc = mesh.interval_diffmat_unscaled(ival)  # Dloc: (K+1, K)
        o = int(offsets[ival])
        Dfull[o : o + K, o : o + K + 1] += alpha * Dloc.T
    return Dfull


def mesh_dyn(mesh: Mesh, f: Callable, t0, tf, X, U, weighted: bool = True):
    """Collocation dynamics defects at all N nodes. Returns (N, nx):

        d_i = w_i * ( (tf - t0) f(t_i, x_i, u_i) - dX/dtau (tau_i) )

    with ``w_i`` quadrature weights if ``weighted``."""
    F = mesh_eval(mesh, f, t0, tf, X, U)  # (N, nx)
    with ieee_f32_matmul():
        dX = constant_like(global_diffmat(mesh), X) @ X  # (N, nx)
    defect = (tf - t0) * F - dX
    if weighted:
        defect = constant_like(mesh.all_weights()[:-1], X)[:, None] * defect
    return defect


def mesh_dyn_error(mesh: Mesh, f: Callable, t0, tf, xfun: Callable, ufun: Callable):
    """Per-interval relative dynamics error of the trajectory callables
    ``xfun(t) -> (nx,)`` and ``ufun(t) -> (nu,)`` (typically interpolants of
    a solution on another mesh). Returns (N_ivals,)."""
    with ieee_f32_matmul():
        return _mesh_dyn_error_impl(mesh, f, t0, tf, xfun, ufun)


def _mesh_dyn_error_impl(mesh, f, t0, tf, xfun, ufun):
    tf = torch.as_tensor(tf)
    t0 = torch.as_tensor(t0, dtype=tf.dtype, device=tf.device)
    errs = []
    for i in range(mesh.N_ivals):
        K = mesh.N_colloc_ival(i)
        taus = constant_like(mesh.interval_nodes(i), tf)  # (K+1,)
        ts = t0 + (tf - t0) * taus
        Xval = vmap(xfun)(ts)  # (K+1, nx)
        Uval = vmap(ufun)(ts)
        Fval = vmap(f)(ts, Xval, Uval)  # (K+1, nx)
        Imat = constant_like(mesh.interval_intmat(i), Fval)  # (K, K)
        # "integrate" the dynamics forward within the interval
        Xest = Xval[0][None, :] + (tf - t0) * torch.einsum("ik,kn->in", Imat.T, Fval[:K])
        e_abs = torch.linalg.vector_norm(Xest - Xval[1:], dim=1)
        scale = 1.0 + torch.linalg.vector_norm(Xval[1:], dim=1).max()
        errs.append((e_abs / scale).max())
    return torch.stack(errs)


# ------------------------------------------------------------- interpolation


def _bary_eval(tnodes: np.ndarray, wb: np.ndarray, vals, u):
    """Barycentric Lagrange evaluation at ``u`` in its first
    (modified-Lagrange) form, a plain polynomial in ``u``: exact at the
    nodes, and its derivatives in ``u`` are right there too."""
    tn = constant_like(tnodes, vals)
    w = constant_like(wb, vals)
    d = u - tn
    K = tn.shape[0]
    off_diag = constant_like(~np.eye(K, dtype=bool), vals, torch.bool)
    # prods[k] = prod_{j != k} (u - t_j)
    prods = torch.prod(torch.where(off_diag, d[None, :], torch.ones_like(d)[None, :]), dim=1)
    lw = w * prods
    return torch.einsum("k,k...->...", lw, vals) / lw.sum()


def mesh_interp(mesh: Mesh, values, tau, extend: bool = True, deriv: int = 0):
    """Evaluate the mesh polynomial defined by node ``values`` at ``tau``.

    ``values`` has shape (N+1, d) if ``extend`` else (N, d); ``tau`` is a
    0-d tensor in [0, 1] (clamped outside).  ``deriv`` is any order >= 0
    (orders beyond the local polynomial degree return 0).  Runs under
    ``torch.func.vmap`` over ``tau``: every interval's polynomial is
    evaluated and the one holding ``tau`` selected (the JAX package's
    ``lax.switch`` on the interval index)."""
    if deriv < 0:
        raise ValueError("deriv must be >= 0")
    with ieee_f32_matmul():
        return _mesh_interp_impl(mesh, values, tau, extend, deriv)


def _mesh_interp_impl(mesh: Mesh, values, tau, extend: bool, deriv: int):
    tau = tau.to(values.dtype) if torch.is_tensor(tau) else constant_like(tau, values)
    # 1-element: a 0-d float32 tensor less a Python scalar gets a float64
    # tangent in torch's forward mode (see groups/_series.py)
    tau = torch.clamp(tau, 0.0, 1.0).reshape(1)
    starts = constant_like([t for _, t in mesh.intervals], values)
    # searchsorted(starts, tau, side="right") - 1, as a comparison count
    ival = torch.clamp((starts <= tau).sum() - 1, 0, mesh.N_ivals - 1)
    offsets = mesh.interval_offsets()

    def branch(i):
        K = mesh.intervals[i][0]
        tau0, tauf = mesh.interval_bounds(i)
        o = int(offsets[i])
        use_short = i == mesh.N_ivals - 1 and not extend  # no value at the final node
        u = (tau - tau0) / (tauf - tau0)
        if use_short:
            tn, wb, vals = lgr_nodes(K)[0], bary_weights_colloc(K), values[o : o + K]
        else:
            tn, wb, vals = lgr_plus_one(K)[0], bary_weights_plus_one(K), values[o : o + K + 1]
        if deriv == 0:
            return _bary_eval(tn, wb, vals, u)
        # derivative values at the K collocation nodes (one static matrix
        # assembled on the host for any order), then interpolate those
        Dc = _colloc_diffmat(K)
        if use_short:
            D = np.linalg.matrix_power(Dc, deriv)  # degree K-1 on the K LGR nodes
        else:
            D = diffmat_local(K) @ np.linalg.matrix_power(Dc, deriv - 1)  # (K+1, K)
        dvals = torch.einsum("jk,j...->k...", constant_like(D, vals), vals)
        out = _bary_eval(lgr_nodes(K)[0], bary_weights_colloc(K), dvals, u)
        return out / (tauf - tau0) ** deriv  # chain rule to the [0, 1] scale

    out = branch(mesh.N_ivals - 1)
    for i in range(mesh.N_ivals - 2, -1, -1):
        out = torch.where(ival == i, branch(i), out)
    return out


def _colloc_diffmat(K: int) -> np.ndarray:
    """(K, K) derivative matrix over the K LGR nodes (degree K-1 basis)."""
    t, _ = lgr_nodes(K)
    w = 1.0 / np.array(
        [np.prod([t[j] - t[k] for k in range(K) if k != j]) for j in range(K)]
    )
    Dfull = np.zeros((K, K))
    for i in range(K):
        for j in range(K):
            if i != j:
                Dfull[i, j] = (w[j] / w[i]) / (t[i] - t[j])
        Dfull[i, i] = -np.sum(Dfull[i, :])
    return Dfull.T.copy()  # (K, K): column i = derivative at t_i
