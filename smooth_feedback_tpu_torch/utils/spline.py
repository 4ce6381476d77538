"""Cubic splines on Lie groups (PyTorch port of
``smooth_feedback_tpu/utils/spline.py``).

Each segment is a cubic Hermite polynomial p(s) in the tangent space at its
left knot, ``g(t) = g_i (+) p(s)``, ``s = (t - t_i) / h_i``, with endpoint
derivatives chosen so that the body velocity ``v = dr_exp(p) p'(s) / h``
matches the knot velocities.  ``fit_spline`` picks the knot velocities:
Catmull-Rom central differences (``c2=False``, C^1), or Newton on the
body-acceleration jumps at interior knots with natural end conditions
(``c2=True``).  Velocity and acceleration at any time come from nested
forward-mode derivatives in time.

Times enter the differentiated functions as 1-element tensors, never 0-d
ones: torch 2.13's forward mode gives a 0-d float32 tensor times a Python
scalar a float64 tangent (``groups/_series.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .._precision import ieee_f32_matmul
from ..groups.base import LieGroup


class LieSpline(NamedTuple):
    ts: np.ndarray  # (K,) knot times (static)
    gs: torch.Tensor  # (K, nparams) knot poses
    deltas: torch.Tensor  # (K-1, ndof)  log(g_i^{-1} g_{i+1})
    m0: torch.Tensor  # (K-1, ndof)  p'(0) per segment
    m1: torch.Tensor  # (K-1, ndof)  p'(1) per segment


def _d1(fn, s):
    """d fn / d s for a 1-element time ``s``: the (ndof,) derivative."""
    return jacfwd(fn)(s)[..., 0].to(s.dtype)


def _hermite(s, m0, d, m1):
    """Cubic Hermite with p(0) = 0, p(1) = d, p'(0) = m0, p'(1) = m1."""
    s2 = s * s
    s3 = s2 * s
    return (s3 - 2 * s2 + s) * m0 + (-2 * s3 + 3 * s2) * d + (s3 - s2) * m1


def _spline_from_velocities(G: LieGroup, ts, gs, deltas, vs) -> LieSpline:
    hs = torch.as_tensor(np.diff(ts), dtype=gs.dtype, device=gs.device)
    m0 = hs[:, None] * vs[:-1]
    m1 = hs[:, None] * vmap(lambda d, v: G.dr_expinv(d) @ v)(deltas, vs[1:])
    return LieSpline(ts=np.asarray(ts, dtype=float), gs=gs, deltas=deltas, m0=m0, m1=m1)


def _catmull_rom_velocities(deltas, hs):
    v_seg = deltas / hs[:, None]
    if deltas.shape[0] == 1:
        return torch.cat([v_seg, v_seg])
    v_mid = 0.5 * (v_seg[:-1] + v_seg[1:])
    return torch.cat([v_seg[:1], v_mid, v_seg[-1:]])


def fit_spline(
    G: LieGroup,
    ts: Sequence[float],
    gs: torch.Tensor,
    c2: bool = True,
    newton_iters: int = 8,
) -> LieSpline:
    """Fit a cubic through knot poses ``gs`` (K, nparams) at times ``ts``;
    ``c2=True`` makes the body acceleration continuous at interior knots,
    with natural end conditions."""
    with ieee_f32_matmul():
        return _fit_spline_impl(G, ts, gs, c2, newton_iters)


def _fit_spline_impl(G, ts, gs, c2, newton_iters):
    ts = np.asarray(ts, dtype=float)
    K = len(ts)
    if K < 2:
        raise ValueError("need at least two knots")
    kw = dict(dtype=gs.dtype, device=gs.device)
    hs = torch.as_tensor(np.diff(ts), **kw)
    deltas = vmap(G.rminus)(gs[1:], gs[:-1])  # (K-1, ndof), tangent at g_i

    vs = _catmull_rom_velocities(deltas, hs)
    if not c2 or K == 2:
        return _spline_from_velocities(G, ts, gs, deltas, vs)

    nd = G.ndof

    def seg_accel(d, m0, m1, h, s):
        """Body acceleration of one segment at local parameter s (exact)."""
        p = lambda sv: _hermite(sv, m0, d, m1)
        v = lambda sv: (G.dr_exp(p(sv)) @ _d1(p, sv)) / h
        return _d1(v, s) / h

    ends = torch.ones((1,), **kw), torch.zeros((1,), **kw)

    def residual(vs_flat):
        vs_ = vs_flat.reshape(K, nd)
        m0 = hs[:, None] * vs_[:-1]
        m1 = hs[:, None] * vmap(lambda d, v: G.dr_expinv(d) @ v)(deltas, vs_[1:])
        a_at = vmap(seg_accel, in_dims=(0, 0, 0, 0, None))
        a_left = a_at(deltas, m0, m1, hs, ends[0])  # (K-1, nd): end of each segment
        a_right = a_at(deltas, m0, m1, hs, ends[1])  # (K-1, nd): start of each segment
        jumps = a_right[1:] - a_left[:-1]  # interior knots (K-2, nd)
        return torch.cat([a_right[0], jumps.reshape(-1), a_left[-1]])

    x = vs.reshape(-1)
    eye = torch.eye(x.shape[0], **kw)
    for _ in range(newton_iters):
        r = residual(x)
        if float(r.abs().max()) < 1e-10:
            break
        J = jacfwd(residual)(x).to(x.dtype)
        x = x + torch.linalg.solve(J + 1e-10 * eye, -r)
    return _spline_from_velocities(G, ts, gs, deltas, x.reshape(K, nd))


def spline_pos(G: LieGroup, sp: LieSpline, t):
    """The spline's position at time ``t`` (0-d or 1-element tensor)."""
    ts = torch.as_tensor(sp.ts, dtype=sp.deltas.dtype, device=sp.deltas.device)
    K = len(sp.ts)
    t = torch.clamp(t, float(sp.ts[0]), float(sp.ts[-1]))
    i = torch.clamp(torch.searchsorted(ts, t.reshape(1).detach(), right=True) - 1, 0, K - 2)[0]
    s = (t - ts[i]) / (ts[i + 1] - ts[i])
    return G.rplus(sp.gs[i], _hermite(s, sp.m0[i], sp.deltas[i], sp.m1[i]))


def spline_eval(G: LieGroup, sp: LieSpline, t):
    """``(g, body velocity, body acceleration)`` at time ``t`` (the PID
    trajectory interface)."""
    t = torch.as_tensor(t, dtype=sp.deltas.dtype, device=sp.deltas.device).reshape(1)
    with ieee_f32_matmul():
        g = spline_pos(G, sp, t)

        def vel(tt):
            return _d1(
                lambda dh: G.rminus(spline_pos(G, sp, tt + dh), spline_pos(G, sp, tt)),
                torch.zeros_like(tt),
            )

        return g, vel(t), _d1(vel, t)
