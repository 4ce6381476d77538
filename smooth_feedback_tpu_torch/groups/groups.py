"""Concrete Lie groups (PyTorch port): ``Rn``, ``SO2``, ``SO3``, ``SE2``,
``SE3`` and ``Bundle``.

Storage and tangent layouts follow ``smooth_feedback_tpu/groups/groups.py``:

=======  ==========  ====  =====================================
Group    nparams     ndof  storage
=======  ==========  ====  =====================================
Rn(n)    n           n     the vector itself
SO2      2           1     unit complex ``[re, im]``
SO3      4           3     unit quaternion ``[x, y, z, w]``
SE2      4           3     ``[tx, ty, re, im]``; tangent ``[vx, vy, w]``
SE3      7           6     ``[tx, ty, tz, qx, qy, qz, qw]``; tangent ``[v, w]``
Bundle   sum         sum   the parts' storages concatenated
=======  ==========  ====  =====================================

Closed forms are given for the hot operations; the rest inherits the
``torch.func.jacfwd`` fallbacks of :class:`~.base.LieGroup`.  Every operation
is written with ``torch.stack``/``torch.cat`` on the element's entries and no
Python branch on values, so it runs under ``torch.func.vmap``.  SO3 and SE3
work on 1-d slices of the element (``q[3:]``, never ``q[3]``) wherever a
Python scalar enters, for the forward-mode fault ``_series`` describes.

The second-order derivatives ``d2r_exp``/``d2r_expinv`` (layout
``out[i, j, k] = d dr_exp(v)[i, j] / d v_k``) have closed forms on every
group: the Jacobians are polynomials in a matrix linear in ``v`` (``hat``,
``ad``) with coefficients in ``|w|^2``, so each product is differentiated
with the constant generators and each coefficient through the ``d*``
series.  Their matrix products, and those of SO3's and SE3's first-order
Jacobians they reuse, are broadcast sums (``_mm``), never ``matmul``, so
they keep float32's precision on a GPU whatever
``torch.backends.cuda.matmul.allow_tf32`` says (a TF32 product carries
~1e-3 relative error into the hat-product chains).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _series as se
from .base import LieGroup


class Rn(LieGroup):
    """Euclidean translation group R^n (commutative)."""

    def __init__(self, n: int):
        self.n = int(n)
        self.nparams = self.n
        self.ndof = self.n

    def _key(self):
        return ("Rn", self.n)

    def identity(self, dtype=None, device=None):
        return torch.zeros((self.n,), dtype=dtype, device=device)

    def exp(self, v):
        return v

    def log(self, g):
        return g

    def compose(self, a, b):
        return a + b

    def inverse(self, g):
        return -g

    def Ad(self, g):
        return torch.eye(self.n, dtype=g.dtype, device=g.device)

    def ad(self, v):
        return torch.zeros((self.n, self.n), dtype=v.dtype, device=v.device)

    def dr_exp(self, v):
        return torch.eye(self.n, dtype=v.dtype, device=v.device)

    def dr_expinv(self, v):
        return torch.eye(self.n, dtype=v.dtype, device=v.device)

    def d2r_exp(self, v):
        return torch.zeros((self.n,) * 3, dtype=v.dtype, device=v.device)

    def d2r_expinv(self, v):
        return torch.zeros((self.n,) * 3, dtype=v.dtype, device=v.device)

    def is_commutative(self):
        return True


def _mat(rows):
    """A matrix from rows of 0-d or 1-element tensors."""
    return torch.stack([torch.stack(r) for r in rows]).reshape(len(rows), -1)


class _SO2(LieGroup):
    """Planar rotations, stored as a unit complex number ``[re, im]``."""

    nparams = 2
    ndof = 1

    def identity(self, dtype=None, device=None):
        return torch.tensor([1.0, 0.0], dtype=dtype, device=device)

    def exp(self, v):
        w = v[0]
        return torch.stack([torch.cos(w), torch.sin(w)])

    def log(self, g):
        return torch.atan2(g[1], g[0])[None]

    def compose(self, a, b):
        re = a[0] * b[0] - a[1] * b[1]
        im = a[0] * b[1] + a[1] * b[0]
        return torch.stack([re, im])

    def inverse(self, g):
        return torch.stack([g[0], -g[1]])

    def Ad(self, g):
        return torch.ones((1, 1), dtype=g.dtype, device=g.device)

    def ad(self, v):
        return torch.zeros((1, 1), dtype=v.dtype, device=v.device)

    def dr_exp(self, v):
        return torch.ones((1, 1), dtype=v.dtype, device=v.device)

    def dr_expinv(self, v):
        return torch.ones((1, 1), dtype=v.dtype, device=v.device)

    def d2r_exp(self, v):
        return torch.zeros((1, 1, 1), dtype=v.dtype, device=v.device)

    def d2r_expinv(self, v):
        return torch.zeros((1, 1, 1), dtype=v.dtype, device=v.device)

    def normalize(self, g):
        return g / torch.linalg.vector_norm(g)

    def matrix(self, g):
        return _mat([[g[0], -g[1]], [g[1], g[0]]])

    def is_commutative(self):
        return True


def _sq(v):
    """``v @ v`` as a 1-element tensor."""
    return (v * v).sum(dim=0, keepdim=True)


def _mm(a, b):
    """Matrix product over the last axis of ``a`` and the second last of
    ``b``, leading axes broadcast, as a broadcast sum (no TF32 on a GPU)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(dim=-2)


def _d_products(G, A):
    """(i, l, k) stack of d(A A)/d v_k for A linear in v with generators
    G[k] = dA/dv_k: G[k] A + A G[k]."""
    return torch.movedim(_mm(G, A) + _mm(A, G), 0, -1)


def _d2r_form(A, G, dc_lin, c_lin, dc_sq, c_sq):
    """d/dv_k of ``c_lin A + c_sq A^2`` (the Jacobians' shared polynomial
    form) with ``dc_*`` the coefficients' gradients: (i, j, k)."""
    return (A[:, :, None] * dc_lin[None, None, :] + c_lin * torch.movedim(G, 0, -1)
            + _mm(A, A)[:, :, None] * dc_sq[None, None, :] + c_sq * _d_products(G, A))


def _hat3(w):
    """3x3 skew matrix of a 3-vector."""
    x, y, z = w[0:1], w[1:2], w[2:3]
    o = torch.zeros_like(x)
    return _mat([[o, -z, y], [z, o, -x], [-y, x, o]])


def _so3_generators(dtype=None, device=None):
    """(3, 3, 3) stack with G[k] = d hat(v)/d v_k (the so(3) basis)."""
    return torch.stack([_hat3(e) for e in torch.eye(3, dtype=dtype, device=device)])


def _quat_mul(a, b):
    """Hamilton product; storage [x, y, z, w]."""
    ax, ay, az, aw = a[0:1], a[1:2], a[2:3], a[3:4]
    bx, by, bz, bw = b[0:1], b[1:2], b[2:3], b[3:4]
    return torch.cat([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _quat_rotmat(q):
    x, y, z, w = q[0:1], q[1:2], q[2:3], q[3:4]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return _mat([
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ])


class _SO3(LieGroup):
    """3-D rotations, stored as a unit quaternion ``[x, y, z, w]``."""

    nparams = 4
    ndof = 3

    def identity(self, dtype=None, device=None):
        return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)

    def exp(self, v):
        th2 = _sq(v)
        xyz = 0.5 * se.sinc2(0.25 * th2) * v  # sin(th/2)/th * v
        return torch.cat([xyz, se.cos2(0.25 * th2)])

    def log(self, q):
        # principal log: flip the sign so that the scalar part is nonnegative
        neg = q[3:] < 0
        xyz = torch.where(neg, -q[:3], q[:3])
        w = torch.where(neg, -q[3:], q[3:])
        n2 = _sq(xyz)
        small = n2 < 1e-12
        n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
        # th/n with th = 2 atan2(n, w); for small n, th/n ~ (2/w)(1 - n^2/(3w^2))
        scale_exact = 2.0 * torch.atan2(n, w) / n
        scale_small = 2.0 / torch.clamp(w, min=1e-12) * (1.0 - n2 / (3.0 * w * w))
        return torch.where(small, scale_small, scale_exact) * xyz

    def compose(self, a, b):
        return _quat_mul(a, b)

    def inverse(self, q):
        return torch.cat([-q[:3], q[3:]])

    def Ad(self, q):
        return _quat_rotmat(q)

    def ad(self, v):
        return _hat3(v)

    def dr_exp(self, v):
        th2 = _sq(v)
        H = _hat3(v)
        eye = torch.eye(3, dtype=v.dtype, device=v.device)
        return eye - se.cos1c2(th2) * H + se.sin3c2(th2) * _mm(H, H)

    def dr_expinv(self, v):
        th2 = _sq(v)
        H = _hat3(v)
        eye = torch.eye(3, dtype=v.dtype, device=v.device)
        return eye + 0.5 * H + se.jlinv2c2(th2) * _mm(H, H)

    # d/dv of the coefficient forms above; grad_v c(|v|^2) = 2 c'(|v|^2) v
    def d2r_exp(self, v):
        th2 = _sq(v)
        G = _so3_generators(v.dtype, v.device)  # G[k] = d hat(v) / d v_k
        return _d2r_form(_hat3(v), G, -2.0 * se.dcos1c2(th2) * v, -se.cos1c2(th2),
                         2.0 * se.dsin3c2(th2) * v, se.sin3c2(th2))

    def d2r_expinv(self, v):
        th2 = _sq(v)
        G = _so3_generators(v.dtype, v.device)
        return _d2r_form(_hat3(v), G, torch.zeros_like(v), 0.5 * torch.ones_like(th2),
                         2.0 * se.djlinv2c2(th2) * v, se.jlinv2c2(th2))

    def normalize(self, q):
        return q / torch.linalg.vector_norm(q)

    def matrix(self, q):
        return _quat_rotmat(q)

    def hat(self, v):
        return _hat3(v)


# G[k] = d ad(v) / d v_k, the se(2) adjoint basis
_SE2_GENERATORS = np.zeros((3, 3, 3))
_SE2_GENERATORS[0, 1, 2] = -1.0
_SE2_GENERATORS[1, 0, 2] = 1.0
_SE2_GENERATORS[2, 0, 1], _SE2_GENERATORS[2, 1, 0] = -1.0, 1.0


class _SE2(LieGroup):
    """Planar rigid motions; storage ``[tx, ty, re, im]``, tangent ``[vx, vy, w]``."""

    nparams = 4
    ndof = 3

    def identity(self, dtype=None, device=None):
        return torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=dtype, device=device)

    def _rot(self, g):
        return _mat([[g[2], -g[3]], [g[3], g[2]]])

    # exp and log keep the angle 1-d (see _series: a 0-d tensor times a
    # Python scalar gets a float64 tangent under forward-mode autodiff)
    def exp(self, v):
        rho, w = v[:2], v[2:]
        A = se.sinc(w)
        Bw = se.cos1c(w) * w
        V = torch.stack([torch.cat([A, -Bw]), torch.cat([Bw, A])])
        t = V @ rho
        return torch.cat([t, torch.cos(w), torch.sin(w)])

    def log(self, g):
        w = torch.atan2(g[3:], g[2:3])
        al = se.acos_over_sinc(w)  # A/(2B)
        hw = 0.5 * w
        Vinv = torch.stack([torch.cat([al, hw]), torch.cat([-hw, al])])
        rho = Vinv @ g[:2]
        return torch.cat([rho, w])

    def compose(self, a, b):
        t = a[:2] + self._rot(a) @ b[:2]
        re = a[2] * b[2] - a[3] * b[3]
        im = a[2] * b[3] + a[3] * b[2]
        return torch.cat([t, torch.stack([re, im])])

    def inverse(self, g):
        Rt = self._rot(g).T
        return torch.cat([-(Rt @ g[:2]), torch.stack([g[2], -g[3]])])

    def Ad(self, g):
        z, o = torch.zeros_like(g[0]), torch.ones_like(g[0])
        return _mat([[g[2], -g[3], g[1]], [g[3], g[2], -g[0]], [z, z, o]])

    def ad(self, v):
        w = v[2]
        z = torch.zeros_like(w)
        return _mat([[z, -w, v[1]], [w, z, -v[0]], [z, z, z]])

    # The se(2) adjoint matrix A = ad(v) satisfies A^3 = -w^2 A, so the SO(3)
    # coefficient functions apply:
    #   dr_exp(v)    = I - cos1c(w) A + sin3c(w) A^2
    #   dr_expinv(v) = I + A/2 + jlinv2c(w) A^2
    def dr_exp(self, v):
        w2 = v[2] * v[2]
        A = self.ad(v)
        eye = torch.eye(3, dtype=v.dtype, device=v.device)
        return eye - se.cos1c2(w2) * A + se.sin3c2(w2) * (A @ A)

    def dr_expinv(self, v):
        w2 = v[2] * v[2]
        A = self.ad(v)
        eye = torch.eye(3, dtype=v.dtype, device=v.device)
        return eye + 0.5 * A + se.jlinv2c2(w2) * (A @ A)

    # second order: A is linear in v with constant generators, and the
    # coefficients depend on v only through w = v[2] (a 1-element view)
    def d2r_exp(self, v):
        w = v[2:]
        w2 = w * w
        G = torch.as_tensor(_SE2_GENERATORS, dtype=v.dtype, device=v.device)
        dw = torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype, device=v.device) * (2.0 * w)
        return _d2r_form(self.ad(v), G, -se.dcos1c2(w2) * dw, -se.cos1c2(w2),
                         se.dsin3c2(w2) * dw, se.sin3c2(w2))

    def d2r_expinv(self, v):
        w = v[2:]
        w2 = w * w
        G = torch.as_tensor(_SE2_GENERATORS, dtype=v.dtype, device=v.device)
        dw = torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype, device=v.device) * (2.0 * w)
        return _d2r_form(self.ad(v), G, torch.zeros_like(v), 0.5 * torch.ones_like(w2),
                         se.djlinv2c2(w2) * dw, se.jlinv2c2(w2))

    def normalize(self, g):
        return torch.cat([g[:2], g[2:] / torch.linalg.vector_norm(g[2:])])

    def matrix(self, g):
        z, o = torch.zeros_like(g[0]), torch.ones_like(g[0])
        return _mat([[g[2], -g[3], g[0]], [g[3], g[2], g[1]], [z, z, o]])


class _SE3(LieGroup):
    """Rigid motions in 3-D; storage ``[t(3), q(4)]``, tangent ``[v(3), w(3)]``."""

    nparams = 7
    ndof = 6

    def identity(self, dtype=None, device=None):
        return torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)

    def exp(self, x):
        v, w = x[:3], x[3:]
        th2 = _sq(w)
        H = _hat3(w)
        # left Jacobian of SO(3)
        eye = torch.eye(3, dtype=x.dtype, device=x.device)
        Jl = eye + se.cos1c2(th2) * H + se.sin3c2(th2) * (H @ H)
        return torch.cat([Jl @ v, SO3.exp(w)])

    def log(self, g):
        t, q = g[:3], g[3:]
        w = SO3.log(q)
        th2 = _sq(w)
        H = _hat3(w)
        eye = torch.eye(3, dtype=g.dtype, device=g.device)
        Jlinv = eye - 0.5 * H + se.jlinv2c2(th2) * (H @ H)
        return torch.cat([Jlinv @ t, w])

    def compose(self, a, b):
        t = a[:3] + _quat_rotmat(a[3:]) @ b[:3]
        return torch.cat([t, _quat_mul(a[3:], b[3:])])

    def inverse(self, g):
        qi = SO3.inverse(g[3:])
        return torch.cat([-(_quat_rotmat(qi) @ g[:3]), qi])

    @staticmethod
    def _blocks(a, b, c):
        """The 6x6 matrix [[a, b], [0, c]] of 3x3 blocks."""
        z = torch.zeros_like(a)
        return torch.cat([torch.cat([a, b], dim=1), torch.cat([z, c], dim=1)])

    def Ad(self, g):
        R = _quat_rotmat(g[3:])
        return self._blocks(R, _hat3(g[:3]) @ R, R)

    def ad(self, x):
        hw = _hat3(x[3:])
        return self._blocks(hw, _hat3(x[:3]), hw)

    # Closed-form right Jacobians via the Q-block form [Barfoot, "State
    # Estimation for Robotics", eq. 7.86]:
    #   dl_exp(v, w)  = [[Jl3(w), Q(v, w)], [0, Jl3(w)]]
    #   dr_exp(x)     = dl_exp(-x)
    #   dr_expinv(x)  = [[Ji, -Ji Q(-v,-w) Ji], [0, Ji]],  Ji = SO3.dr_expinv(w)
    @staticmethod
    def _Q(rho, phi):
        """Barfoot's Q: the translation-rotation coupling block of dl_exp."""
        th2 = _sq(phi)
        rh = _hat3(rho)
        ph = _hat3(phi)
        pr = _mm(ph, rh)
        rp = _mm(rh, ph)
        prp = _mm(pr, ph)
        pp = _mm(ph, ph)
        m1 = se.sin3c2(th2)  # (t - sin t)/t^3
        m2 = se.cos4c2(th2)  # (1 - t^2/2 - cos t)/t^4  (negative near 0)
        m3 = se.sin5c2(th2)  # (t - sin t - t^3/6)/t^5  (negative near 0)
        return (
            0.5 * rh
            + m1 * (pr + rp + prp)
            - m2 * (_mm(pp, rh) + _mm(rh, pp) - 3.0 * prp)
            - 0.5 * (m2 - 3.0 * m3) * (_mm(prp, ph) + _mm(ph, prp))
        )

    # Second order: _Q is linear in rho, so its rho-derivative is _Q at the
    # basis vectors; the phi-derivative differentiates each hat product with
    # the so(3) generators and each coefficient through the d*-series.
    @staticmethod
    def _dQ_dphi(rho, phi):
        """(3, 3, 3): out[k] = d _Q(rho, phi) / d phi_k."""
        th2 = _sq(phi)
        rh = _hat3(rho)
        ph = _hat3(phi)
        G = _so3_generators(phi.dtype, phi.device)  # G[k] = d hat(phi) / d phi_k
        m1, m2, m3 = se.sin3c2(th2), se.cos4c2(th2), se.sin5c2(th2)
        dm1 = 2.0 * se.dsin3c2(th2) * phi  # (3,)
        dm2 = 2.0 * se.dcos4c2(th2) * phi
        dm3 = 2.0 * se.dsin5c2(th2) * phi

        pr = _mm(ph, rh)
        prp = _mm(pr, ph)
        pp = _mm(ph, ph)
        T1 = pr + _mm(rh, ph) + prp
        T2 = _mm(pp, rh) + _mm(rh, pp) - 3.0 * prp
        T3 = _mm(prp, ph) + _mm(ph, prp)

        dpr = _mm(G, rh)
        dprp = _mm(dpr, ph) + _mm(pr, G)
        dpp = _mm(G, ph) + _mm(ph, G)
        dT1 = dpr + _mm(rh, G) + dprp
        dT2 = _mm(dpp, rh) + _mm(rh, dpp) - 3.0 * dprp
        dT3 = _mm(dprp, ph) + _mm(prp, G) + _mm(G, prp) + _mm(ph, dprp)
        return (
            dm1[:, None, None] * T1[None]
            + m1 * dT1
            - dm2[:, None, None] * T2[None]
            - m2 * dT2
            - 0.5 * (dm2 - 3.0 * dm3)[:, None, None] * T3[None]
            - 0.5 * (m2 - 3.0 * m3) * dT3
        )

    def _dQr_blocks(self, x):
        """(3, 3, 6): the derivative of dr_exp's Q-block ``_Q(-v, -w)`` with
        respect to the whole tangent x = (v, w)."""
        phi = -x[3:]
        eye = torch.eye(3, dtype=x.dtype, device=x.device)
        dQ_v = torch.stack([self._Q(-eye[k], phi) for k in range(3)])
        dQ_w = -self._dQ_dphi(-x[:3], phi)  # the chain through phi = -w
        return torch.movedim(torch.cat([dQ_v, dQ_w]), 0, -1)

    @staticmethod
    def _blocks3(a, b, c):
        """The (6, 6, 6) stack [[a, b], [0, c]] of (3, 3, 6) blocks."""
        z = torch.zeros_like(a)
        return torch.cat([torch.cat([a, b], dim=1), torch.cat([z, c], dim=1)])

    def d2r_exp(self, x):
        # Jr depends on w only
        dJ = F.pad(SO3.d2r_exp(x[3:]), (3, 0))
        return self._blocks3(dJ, self._dQr_blocks(x), dJ)

    def d2r_expinv(self, x):
        Ji = SO3.dr_expinv(x[3:])
        Q = self._Q(-x[:3], -x[3:])
        dJi = F.pad(SO3.d2r_expinv(x[3:]), (3, 0))  # (3, 3, 6)
        # d(-Ji Q Ji) by the product rule, derivative axis first
        dJi_k, dQ_k = torch.movedim(dJi, -1, 0), torch.movedim(self._dQr_blocks(x), -1, 0)
        dB = -(_mm(_mm(dJi_k, Q), Ji) + _mm(_mm(Ji, dQ_k), Ji) + _mm(_mm(Ji, Q), dJi_k))
        return self._blocks3(dJi, torch.movedim(dB, 0, -1), dJi)

    def dr_exp(self, x):
        v, w = -x[:3], -x[3:]
        Jl = SO3.dr_exp(-w)  # = dl_exp of SO(3) at w
        return self._blocks(Jl, self._Q(v, w), Jl)

    def dr_expinv(self, x):
        Ji = SO3.dr_expinv(x[3:])  # = Jl3(w)^{-1} since Jr(w) = Jl(-w)
        Q = self._Q(-x[:3], -x[3:])
        return self._blocks(Ji, -_mm(_mm(Ji, Q), Ji), Ji)

    def normalize(self, g):
        return torch.cat([g[:3], g[3:] / torch.linalg.vector_norm(g[3:])])

    def matrix(self, g):
        top = torch.cat([_quat_rotmat(g[3:]), g[:3, None]], dim=1)
        bot = torch.zeros((1, 4), dtype=g.dtype, device=g.device)
        bot[0, 3] = 1.0
        return torch.cat([top, bot])


class Bundle(LieGroup):
    """Direct product of Lie groups; storage is the concatenated parts (the
    SE(2) x R^3 vehicle state of benchmarks/asif_bench.py, for one)."""

    def __init__(self, *parts: LieGroup):
        self.parts = tuple(parts)
        self.nparams = sum(p.nparams for p in self.parts)
        self.ndof = sum(p.ndof for p in self.parts)
        self._poff = [0]
        self._doff = [0]
        for p in self.parts:
            self._poff.append(self._poff[-1] + p.nparams)
            self._doff.append(self._doff[-1] + p.ndof)

    def _key(self):
        return ("Bundle",) + tuple(p._key() for p in self.parts)

    def __repr__(self):
        return "Bundle(" + ", ".join(repr(p) for p in self.parts) + ")"

    def _psplit(self, g):
        return [g[self._poff[i] : self._poff[i + 1]] for i in range(len(self.parts))]

    def _dsplit(self, v):
        return [v[self._doff[i] : self._doff[i + 1]] for i in range(len(self.parts))]

    def identity(self, dtype=None, device=None):
        return torch.cat([p.identity(dtype=dtype, device=device) for p in self.parts])

    def exp(self, v):
        return torch.cat([p.exp(vi) for p, vi in zip(self.parts, self._dsplit(v))])

    def log(self, g):
        return torch.cat([p.log(gi) for p, gi in zip(self.parts, self._psplit(g))])

    def compose(self, a, b):
        return torch.cat(
            [p.compose(ai, bi) for p, ai, bi in zip(self.parts, self._psplit(a), self._psplit(b))]
        )

    def inverse(self, g):
        return torch.cat([p.inverse(gi) for p, gi in zip(self.parts, self._psplit(g))])

    def _blockdiag(self, blocks):
        """Block-diagonal (ndof, ndof) matrix of the parts' (d, d) blocks,
        assembled with ``cat`` so that it runs under ``vmap`` and ``jacfwd``."""
        rows = []
        for i, blk in enumerate(blocks):
            left = blk.new_zeros((blk.shape[0], self._doff[i]))
            right = blk.new_zeros((blk.shape[0], self.ndof - self._doff[i + 1]))
            rows.append(torch.cat([left, blk, right], dim=1))
        return torch.cat(rows, dim=0)

    def Ad(self, g):
        return self._blockdiag([p.Ad(gi) for p, gi in zip(self.parts, self._psplit(g))])

    def ad(self, v):
        return self._blockdiag([p.ad(vi) for p, vi in zip(self.parts, self._dsplit(v))])

    def dr_exp(self, v):
        return self._blockdiag([p.dr_exp(vi) for p, vi in zip(self.parts, self._dsplit(v))])

    def dr_expinv(self, v):
        return self._blockdiag([p.dr_expinv(vi) for p, vi in zip(self.parts, self._dsplit(v))])

    def _blockdiag3(self, tensors):
        """(ndof, ndof, ndof) block-diagonal assembly of the parts' (d, d, d)
        second-order tensors (cross-part derivatives vanish on a direct
        product), padded rather than written in place, for ``vmap``."""
        out = 0.0
        for i, t in enumerate(tensors):
            lo, hi = self._doff[i], self.ndof - self._doff[i + 1]
            out = out + F.pad(t, (lo, hi) * 3)
        return out

    def d2r_exp(self, v):
        return self._blockdiag3([p.d2r_exp(vi) for p, vi in zip(self.parts, self._dsplit(v))])

    def d2r_expinv(self, v):
        return self._blockdiag3([p.d2r_expinv(vi) for p, vi in zip(self.parts, self._dsplit(v))])

    def normalize(self, g):
        return torch.cat([p.normalize(gi) for p, gi in zip(self.parts, self._psplit(g))])

    def is_commutative(self):
        return all(p.is_commutative() for p in self.parts)


SO2 = _SO2()
SO3 = _SO3()
SE2 = _SE2()
SE3 = _SE3()
