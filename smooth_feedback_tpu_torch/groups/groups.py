"""Concrete Lie groups (PyTorch port): ``Rn``, ``SO2`` and ``SE2``.

Storage and tangent layouts follow ``smooth_feedback_tpu/groups/groups.py``:

=======  ==========  ====  =====================================
Group    nparams     ndof  storage
=======  ==========  ====  =====================================
Rn(n)    n           n     the vector itself
SO2      2           1     unit complex ``[re, im]``
SE2      4           3     ``[tx, ty, re, im]``; tangent ``[vx, vy, w]``
Bundle   sum         sum   the parts' storages concatenated
=======  ==========  ====  =====================================

Closed forms are given for the hot operations; the rest inherits the
``torch.func.jacfwd`` fallbacks of :class:`~.base.LieGroup`.  Every operation
is written with ``torch.stack``/``torch.cat`` on the element's entries and no
Python branch on values, so it runs under ``torch.func.vmap``.  SO3, SE3
and the second-order forms (``d2r_exp``/``d2r_expinv``) follow in later
slices of the port.
"""

from __future__ import annotations

import torch

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

    def is_commutative(self):
        return True


def _mat(rows):
    """A matrix from rows of 0-d tensors."""
    return torch.stack([torch.stack(r) for r in rows])


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

    def normalize(self, g):
        return g / torch.linalg.vector_norm(g)

    def matrix(self, g):
        return _mat([[g[0], -g[1]], [g[1], g[0]]])

    def is_commutative(self):
        return True


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

    def normalize(self, g):
        return torch.cat([g[:2], g[2:] / torch.linalg.vector_norm(g[2:])])

    def matrix(self, g):
        z, o = torch.zeros_like(g[0]), torch.ones_like(g[0])
        return _mat([[g[2], -g[3], g[0]], [g[3], g[2], g[1]], [z, z, o]])


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

    def normalize(self, g):
        return torch.cat([p.normalize(gi) for p, gi in zip(self.parts, self._psplit(g))])

    def is_commutative(self):
        return all(p.is_commutative() for p in self.parts)


SO2 = _SO2()
SE2 = _SE2()
