"""Lie group abstraction (PyTorch port of ``smooth_feedback_tpu/groups/base.py``).

A group element is a plain tensor of shape ``(nparams,)`` and a tangent
vector a tensor of shape ``(ndof,)``; batches are leading axes handled with
``torch.func.vmap``.  A :class:`LieGroup` instance is a stateless, hashable
description of the group.  Concrete groups must implement
exp/log/compose/inverse; the right Jacobians and adjoints fall back to
``torch.func.jacfwd`` of those, through the identities

    dr_exp(v)    = d/dw log( exp(v)^{-1} o exp(v + w) ) |_{w=0}
    dr_expinv(v) = d/dw log( exp(v) o exp(w) )          |_{w=0}
    Ad(g)        = d/dw log( g o exp(w) o g^{-1} )      |_{w=0}
    ad(v)        = d/ds Ad( exp(s v) )                  |_{s=0}

The second-order derivatives ``d2r_exp``/``d2r_expinv`` fall back to one
more ``jacfwd`` sweep of ``dr_exp``/``dr_expinv``.

Conventions (right-trivialized): ``rplus(x, v) = x o exp(v)``,
``rminus(a, b) = log(b^{-1} o a)``.
"""

from __future__ import annotations

import torch

from .._func import jacfwd


class LieGroup:
    """Stateless description of a Lie group; elements are flat tensors."""

    nparams: int
    ndof: int

    # ------------------------------------------------------------------ core
    def identity(self, dtype=None, device=None) -> torch.Tensor:
        raise NotImplementedError

    def exp(self, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def log(self, g: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def compose(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def inverse(self, g: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # ------------------------------------------------------------ derived ops
    def rplus(self, g, v):
        """Right-plus: ``g (+) v = g o exp(v)``."""
        return self.compose(g, self.exp(v))

    def rminus(self, a, b):
        """Right-minus: ``a (-) b = log(b^{-1} o a)`` (tangent at ``b``)."""
        return self.log(self.compose(self.inverse(b), a))

    def lplus(self, g, v):
        """Left-plus: ``v (+) g = exp(v) o g``."""
        return self.compose(self.exp(v), g)

    def lminus(self, a, b):
        """Left-minus: ``log(a o b^{-1})``."""
        return self.log(self.compose(a, self.inverse(b)))

    # ------------------------------------------------- adjoints and Jacobians
    def Ad(self, g):
        """Adjoint matrix of a group element, shape ``(ndof, ndof)``."""
        z = torch.zeros((self.ndof,), dtype=g.dtype, device=g.device)
        return jacfwd(
            lambda w: self.log(self.compose(self.compose(g, self.exp(w)), self.inverse(g)))
        )(z)

    def ad(self, v):
        """Adjoint matrix of a tangent element (Lie bracket ``ad_v w = [v, w]``)."""
        s = torch.zeros((), dtype=v.dtype, device=v.device)
        return jacfwd(lambda t: self.Ad(self.exp(t * v)))(s)

    def dr_exp(self, v):
        """Right Jacobian of ``exp`` at ``v``, shape ``(ndof, ndof)``."""
        z = torch.zeros_like(v)
        return jacfwd(
            lambda w: self.log(self.compose(self.inverse(self.exp(v)), self.exp(v + w)))
        )(z)

    def dr_expinv(self, v):
        """Inverse of the right Jacobian of ``exp`` at ``v``."""
        z = torch.zeros_like(v)
        return jacfwd(lambda w: self.log(self.compose(self.exp(v), self.exp(w))))(z)

    def dl_exp(self, v):
        """Left Jacobian: ``dl_exp(v) = Ad(exp(v)) dr_exp(v)``."""
        return self.Ad(self.exp(v)) @ self.dr_exp(v)

    def dl_expinv(self, v):
        """Inverse left Jacobian."""
        return self.dr_expinv(v) @ self.Ad(self.inverse(self.exp(v)))

    # second-order derivatives: one more forward-mode sweep; the layout is
    # out[i, j, k] = d dr_exp(v)[i, j] / d v_k
    def d2r_exp(self, v):
        """``d/dv dr_exp(v)`` with shape ``(ndof, ndof, ndof)``."""
        return jacfwd(self.dr_exp)(v)

    def d2r_expinv(self, v):
        """``d/dv dr_expinv(v)`` with shape ``(ndof, ndof, ndof)``."""
        return jacfwd(self.dr_expinv)(v)

    # ---------------------------------------------------------------- helpers
    def random(self, generator: torch.Generator, scale: float = 1.0, dtype=None):
        """Random element ``exp(scale * n)``, ``n ~ N(0, I)`` drawn from
        ``generator``, on the generator's device."""
        n = torch.randn((self.ndof,), generator=generator, dtype=dtype, device=generator.device)
        return self.exp(scale * n)

    def normalize(self, g):
        """Project parameters back onto the group manifold (e.g. unit norm)."""
        return g

    def is_commutative(self) -> bool:
        return False

    # hashability: compared by type and the fields subclasses declare
    def _key(self):
        return (type(self).__name__,)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, LieGroup) and self._key() == other._key()

    def __repr__(self):
        return type(self).__name__


def jacobian_wrt_group(group: LieGroup, f, g, *args, **kwargs):
    """Right (body-frame) derivative of ``f`` at the group element ``g``:
    ``d/dw f(g o exp(w), *args)`` at ``w = 0``.  Returns ``(f(g), J)``."""
    z = torch.zeros((group.ndof,), dtype=g.dtype, device=g.device)
    fn = lambda w: f(group.rplus(g, w), *args, **kwargs)
    return f(g, *args, **kwargs), jacfwd(fn)(z)


def ad_generators(G: LieGroup, dtype=None, device=None) -> torch.Tensor:
    """(ndof, ndof, ndof) stack ``adgen[k] = ad(e_k)``.

    ``ad`` is linear in its tangent argument, so ``ad(v) =
    einsum('kij,k->ij', adgen, v)``, and for a batch-trailing (ndof, B)
    velocity stack ``einsum('kij,kb->ijb', adgen, v)`` assembles every
    member's ``ad`` at once."""
    eye = torch.eye(G.ndof, dtype=dtype, device=device)
    return torch.stack([G.ad(eye[:, k]) for k in range(G.ndof)])
