"""Manifold bounds set (PyTorch port of ``smooth_feedback_tpu/utils/bounds.py``):

    { m : l <= A (m (-) c) <= u }

described by a matrix A, a center group element c, and bounds l/u.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..groups.base import LieGroup


class ManifoldBounds(NamedTuple):
    A: torch.Tensor  # (nb, ndof)
    c: torch.Tensor  # (nparams,) group element
    l: torch.Tensor  # (nb,)
    u: torch.Tensor  # (nb,)


def empty_bounds(G: LieGroup, dtype=None, device="cuda") -> ManifoldBounds:
    """No bounds (nb = 0) on ``G``."""
    kw = dict(dtype=dtype, device=device)
    return ManifoldBounds(
        A=torch.zeros((0, G.ndof), **kw),
        c=G.identity(**kw),
        l=torch.zeros((0,), **kw),
        u=torch.zeros((0,), **kw),
    )


def box_bounds(G: LieGroup, lo, hi, dtype=None, device="cuda") -> ManifoldBounds:
    """Axis-aligned bounds around the identity."""
    kw = dict(dtype=dtype, device=device)
    return ManifoldBounds(
        A=torch.eye(G.ndof, **kw),
        c=G.identity(**kw),
        l=torch.as_tensor(lo, **kw),
        u=torch.as_tensor(hi, **kw),
    )
