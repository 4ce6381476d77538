"""Concrete Lie groups (PyTorch port): ``Rn`` so far.

SO2, SE2, SO3, SE3 and Bundle of ``smooth_feedback_tpu/groups/groups.py``
follow in later slices of the port.
"""

from __future__ import annotations

import torch

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
