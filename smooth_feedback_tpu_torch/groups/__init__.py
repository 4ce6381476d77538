"""Lie group core (PyTorch port)."""

from .base import LieGroup
from .groups import Rn

__all__ = ["LieGroup", "Rn"]
