"""Lie group core (PyTorch port)."""

from .base import LieGroup
from .groups import SE2, SO2, Rn

__all__ = ["LieGroup", "Rn", "SO2", "SE2"]
