"""Lie group core (PyTorch port)."""

from .base import LieGroup, ad_generators, jacobian_wrt_group
from .groups import SE2, SO2, Bundle, Rn

__all__ = ["LieGroup", "Rn", "SO2", "SE2", "Bundle", "ad_generators", "jacobian_wrt_group"]
