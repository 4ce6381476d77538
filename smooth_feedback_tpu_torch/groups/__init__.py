"""Lie group core (PyTorch port)."""

from .base import LieGroup, ad_generators, jacobian_wrt_group
from .groups import SE2, SE3, SO2, SO3, Bundle, Rn

__all__ = ["LieGroup", "Rn", "SO2", "SO3", "SE2", "SE3", "Bundle", "ad_generators",
           "jacobian_wrt_group"]
