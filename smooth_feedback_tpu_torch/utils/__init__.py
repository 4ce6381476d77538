"""Utilities (PyTorch port): bounds sets, compensated accumulation and the
batch-trailing product the ASIF fleet uses."""

from .bounds import ManifoldBounds, box_bounds, empty_bounds
from .linalg import mm_lane

__all__ = ["ManifoldBounds", "box_bounds", "empty_bounds", "mm_lane"]
