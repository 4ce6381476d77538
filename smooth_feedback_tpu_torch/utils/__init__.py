"""Utilities (PyTorch port): bounds sets, compensated accumulation, the
batch-trailing stack algebra and Lie-group splines."""

from .bounds import ManifoldBounds, box_bounds, empty_bounds
from .linalg import chol_lane, chol_solve_lane, mm_lane, mv_lane, qr_lower_lane, sym_lane
from .spline import LieSpline, fit_spline, spline_eval, spline_pos

__all__ = [
    "ManifoldBounds",
    "box_bounds",
    "empty_bounds",
    "LieSpline",
    "fit_spline",
    "spline_eval",
    "spline_pos",
    "chol_lane",
    "chol_solve_lane",
    "mm_lane",
    "mv_lane",
    "qr_lower_lane",
    "sym_lane",
]
