"""Utilities (PyTorch port): bounds sets, compensated accumulation, the
batch-trailing stack algebra, the Hessian-of-composition rule, FLOP counts
and Lie-group splines."""

from .bounds import ManifoldBounds, box_bounds, empty_bounds
from .flops import (
    admm_check_flops,
    admm_factor_flops,
    admm_iter_flops,
    condensed_mpc_transcribe_flops,
    device_peak_flops,
    mfu_pct,
    qp_solve_flops,
)
from .linalg import (
    chol_lane, chol_solve_lane, d2r_fog, mm_lane, mv_lane, qr_lower_lane, sym_lane,
)
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
    "d2r_fog",
    "admm_iter_flops",
    "admm_factor_flops",
    "admm_check_flops",
    "qp_solve_flops",
    "condensed_mpc_transcribe_flops",
    "device_peak_flops",
    "mfu_pct",
]
