"""Controllers (PyTorch port): the MPC step, its fleets on one clock and on
per-member clocks, the MPC class, and the ASIF safety filter."""

from .asif import (
    ASIFilter,
    ASIFilterParams,
    ASIFStepResult,
    ASIFtoQPParams,
    asif_to_qp,
    asif_to_qp_fleet,
    make_asif_step,
)
from .mpc import MPC, MPCParams, MPCStepResult, MPCWeights, default_weights, make_mpc_step

__all__ = [
    "ASIFilter",
    "ASIFilterParams",
    "ASIFStepResult",
    "ASIFtoQPParams",
    "asif_to_qp",
    "asif_to_qp_fleet",
    "make_asif_step",
    "MPC",
    "MPCParams",
    "MPCStepResult",
    "MPCWeights",
    "default_weights",
    "make_mpc_step",
]
