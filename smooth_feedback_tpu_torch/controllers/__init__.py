"""Controllers (PyTorch port): the MPC step, its fleets on one clock and on
per-member clocks, the MPC class, the ASIF safety filter and the PID."""

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
from .pid import PID, PIDGains, PIDParams, PIDState, pid_gains, pid_init, pid_step

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
    "PID",
    "PIDGains",
    "PIDParams",
    "PIDState",
    "pid_gains",
    "pid_init",
    "pid_step",
]
