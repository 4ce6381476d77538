"""Controllers (PyTorch port): the MPC step, its fleets on one clock and on
per-member clocks."""

from .mpc import MPCParams, MPCStepResult, MPCWeights, make_mpc_step

__all__ = ["MPCParams", "MPCStepResult", "MPCWeights", "make_mpc_step"]
