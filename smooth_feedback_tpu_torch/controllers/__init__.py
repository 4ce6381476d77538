"""Controllers (PyTorch port): the condensed MPC fleet step."""

from .mpc import MPCParams, MPCStepResult, MPCWeights, make_mpc_step

__all__ = ["MPCParams", "MPCStepResult", "MPCWeights", "make_mpc_step"]
