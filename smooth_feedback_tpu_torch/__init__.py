"""smooth_feedback_tpu_torch: the PyTorch / CUDA port of smooth_feedback_tpu.

Same public names and layout as the JAX package, one module per counterpart.
It holds the QP types and solver (polish, compensated checks, adaptive rho)
with two ADMM kernels hand-written in CUDA for Hopper (``csrc/admm_shared.cu``
for batches sharing their factors, ``csrc/admm_problem.cu`` for per-problem
factors), ``Rn``, ``SO2``, ``SO3``, ``SE2``, ``SE3`` and ``Bundle``, the
collocation mesh, the QP transcription, the MPC (condensed and sparse fleet
steps, the ``MPC`` class), the ASIF safety filter, the PID, Lie-group
splines and the EKF (plain, iterated, square-root and fleet forms).
Importing the package builds nothing; the kernels are compiled at first
use.
"""

from . import groups

__version__ = "0.1.0"

__all__ = ["groups", "__version__"]
