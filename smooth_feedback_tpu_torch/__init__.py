"""smooth_feedback_tpu_torch: the PyTorch / CUDA port of smooth_feedback_tpu.

Same public names and layout as the JAX package, one module per counterpart.
It holds the QP types and solver (polish, compensated checks, adaptive rho)
with three ADMM kernels hand-written in CUDA for Hopper
(``csrc/admm_shared.cu`` for batches sharing their factors,
``csrc/admm_problem.cu`` for per-problem factors, ``csrc/admm_lane.cu`` for
the lane backend's fleets of tiny QPs), ``Rn``, ``SO2``, ``SO3``, ``SE2``, ``SE3`` and ``Bundle``, the
collocation mesh, the QP transcription, the MPC (condensed and sparse fleet
steps, the ``MPC`` class), the ASIF safety filter, the PID, Lie-group
splines, the EKF (plain, iterated, square-root and fleet forms), the
collocation NLP path with its SQP and mesh refinement, the second-order
group derivatives, the FLOP counters, the solver bridges (``compat``) and
data parallelism over the devices of one host (``parallel``: a fleet's
batch split over a mesh, each shard on its own device and stream).
Importing the package builds nothing; the kernels are compiled at first
use.
"""

from . import groups, parallel

__version__ = "0.1.0"

__all__ = ["groups", "parallel", "__version__"]
