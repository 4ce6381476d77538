"""smooth_feedback_tpu_torch: the PyTorch / CUDA port of smooth_feedback_tpu.

Same public names and layout as the JAX package, one module per counterpart.
It holds the QP types and solver core with two ADMM kernels hand-written in
CUDA for Hopper (``csrc/admm_shared.cu`` for batches sharing their factors,
``csrc/admm_problem.cu`` for per-problem factors), ``Rn``, ``SO2``, ``SE2``,
the collocation mesh, the QP transcription, and the condensed and sparse
MPC fleet steps.  Importing the package builds nothing; the kernels are
compiled at first use.
"""

from . import groups

__version__ = "0.1.0"

__all__ = ["groups", "__version__"]
