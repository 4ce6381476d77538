"""smooth_feedback_tpu_torch: the PyTorch / CUDA port of smooth_feedback_tpu.

Same public names and layout as the JAX package, one module per counterpart.
This slice holds the QP types and solver core, the shared-matrix ADMM kernel
(hand-written CUDA for Hopper, ``csrc/admm_shared.cu``), ``Rn``, the
collocation mesh, the QP transcription and the condensed MPC fleet step.
Importing the package builds nothing; the kernel is compiled at first use.
"""

from . import groups

__version__ = "0.1.0"

__all__ = ["groups", "__version__"]
