"""Full-precision float32 matmuls for the port's numeric entry points.

The counterpart of the JAX package's ``jax.default_matmul_precision("highest")``
scopes: TF32 keeps about three decimal digits, which stalls ADMM above its
stopping tolerances, so it is off inside every solve and transcription.
"""

import contextlib

import torch


@contextlib.contextmanager
def ieee_f32_matmul():
    """Disable TF32 for CUDA matmuls and cuDNN inside the block; restore after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
