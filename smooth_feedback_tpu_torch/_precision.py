"""Full-precision float32 matmuls for the port's numeric entry points.

The counterpart of the JAX package's ``jax.default_matmul_precision("highest")``
scopes: TF32 keeps about three decimal digits, which stalls ADMM above its
stopping tolerances, so it is off inside every solve and transcription.

The TF32 flags are process-wide while the shards of a sharded call
(``parallel``) run in threads of their own, so the scope is counted: the
first thread to enter turns TF32 off, and the flags are restored only when
the last thread inside leaves.
"""

import contextlib
import threading

import torch

_lock = threading.Lock()
_depth = 0  # threads (and nested scopes) inside ieee_f32_matmul
_saved = None  # the flags the first entry found


@contextlib.contextmanager
def ieee_f32_matmul():
    """Disable TF32 for CUDA matmuls and cuDNN inside the block; restore the
    flags when the last block open in any thread closes."""
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = _saved
