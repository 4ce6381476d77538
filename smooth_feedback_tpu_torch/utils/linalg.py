"""Dense linear-algebra helpers (PyTorch port of part of
``smooth_feedback_tpu/utils/linalg.py``).

Only :func:`mm_lane` is ported so far: the ASIF fleet transcription carries
its sensitivity stack batch-trailing, as ``(nx, nx, B)``, and multiplies it
with this.
"""

from __future__ import annotations


def mm_lane(A, B):
    """(i, j, b), (j, k, b) -> (i, k, b) matrix-stack product, batch trailing."""
    return (A[:, :, None, :] * B[None, :, :, :]).sum(dim=1)
