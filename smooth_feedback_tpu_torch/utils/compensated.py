"""Compensated (two-float) accumulation (PyTorch port of
``smooth_feedback_tpu/utils/compensated.py``).

Residuals that must certify below the float32 accumulation floor are
computed with error-free transforms: every add and multiply also yields its
exact rounding error (Knuth two-sum, Dekker two-product), and the errors ride
along as a correction term.  ``hi + lo`` then carries ~eps^2 accumulation
error from float32 operations alone.  The QP solver's polish refinement,
``_certify_point`` and the ``compensated_check`` stopping test use them.

The transforms rely on IEEE round-to-nearest of each single operation.
Eager PyTorch runs every operation as its own kernel, so nothing contracts
``a * b + c`` into a fused multiply-add here; ``torch.compile`` (or any
fusing compiler) may do so and break them.  Do not compile these functions.
"""

from __future__ import annotations

import math

import torch


def two_sum(a, b):
    """Knuth's branch-free error-free addition: a + b = s + e exactly."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _split(a):
    """Veltkamp split of ``a`` into hi + lo with non-overlapping halves; the
    constant is 2**ceil(p/2) + 1 for the dtype's p-bit mantissa."""
    p = 1 - int(math.log2(torch.finfo(a.dtype).eps))  # 24 for float32, 53 for float64
    c = (2.0 ** ((p + 1) // 2) + 1.0) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker's error-free product: a * b = p + e exactly (no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def csum(x, dim=0):
    """Compensated sum along ``dim``: ``(hi, lo)`` with hi + lo = sum(x) to
    ~eps^2 relative accumulation error (a pairwise tree of two_sum steps;
    the per-level rounding errors are O(eps) of their operands and add up
    plainly)."""
    x = torch.movedim(x, dim, 0)
    lo = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        s, e = two_sum(x[0::2], x[1::2])
        lo = lo + e.sum(dim=0)
        x = s
    return x[0], lo


def cdot(a, b, dim=0):
    """Compensated dot product along ``dim`` (Ogita-Rump-Oishi dot2):
    ``(hi, lo)`` with hi + lo = sum(a * b) to ~eps^2 accuracy."""
    p, e = two_prod(a, b)
    s, c = csum(p, dim=dim)
    return s, c + e.sum(dim=dim)


def cadd(hi1, lo1, hi2, lo2):
    """Add two (hi, lo) pairs, renormalized."""
    s, e = two_sum(hi1, hi2)
    lo = e + lo1 + lo2
    return two_sum(s, lo)


def cmatvec(M, v):
    """Compensated matvec ``M @ v``: M (..., r, k), v (..., k) -> (hi, lo)
    of shape (..., r); a 2-D M is shared by a batch of v."""
    return cdot(M, v[..., None, :], dim=-1)


def cmatvec_t(J, lam):
    """Compensated ``J' lam``: J (m, n) or (B, m, n), lam (m,) or (B, m) ->
    (hi, lo) of shape (n,) / (B, n)."""
    if J.dim() == 2:
        return cdot(J, lam[:, None], dim=0)
    return cdot(J, lam[:, :, None], dim=1)


def stationarity_compensated(grad, J, lam, z):
    """inf-norm of ``grad + J' lam + z`` with compensated accumulation.

    grad/z: (n,) or (B, n); J: (m, n) or (B, m, n); lam: (m,) or (B, m)."""
    hi, lo = cmatvec_t(J, lam)
    hi, lo = cadd(hi, lo, grad, torch.zeros_like(grad))
    hi, lo = cadd(hi, lo, z, torch.zeros_like(z))
    return (hi + lo).abs().amax(dim=-1)
