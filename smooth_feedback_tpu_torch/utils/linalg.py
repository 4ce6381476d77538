"""Dense linear-algebra helpers (PyTorch port of part of
``smooth_feedback_tpu/utils/linalg.py``): the batch-trailing ("lane") stack
algebra on ``(n, n, B)``-shaped stacks.

The JAX package keeps the batch on the TPU's 128 lanes with these; the ASIF
fleet transcription carries its sensitivity stack this way, and the EKF fleet
states keep their covariance stacks in this layout at the public boundary.
Each helper is broadcast-multiply-sum over the trailing batch axis, Python-
unrolled over the small static matrix indices.  Also the Hessian-of-
composition rule ``d2r_fog``.
"""

from __future__ import annotations

import torch


def d2r_fog(Jf, Hf, Jg, Hg):
    """Hessian of the composition ``f o g`` from the parts.

    Args (dense layouts):
      Jf: (No, Ny)       Jacobian of f at g(x)
      Hf: (No, Ny, Ny)   Hessians of each output of f
      Jg: (Ny, Nx)       Jacobian of g at x
      Hg: (Ny, Nx, Nx)   Hessians of each output of g

    Returns (No, Nx, Nx):  H_k = Jg' Hf_k Jg + sum_j Jf[k, j] Hg_j.
    """
    first = torch.einsum("yx,kyz,zw->kxw", Jg, Hf, Jg)
    second = torch.einsum("ky,yxw->kxw", Jf, Hg)
    return first + second


def mm_lane(A, B):
    """(i, j, b), (j, k, b) -> (i, k, b) matrix-stack product, batch trailing."""
    return (A[:, :, None, :] * B[None, :, :, :]).sum(dim=1)


def mv_lane(A, x):
    """(i, j, b), (j, b) -> (i, b) matvec stack, batch trailing."""
    return (A * x[None, :, :]).sum(dim=1)


def sym_lane(P):
    """Symmetric part of an (n, n, B) stack."""
    return 0.5 * (P + P.transpose(0, 1))


def chol_lane(S):
    """Unrolled lower Cholesky of an SPD (m, m, B) stack (m static, small):
    O(m^3) (B,)-vector operations, meant for m up to ~16."""
    m = S.shape[0]
    L = [[None] * m for _ in range(m)]
    for j in range(m):
        acc = S[j, j]
        for k in range(j):
            acc = acc - L[j][k] * L[j][k]
        d = torch.sqrt(acc)
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, m):
            acc = S[i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = acc * inv_d
    z = torch.zeros_like(S[0, 0])
    return torch.stack(
        [torch.stack([L[i][j] if j <= i else z for j in range(m)]) for i in range(m)]
    )


def chol_solve_lane(L, B):
    """Solve (L L') X = B with an (m, m, B)-stack lower-triangular L and an
    (m, k, B) right-hand side."""
    m = B.shape[0]
    Y = [None] * m
    for i in range(m):
        acc = B[i]
        for j in range(i):
            acc = acc - L[i, j][None, :] * Y[j]
        Y[i] = acc / L[i, i][None, :]
    X = [None] * m
    for i in reversed(range(m)):
        acc = Y[i]
        for j in range(i + 1, m):
            acc = acc - L[j, i][None, :] * X[j]
        X[i] = acc / L[i, i][None, :]
    return torch.stack(X)


def qr_lower_lane(M):
    """Lower-triangular stack T with ``T T' = M M'`` for (r, c, B) stacks:
    an unrolled Householder QR of ``M'`` over the static (r, c) indices, all
    arithmetic on (B,)-vectors, so no Gram matrix is formed.  Sign-normalized
    to a non-negative diagonal."""
    r, c, B = M.shape
    A = M.transpose(0, 1).clone()  # (c, r, B): QR of M'
    tiny = torch.finfo(A.dtype).tiny
    for k in range(r):
        x = A[k:, k]  # (c-k, B)
        normx = torch.sqrt((x * x).sum(dim=0))
        alpha = -torch.where(A[k, k] >= 0, normx, -normx)
        v = x.clone()
        v[0] = v[0] - alpha  # x - alpha e1
        vnorm2 = (v * v).sum(dim=0)
        degenerate = vnorm2 <= tiny
        beta = torch.where(degenerate, 0.0, 2.0 / torch.where(degenerate, 1.0, vnorm2))
        for j in range(k, r):
            w = (v * A[k:, j]).sum(dim=0)  # (B,)
            A[k:, j] = A[k:, j] - beta[None, :] * w[None, :] * v
    R = A[:r]  # (r, r, B), upper triangular up to rounding
    d = torch.stack([R[i, i] for i in range(r)])  # (r, B)
    s = torch.sign(torch.where(d == 0, torch.ones_like(d), d))
    T = (R * s[:, None, :]).transpose(0, 1)
    # zero the strict upper part (rounding dust above the diagonal)
    return T * torch.tril(torch.ones((r, r), dtype=M.dtype, device=M.device))[:, :, None]
