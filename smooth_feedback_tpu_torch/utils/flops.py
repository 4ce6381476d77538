"""Closed-form FLOP counts of the solver's hot paths (PyTorch port of
``smooth_feedback_tpu/utils/flops.py``; the counts are that module's
arithmetic, unchanged).

They count the NOMINAL algorithm FLOPs, the useful work, not what a kernel
executes on padding or idle lanes, so waste shows as low utilization.

Conventions:

* a fused multiply-add counts as 2 FLOPs;
* matvec (m, n) @ (n,) = 2mn; GEMM (a, b) @ (b, c) = 2abc;
* Cholesky of n x n = n^3/3; a triangular solve against an n-vector = 2n^2
  FLOPs (n^3 against an n x n identity block);
* the O(n + m) elementwise work of an ADMM iteration is counted with a
  small constant.

Peak: one NVIDIA H100 SXM (data sheet, 700 W), float32 outside the tensor
cores, 67 TFLOP/s.  The port's ADMM kernels run IEEE float32 FMAs on the
CUDA cores and its dense algebra keeps TF32 off, so this is their ceiling,
not the 495 TFLOP/s TF32 tensor-core rate.  A card set below 700 W runs
slower than this peak.
"""

from __future__ import annotations

# NVIDIA H100 SXM, float32 FLOP/s outside the tensor cores
H100_PEAK_F32 = 67e12

_PEAKS = {"gpu": H100_PEAK_F32}


def admm_iter_flops(n: int, m: int, refine_iters: int = 0) -> float:
    """Nominal FLOPs of ONE ADMM iteration of the reduced-KKT solver: A^T
    matvec + A matvec (2 x 2mn), the cached-inverse KKT solve (2n^2),
    ``refine_iters`` rounds of iterative refinement (4n^2 each), and the
    relaxed update/clip/dual elementwise tail (~12(n + m))."""
    return 4.0 * m * n + 2.0 * n * n * (1 + 2 * refine_iters) + 12.0 * (n + m)


def admm_factor_flops(n: int, m: int) -> float:
    """Nominal FLOPs of one reduced-KKT factorization: the A^T rho A Gram
    product (2mn^2), Cholesky (n^3/3), and the explicit SPD inverse via two
    triangular solves against I (2n^3)."""
    return 2.0 * m * n * n + n**3 / 3.0 + 2.0 * n**3


def admm_check_flops(n: int, m: int) -> float:
    """Nominal FLOPs of one unscaled-residual stopping check: Ax, Px, A^T y
    and the infeasibility certificates' A^T dy, P dx, A dx (six matvecs)."""
    return 6.0 * 2.0 * m * n


def qp_solve_flops(
    n: int,
    m: int,
    iters: float,
    *,
    checks: float = 0.0,
    factorizations: float = 1.0,
    refine_iters: int = 0,
) -> float:
    """Total nominal FLOPs of one QP solve: ``iters`` ADMM iterations,
    ``checks`` stopping checks, ``factorizations`` reduced-KKT factor+invert
    passes (0 with ``reuse_factors``; 1 + refactor count with adaptive
    rho)."""
    return (
        iters * admm_iter_flops(n, m, refine_iters)
        + checks * admm_check_flops(n, m)
        + factorizations * admm_factor_flops(n, m)
    )


def condensed_mpc_transcribe_flops(n: int, m: int, xL: int, nx: int) -> float:
    """Nominal per-member FLOPs of the condensed MPC vectors-only
    transcription + state recovery (controllers/mpc.py): wx = b0 @ C0b^T
    (2 nx xL), q_c = wx @ M1^T (2 xL n), the constraint-bound shift (2 xL m),
    the objective offset quadratic (2 xL^2 + 2 xL), and the x-trajectory
    recovery Wx @ primal (2 xL n)."""
    return (
        2.0 * nx * xL + 2.0 * xL * n + 2.0 * xL * m + 2.0 * xL * xL + 4.0 * xL * n
    )


def device_peak_flops(platform: str = "gpu") -> float | None:
    """Peak FLOP/s of ``platform`` ("gpu": one H100 in float32 outside the
    tensor cores), None where none is known (a CPU)."""
    return _PEAKS.get(platform)


def mfu_pct(total_flops: float, seconds: float, platform: str = "gpu"):
    """Model-FLOP utilization in percent: nominal FLOPs / (peak x time).
    None when the platform has no known peak (e.g. CPU runs)."""
    peak = device_peak_flops(platform)
    if peak is None or seconds <= 0:
        return None
    return 100.0 * total_flops / (peak * seconds)
