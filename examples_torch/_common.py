"""Set-up shared by the port's examples."""

from __future__ import annotations

import torch

# Where a JAX example's tolerance is a float64 one, a float32 run takes
# these instead (float32 ADMM and SQP stall above the float64 values): the
# SQP's KKT tolerance, the refinement's dynamics-error target and a QP's
# eps, each printed beside the example's own value.
F32_SQP_TOL = 1e-4
F32_TARGET_ERR = 1e-4
F32_QP_EPS = 1e-3


def device_kw(device, dtype) -> dict:
    """``dict(dtype=, device=)``; a CUDA device without a card raises (the
    examples run nowhere else unless asked for the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the examples run on a GPU; pass device='cpu' "
                           "to run one on the CPU")
    return dict(dtype=dtype, device=dev)


def is_f32(dtype) -> bool:
    return torch.finfo(dtype).bits <= 32


def f32_cut(name, value, f32_value, dtype):
    """``value``, or ``f32_value`` where it is looser and ``dtype`` is
    float32 (printed beside the example's own)."""
    if is_f32(dtype) and f32_value > value:
        print(f"[float32] {name} {f32_value:g} (the example's {value:g} is a float64 tolerance)")
        return f32_value
    return value


def sync(kw):
    if kw["device"].type == "cuda":
        torch.cuda.synchronize()


def card_qp_params(backend):
    """The SQP subproblems' settings on the kernel route, those of the SE(2)
    OCP fleet on the card (``chip_smoke.ocp_sweep_params``; the kernel has
    no adaptive rho): eps 1e-6, 1200 iterations, one KKT refinement sweep,
    polish, compensated checks, on ``backend``."""
    from smooth_feedback_tpu_torch.qp import QPSolverParams

    return QPSolverParams(eps_abs=1e-6, eps_rel=1e-6, max_iter=1200, polish=True,
                          kkt_refine_iters=1, compensated_check=True, backend=backend)


def sqp_params(max_iter, tol, dtype, backend, **extra):
    """The SQP of the JAX examples (``max_iter``, KKT ``tol``; in float32
    F32_SQP_TOL with compensated KKT sums) with its subproblems on
    ``backend``: on ``"torch"`` and ``"lane"`` the JAX package's defaults
    (eps 1e-9, adaptive rho), on ``"cuda"`` :func:`card_qp_params`."""
    import dataclasses

    from smooth_feedback_tpu_torch.solvers import SQPParams

    qp = (card_qp_params(backend) if backend == "cuda"
          else dataclasses.replace(SQPParams().qp, backend=backend))
    return SQPParams(max_iter=max_iter, tol=f32_cut("SQP tol", tol, F32_SQP_TOL, dtype),
                     compensated_kkt=is_f32(dtype), qp=qp, **extra)
