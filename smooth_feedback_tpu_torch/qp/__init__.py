"""Batched dense QP solving (PyTorch port)."""

from .cuda_kernel import (
    LaneSolution,
    admm_iterate_cuda,
    admm_iterate_cuda_shared,
    admm_iterate_reference,
    admm_solve_cuda_lane,
    admm_solve_lane_reference,
)
from .solver import (
    QPFactors,
    lane_kernel_args,
    per_problem_kernel_args,
    qp_factorize,
    qp_phase_timings,
    shared_kernel_args,
    solve_qp,
    solve_qp_batch,
    solve_qp_timed,
)
from .types import (
    QPSolution,
    QPSolutionStatus,
    QPSolverParams,
    QuadraticProgram,
    random_qp,
    warmstart_like,
)

__all__ = [
    "QuadraticProgram",
    "QPSolution",
    "QPSolutionStatus",
    "QPSolverParams",
    "QPFactors",
    "qp_factorize",
    "solve_qp",
    "solve_qp_batch",
    "solve_qp_timed",
    "qp_phase_timings",
    "shared_kernel_args",
    "per_problem_kernel_args",
    "lane_kernel_args",
    "random_qp",
    "warmstart_like",
    "admm_iterate_cuda",
    "admm_iterate_cuda_shared",
    "admm_iterate_reference",
    "admm_solve_cuda_lane",
    "admm_solve_lane_reference",
    "LaneSolution",
]
