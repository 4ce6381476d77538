"""Batched dense QP solving (PyTorch port)."""

from .cuda_kernel import admm_iterate_cuda_shared, admm_iterate_shared_reference
from .solver import QPFactors, qp_factorize, shared_kernel_args, solve_qp, solve_qp_batch
from .types import (
    QPSolution,
    QPSolutionStatus,
    QPSolverParams,
    QuadraticProgram,
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
    "shared_kernel_args",
    "warmstart_like",
    "admm_iterate_cuda_shared",
    "admm_iterate_shared_reference",
]
