"""NLP solvers (PyTorch port): the line-search SQP, single and batched."""

from .sqp import SQPParams, rescue_nonoptimal, solve_nlp_sqp, solve_nlp_sqp_batch

__all__ = ["SQPParams", "solve_nlp_sqp", "solve_nlp_sqp_batch", "rescue_nonoptimal"]
