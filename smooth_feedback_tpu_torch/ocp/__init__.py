"""Optimal control (PyTorch port): problem types, collocation, the QP and
NLP transcriptions, flattening and the mesh-refinement driver."""

from . import collocation
from .flatten import flatten_ocp, unflatten_ocpsol
from .nlp import NLP, NLPSolution, NLPSolutionStatus
from .ocp import OCP, OCPSolution, test_ocp_derivatives
from .solve import SolveOCPParams, solve_ocp, solve_ocp_flat, solve_ocp_flat_batch
from .to_nlp import (
    nlp_initial_guess,
    nlp_layout,
    nlpsol_to_ocpsol,
    ocp_to_nlp,
    ocpsol_to_nlpsol,
)
from .to_qp import (
    body_velocity,
    ocp_to_qp,
    ocp_to_qp_vectors,
    qpsol_to_ocpsol,
    variable_layout,
)

__all__ = [
    "collocation",
    "OCP",
    "OCPSolution",
    "test_ocp_derivatives",
    "ocp_to_qp",
    "ocp_to_qp_vectors",
    "qpsol_to_ocpsol",
    "variable_layout",
    "body_velocity",
    "flatten_ocp",
    "unflatten_ocpsol",
    "NLP",
    "NLPSolution",
    "NLPSolutionStatus",
    "ocp_to_nlp",
    "nlp_layout",
    "nlp_initial_guess",
    "nlpsol_to_ocpsol",
    "ocpsol_to_nlpsol",
    "SolveOCPParams",
    "solve_ocp_flat",
    "solve_ocp_flat_batch",
    "solve_ocp",
]
