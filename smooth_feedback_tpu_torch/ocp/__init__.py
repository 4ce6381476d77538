"""Optimal control (PyTorch port): problem types and QP transcription."""

from . import collocation
from .ocp import OCP, OCPSolution
from .to_qp import body_velocity, ocp_to_qp, ocp_to_qp_vectors, variable_layout

__all__ = [
    "collocation",
    "OCP",
    "OCPSolution",
    "ocp_to_qp",
    "ocp_to_qp_vectors",
    "variable_layout",
    "body_velocity",
]
