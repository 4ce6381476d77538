"""Bridges to external solvers, the validation oracles (PyTorch port of
``smooth_feedback_tpu/compat``).

scipy's trust-constr is the NLP oracle of record; the OSQP and Ipopt
bridges activate only where ``osqp`` / ``cyipopt`` import.  Each runs its
solver on the host, with derivatives from ``torch.func`` evaluated on the
problem's own device.
"""

from .ipopt_bridge import ipopt_available, solve_nlp_ipopt
from .osqp_bridge import osqp_available, solve_qp_osqp
from .scipy_nlp import solve_nlp_scipy

__all__ = [
    "solve_nlp_scipy",
    "osqp_available",
    "solve_qp_osqp",
    "ipopt_available",
    "solve_nlp_ipopt",
]
