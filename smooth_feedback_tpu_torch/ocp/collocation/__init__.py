"""LGR collocation (PyTorch port): the mesh and functions over it."""

from .functions import mesh_dyn, mesh_dyn_error, mesh_eval, mesh_integrate, mesh_interp
from .mesh import Mesh, diffmat_local, intmat_local, lgr_nodes, lgr_plus_one

__all__ = [
    "Mesh",
    "lgr_nodes",
    "lgr_plus_one",
    "diffmat_local",
    "intmat_local",
    "mesh_eval",
    "mesh_integrate",
    "mesh_dyn",
    "mesh_dyn_error",
    "mesh_interp",
]
