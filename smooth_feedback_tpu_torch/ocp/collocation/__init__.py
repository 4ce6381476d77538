"""LGR collocation (PyTorch port): the mesh."""

from .mesh import Mesh, diffmat_local, intmat_local, lgr_nodes, lgr_plus_one

__all__ = ["Mesh", "lgr_nodes", "lgr_plus_one", "diffmat_local", "intmat_local"]
