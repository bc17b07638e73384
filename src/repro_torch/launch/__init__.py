"""Command-line entry points of the port, the production meshes and the
dry-run planning tools."""
from .mesh import make_mesh_shape, make_production_mesh

__all__ = ["make_mesh_shape", "make_production_mesh"]
