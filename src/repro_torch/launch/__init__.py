"""Command-line entry points of the port, and its mesh constructors."""
from .mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
