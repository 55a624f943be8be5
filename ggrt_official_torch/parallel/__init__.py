from .mesh import make_mesh
