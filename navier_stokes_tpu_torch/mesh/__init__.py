from .generators import channel_with_cylinder_mesh, channel_with_cylinder_mesh_3d
from .mesh import Mesh

__all__ = ["Mesh", "channel_with_cylinder_mesh", "channel_with_cylinder_mesh_3d"]
