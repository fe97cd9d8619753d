from .generators import (
    cavity_mesh,
    channel_with_cylinder_mesh,
    channel_with_cylinder_mesh_3d,
    polygon_mesh,
    rectangle_mesh,
    unit_square_mesh,
)
from .mesh import Mesh

__all__ = ["Mesh", "cavity_mesh", "channel_with_cylinder_mesh",
           "channel_with_cylinder_mesh_3d", "polygon_mesh", "rectangle_mesh",
           "unit_square_mesh"]
