from . import distributed, halo
from .mesh import (
    AXES_2D,
    AXIS,
    Mesh,
    current_halo_mode,
    current_mesh,
    make_mesh,
    make_mesh2d,
    mesh_devices,
    mesh_is_2d,
    spatial_sharding,
)
