from .navier_stokes_hdg3d import NavierStokesHDG3D
from .navier_stokes_mcs import NavierStokesMCS, load_host_tables

__all__ = ["NavierStokesHDG3D", "NavierStokesMCS", "load_host_tables"]
