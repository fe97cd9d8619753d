from .heat import (
    HeatEquation,
    exact_solution,
    heat_convergence_study,
    sum_of_unit_square_laplace_eigenfunctions,
)
from .navier_stokes import NavierStokes
from .navier_stokes_hdg3d import NavierStokesHDG3D
from .navier_stokes_mcs import NavierStokesMCS, load_host_tables

__all__ = ["HeatEquation", "NavierStokes", "NavierStokesHDG3D",
           "NavierStokesMCS", "exact_solution", "heat_convergence_study",
           "load_host_tables", "sum_of_unit_square_laplace_eigenfunctions"]
