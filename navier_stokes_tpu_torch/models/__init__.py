from .navier_stokes_mcs import NavierStokesMCS, load_host_tables

__all__ = ["NavierStokesMCS", "load_host_tables"]
