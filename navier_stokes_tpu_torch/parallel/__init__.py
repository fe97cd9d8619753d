"""Parameter sweeps of the port (``parallel/sweep.py``); the sharded
solves of the JAX package's ``parallel/`` are not ported yet."""

from .sweep import (
    advance_ensemble,
    make_viscosity_step,
    make_viscosity_step_mcs,
    mcs_nu_split_tables,
    run_reynolds_ensemble,
    run_reynolds_ensemble_mcs,
)

__all__ = ["make_viscosity_step", "mcs_nu_split_tables",
           "make_viscosity_step_mcs", "run_reynolds_ensemble_mcs",
           "run_reynolds_ensemble", "advance_ensemble"]
