"""Parameter sweeps and sharded solves of the port: ``sweep.py`` (the
Reynolds-number ensembles), ``sharding.py`` (the process-group handle, the
launcher, element- and batch-sharded applies), ``ddshard.py`` (dof-sharded
halo-exchange operators, the sharded BPCG solve) and ``faceshard.py`` (the
face-sharded production solve), on ``torch.distributed``."""

from .sharding import (
    Ranks,
    device_mesh,
    launch,
    pad_elements,
    sharded_batch_step,
    sharded_local_operator,
    single_rank,
)
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
           "run_reynolds_ensemble", "advance_ensemble", "device_mesh",
           "sharded_local_operator", "sharded_batch_step", "pad_elements",
           "launch", "single_rank", "Ranks"]
