"""Checkpoint / resume of a Navier-Stokes model's evolving state.

Counterpart of ``navier_stokes_tpu/utils/checkpoint.py``: the state is the
(velocity, pressure, time, step) of a model -- enough to resume
``DoTimeStep`` loops bit for bit -- stored as npz under the JAX package's
keys (``u, p, time, step, nu, timestep, order, ndof_v, ndof_q``), so that a
file written by either package loads into the other.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_state", "load_state"]


def save_state(path: str, model, time: float = 0.0, step: int = 0) -> None:
    """Snapshot a Navier-Stokes model's evolving state (``u``, ``p`` in
    the model's dtype)."""
    np.savez(
        path,
        u=model.u.detach().cpu().numpy(),
        p=model.p.detach().cpu().numpy(),
        time=time,
        step=step,
        nu=model.nu,
        timestep=model.timestep,
        order=model.order,
        ndof_v=model.V.ndof,
        ndof_q=model.Q.ndof,
    )


def load_state(path: str, model) -> tuple[float, int]:
    """Restore (u, p) into a compatible model, on its device in its dtype;
    returns (time, step).  Raises ValueError when the file's velocity or
    pressure space differs in size from the model's."""
    data = np.load(path)
    if (int(data["ndof_v"]) != model.V.ndof
            or int(data["ndof_q"]) != model.Q.ndof):
        raise ValueError(
            "checkpoint incompatible with model: "
            f"V {int(data['ndof_v'])} vs {model.V.ndof}, "
            f"Q {int(data['ndof_q'])} vs {model.Q.ndof}"
        )
    model.u = torch.as_tensor(data["u"]).to(device=model.device,
                                            dtype=model.dtype)
    model.p = torch.as_tensor(data["p"]).to(device=model.device,
                                            dtype=model.dtype)
    return float(data["time"]), int(data["step"])
