"""The steady Stokes saddle system as a bundle of masked operators.

The port's copy of the ``StokesSystem`` dataclass of
``navier_stokes_tpu/models/stokes.py`` (its operator setup, solver
adapters and sweep harness are not ported yet: ROADMAP Queue 1 item 13
part 5).  The 3D hybrid builder (models/stokes_hybrid3d.
build_hybrid_stokes_system_3d) returns one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["StokesSystem"]


@dataclass
class StokesSystem:
    """Masked matrix-free operators + rhs for the saddle system
    [[A, B^T], [B, 0]] (du, p) = (f_mod, g_mod), with u = u_bc + du."""

    V: object
    Q: object
    A: Callable
    B: Callable
    BT: Callable
    preA: Callable
    preM: Callable
    f: torch.Tensor
    g: torch.Tensor
    u_bc: torch.Tensor
    ndofs: int

    def lift(self, du: torch.Tensor) -> torch.Tensor:
        return self.u_bc + du
