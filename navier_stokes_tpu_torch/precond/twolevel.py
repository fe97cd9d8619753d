"""Coarse P1 solve of the auxiliary-space preconditioner.

Counterpart of ``coarse_p1_solver`` in
``navier_stokes_tpu/precond/twolevel.py``: the embedded P1 space on the same
mesh and Dirichlet boundary, its stiffness assembled on the host, and -- for
coarse spaces up to ``dense_limit`` free dofs -- a precomputed dense f64
inverse stored in ``dtype`` on the device.  The apply is one dense
``inv @ r`` (``torch.matmul``; the JAX package leaves it to XLA as well).
Larger coarse spaces take a smoothed-aggregation AMG V-cycle in the JAX
package; the port has not carried AMG over yet and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.spaces import H1, FunctionSpace
from ..ops.assembly import assemble_csr, stiffness_local


def coarse_p1_solver(space: FunctionSpace, coefficient: float = 1.0,
                     dtype=torch.float32, device="cpu",
                     dense_limit: int = 5000):
    """Apply r_coarse -> Kc^{-1} r_coarse (zero on constrained coarse dofs)
    for r of shape (nv,) or (nv, k)."""
    coarse = H1(space.mesh, 1, dirichlet=space.dirichlet_names)
    Kc = assemble_csr(stiffness_local(coarse), coarse.element_dofs,
                      coarse.ndof) * coefficient
    free = np.where(coarse.free_mask)[0]
    nv = coarse.ndof
    if len(free) > dense_limit:
        raise NotImplementedError(
            f"{len(free)} free coarse dofs exceed dense_limit={dense_limit}: "
            "the AMG coarse solve (precond/amg.py in the JAX package) is "
            "not ported yet")
    Kff = np.asarray(Kc[free][:, free].todense())
    inv = torch.as_tensor(np.linalg.inv(Kff), device=device).to(dtype)
    free_t = torch.as_tensor(free, device=device)

    def solve(r):
        out = r.new_zeros((nv,) + tuple(r.shape[1:]))
        out[free_t] = inv @ r[free_t]
        return out

    return solve
