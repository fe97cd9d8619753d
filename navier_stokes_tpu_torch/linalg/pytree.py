"""Block-vector algebra on tensors and tuples of tensors.

Counterpart of ``navier_stokes_tpu/linalg/pytree.py``: a "vector" is a
tensor or a (nested) tuple of tensors -- e.g. the (u, p) pair of a
saddle-point system -- and these helpers give the axpy / inner-product
algebra the Krylov solvers need.  A tensor is a leaf, so the helpers act on
a single block as on a tuple of blocks.

``group``: on vectors split over the ranks of a process group (each rank
holding its own block, ``parallel/sharding.py``), an object whose
``all_reduce(t)`` returns the sum of ``t`` over the ranks -- a
:class:`~navier_stokes_tpu_torch.parallel.sharding.DeviceMesh`.  The inner
products then sum the local dot over the group (one ``all_reduce`` each);
``None`` keeps them local.
"""

from __future__ import annotations

import torch

__all__ = ["tdot", "tadd", "tsub", "tscale", "taxpy", "tzeros_like", "tnorm",
           "tmask"]


def _map(fn, *xs):
    if isinstance(xs[0], torch.Tensor):
        return fn(*xs)
    return tuple(_map(fn, *parts) for parts in zip(*xs))


def _leaves(x) -> list:
    """The tensors of ``x`` in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [leaf for part in x for leaf in _leaves(part)]


def tdot(x, y, group=None) -> torch.Tensor:
    """Global inner product sum_leaves <x_i, y_i> as a 0-d device tensor,
    summed over ``group``'s ranks when one is given."""
    s = sum(torch.dot(a.reshape(-1), b.reshape(-1))
            for a, b in zip(_leaves(x), _leaves(y)))
    return s if group is None else group.all_reduce(s)


def tadd(x, y):
    return _map(torch.add, x, y)


def tsub(x, y):
    return _map(torch.sub, x, y)


def tscale(a, x):
    return _map(lambda v: a * v, x)


def taxpy(a, x, y):
    """a*x + y"""
    return _map(lambda xv, yv: a * xv + yv, x, y)


def tzeros_like(x):
    return _map(torch.zeros_like, x)


def tnorm(x, group=None) -> torch.Tensor:
    """sqrt(tdot(x, x)) as a 0-d device tensor."""
    return torch.sqrt(tdot(x, x, group))


def tmask(mask, x):
    """Zero out the entries where ``mask`` is False (``mask`` of the same
    structure as ``x``)."""
    return _map(lambda m, v: torch.where(m, v, 0.0), mask, x)
