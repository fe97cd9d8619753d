"""Stokes discretization catalog.

Counterpart of ``navier_stokes_tpu/models/discretizations.py`` (reference
discretizations.py:6-88): each factory returns ``(discretization, order)``
where ``discretization(mesh, velocity_dirichlet)`` builds the (velocity,
pressure) space pair.  Velocity spaces are vector-valued (dim components of
one scalar space, component-major layout).

The inf-sup-stable pairs of the H1/L2 families (built by
models/stokes.build_stokes_system):
  taylor_hood(k)                        H1_k^dim x H1_{k-1}
  P1_nonconforming_velocity_constant_pressure   CR^dim x L2_0
  P2_velocity_constant_pressure         H1_2^dim x L2_0
  P2_velocity_linear_pressure           H1_2^dim x L2_1 (not inf-sup stable;
                                        kept for parity with the catalog)
  P2_velocity_with_cubic_bubbles_linear_pressure  (H1_2+bubble)^dim x L2_1
  mini                                  (H1_1+bubble)^dim x H1_1

The H(div)/HDG families: bdm_hybrid and rt_hybrid (optional hodivfree
reduction; models/stokes_hybrid.build_hybrid_stokes_system) and the MCS
triple hcurldiv (models/stokes_mcs).
"""

from __future__ import annotations

from ..fem.spaces import H1, L2, H1_with_bubble, Nonconforming, VectorSpace

__all__ = ["P1_nonconforming_velocity_constant_pressure",
           "P2_velocity_constant_pressure", "P2_velocity_linear_pressure",
           "P2_velocity_with_cubic_bubbles_linear_pressure", "bdm_hybrid",
           "hcurldiv", "mini", "rt_hybrid", "taylor_hood"]


def taylor_hood(order: int):
    def discretization(mesh, velocity_dirichlet):
        V = VectorSpace(H1(mesh, order, dirichlet=velocity_dirichlet),
                        mesh.dim)
        Q = H1(mesh, order - 1)
        return V, Q

    return (discretization, order)


def P1_nonconforming_velocity_constant_pressure():
    def discretization(mesh, velocity_dirichlet):
        V = VectorSpace(Nonconforming(mesh, dirichlet=velocity_dirichlet),
                        mesh.dim)
        Q = L2(mesh, 0)
        return V, Q

    return (discretization, 1)


def P2_velocity_constant_pressure():
    def discretization(mesh, velocity_dirichlet):
        V = VectorSpace(H1(mesh, 2, dirichlet=velocity_dirichlet), mesh.dim)
        Q = L2(mesh, 0)
        return V, Q

    return (discretization, 2)


def P2_velocity_linear_pressure():
    def discretization(mesh, velocity_dirichlet):
        V = VectorSpace(H1(mesh, 2, dirichlet=velocity_dirichlet), mesh.dim)
        Q = L2(mesh, 1)
        return V, Q

    return (discretization, 2)


def P2_velocity_with_cubic_bubbles_linear_pressure():
    def discretization(mesh, velocity_dirichlet):
        V = VectorSpace(
            H1_with_bubble(mesh, 2, dirichlet=velocity_dirichlet), mesh.dim
        )
        Q = L2(mesh, 1)
        return V, Q

    return (discretization, 2)


def mini():
    def discretization(mesh, velocity_dirichlet):
        V = VectorSpace(
            H1_with_bubble(mesh, 1, dirichlet=velocity_dirichlet), mesh.dim
        )
        Q = H1(mesh, 1)
        return V, Q

    return (discretization, 1)


def bdm_hybrid(order: int, penalty: float, hodivfree: bool = False):
    """HDiv-BDM x tangential-facet pair (discretizations.py:59-67)."""

    def discretization(mesh, velocity_dirichlet):
        from ..fem.hdiv import HDiv, VectorFacet
        from .stokes_hybrid import HybridVelocitySpace

        V = HDiv(mesh, order, dirichlet=velocity_dirichlet, RT=False,
                 hodivfree=hodivfree)
        Vhat = VectorFacet(mesh, order, dirichlet=velocity_dirichlet)
        Q = L2(mesh, 0 if hodivfree else order - 1)
        return HybridVelocitySpace(V, Vhat), Q

    return (discretization, order)


def rt_hybrid(order: int, penalty: float, hodivfree: bool = False):
    """HDiv-RT x tangential-facet pair (discretizations.py:70-78)."""

    def discretization(mesh, velocity_dirichlet):
        from ..fem.hdiv import HDiv, VectorFacet
        from .stokes_hybrid import HybridVelocitySpace

        V = HDiv(mesh, order, dirichlet=velocity_dirichlet, RT=True,
                 hodivfree=hodivfree)
        Vhat = VectorFacet(mesh, order, dirichlet=velocity_dirichlet)
        Q = L2(mesh, 0 if hodivfree else order - 1)
        return HybridVelocitySpace(V, Vhat), Q

    return (discretization, order)


def hcurldiv(order: int, raviart_thomas: bool = True):
    """HDiv x HCurlDiv x L2 MCS triple (discretizations.py:81-88)."""
    from .stokes_mcs import mcs_discretization

    return mcs_discretization(order, raviart_thomas)
