"""Parity of the port's 2D host modules (navier_stokes_tpu_torch) with the
JAX package: the 2D and polygon mesh generators, the triangle Lagrange
bases, ``H1`` / ``VectorH1`` on triangles, the H(div) (BDM, RT,
hodivfree) and tangential facet spaces, the H(curl,div) stress element,
the facet geometry, the curved 2D geometry maps and the tables form of
``ops/assembly`` (``make_tables`` and the element forms).

The same inputs go through both packages.  Tolerances: integer tables
(elements, dof tables, boundary tags, masks) equal; values (points, signs,
basis coefficients and tabulations, geometry) within 1e-13 in the
infinity norm, relative to the largest entry; the torch element forms of
``ops/assembly`` within 1e-13 of the JAX ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.fem import hcurldiv as jax_hcurldiv
from navier_stokes_tpu.fem import hdiv as jax_hdiv
from navier_stokes_tpu.fem import reference as jax_ref
from navier_stokes_tpu.fem import spaces as jax_spaces
from navier_stokes_tpu.mesh import curved as jax_curved
from navier_stokes_tpu.mesh import generators as jax_gen
from navier_stokes_tpu.ops import assembly as jax_asm
from navier_stokes_tpu.ops.facets import facet_geometry as jax_facets
from navier_stokes_tpu_torch.fem import hcurldiv, hdiv, reference, spaces
from navier_stokes_tpu_torch.fem.quadrature import triangle_rule
from navier_stokes_tpu_torch.mesh import curved, generators
from navier_stokes_tpu_torch.ops import assembly as asm
from navier_stokes_tpu_torch.ops.facets import facet_geometry

TOL = 1e-13


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for PyTorch and one for numpy's BLAS: the
    suite runs several workers at once, and a thread pool per worker
    beside them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _close(want, got, tol=TOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert want.shape == got.shape
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    assert float(np.abs(want - got).max(initial=0.0)) <= tol * scale


def _same_mesh(mj, mp):
    _close(mj.points, mp.points)
    np.testing.assert_array_equal(mj.elements, mp.elements)
    assert sorted(mj.boundary_tags) == sorted(mp.boundary_tags)
    for k in mj.boundary_tags:
        np.testing.assert_array_equal(mj.boundary_tags[k],
                                      mp.boundary_tags[k])
    np.testing.assert_array_equal(mj.edges, mp.edges)
    np.testing.assert_array_equal(mj.element_edges, mp.element_edges)
    np.testing.assert_array_equal(mj.element_edge_flip,
                                  mp.element_edge_flip)


MESHES = {
    "unit_square": lambda g: g.unit_square_mesh(0.25),
    "rectangle": lambda g: g.rectangle_mesh(0.1, 2.0, 0.41),
    "cavity": lambda g: g.cavity_mesh(0.2),
    "channel": lambda g: g.channel_with_cylinder_mesh(0.3),
    "polygon": lambda g: g.polygon_mesh(
        [[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]], maxh=0.3,
        holes=[[[0.3, 0.3], [0.6, 0.3], [0.6, 0.6], [0.3, 0.6]]],
        names=["bottom", "right", "top", "inner", "top", "left"],
        hole_names=["hole"]),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_2d_generators_match_jax(name):
    mj, mp = MESHES[name](jax_gen), MESHES[name](generators)
    assert mp.dim == 2
    _same_mesh(mj, mp)
    if name == "channel":
        assert mp.ne == 420


@pytest.mark.parametrize("order", [1, 2, 3])
def test_triangle_lagrange_matches_jax(order):
    nj, lj = jax_ref.triangle_lagrange_nodes(order)
    npp, lp = reference.triangle_lagrange_nodes(order)
    _close(nj, npp)
    assert lj == lp
    bj, bp = jax_ref.lagrange_triangle(order), reference.lagrange_triangle(
        order)
    assert (bp.n_basis, bp.n_vertex, bp.n_edge, bp.n_cell) == (
        bj.n_basis, bj.n_vertex, bj.n_edge, bj.n_cell)
    pts = triangle_rule(2 * order + 1).points
    for a, b in zip(bj.tabulate(pts), bp.tabulate(pts)):
        _close(a, b)
    dj, dp = (jax_ref.discontinuous_simplex(order - 1, 2),
              reference.discontinuous_simplex(order - 1, 2))
    assert dp.n_basis == dj.n_basis and dp.name == dj.name
    for a, b in zip(dj.tabulate(pts), dp.tabulate(pts)):
        _close(a, b)


@pytest.mark.parametrize("order", [1, 2])
def test_h1_and_vector_h1_on_triangles_match_jax(order):
    mj = jax_gen.channel_with_cylinder_mesh(0.3)
    mp = generators.channel_with_cylinder_mesh(0.3)
    Sj = jax_spaces.H1(mj, order, dirichlet="inlet|wall")
    Sp = spaces.H1(mp, order, dirichlet="inlet|wall")
    assert Sp.ndof == Sj.ndof
    np.testing.assert_array_equal(Sj.element_dofs, Sp.element_dofs)
    np.testing.assert_array_equal(Sj.free_mask, Sp.free_mask)
    Vj = jax_spaces.VectorH1(mj, order, dirichlet="inlet|wall|cyl")
    Vp = spaces.VectorH1(mp, order, dirichlet="inlet|wall|cyl")
    assert (Vp.ndof, Vp.ncomp, Vp.order) == (Vj.ndof, Vj.ncomp, Vj.order)
    np.testing.assert_array_equal(Vj.free_mask, Vp.free_mask)
    np.testing.assert_array_equal(Vj.boundary_dof_mask("cyl"),
                                  Vp.boundary_dof_mask("cyl"))

    def f(p):
        return np.stack([np.sin(p[:, 0]) * p[:, 1], p[:, 0] ** 2], axis=1)

    _close(Vj.interpolate(f), Vp.interpolate(f))
    _close(Vj.interpolate_boundary(f, "inlet"),
           Vp.interpolate_boundary(f, "inlet"))


@pytest.mark.parametrize("order,rt,hodivfree", [
    (1, False, False), (2, False, False), (3, False, False),
    (1, True, False), (2, False, True)])
def test_hdiv_spaces_match_jax(order, rt, hodivfree):
    mj = jax_gen.channel_with_cylinder_mesh(0.3)
    mp = generators.channel_with_cylinder_mesh(0.3)
    kw = dict(dirichlet="inlet|wall", RT=rt, hodivfree=hodivfree)
    Vj, Vp = jax_hdiv.HDiv(mj, order, **kw), hdiv.HDiv(mp, order, **kw)
    assert (Vp.ndof, Vp.name) == (Vj.ndof, Vj.name)
    bj, bp = Vj.basis, Vp.basis
    assert (bp.n_basis, bp.n_edge, bp.n_cell, bp.modal_order) == (
        bj.n_basis, bj.n_edge, bj.n_cell, bj.modal_order)
    _close(bj.coeffs, bp.coeffs)
    np.testing.assert_array_equal(Vj.element_dofs, Vp.element_dofs)
    np.testing.assert_array_equal(Vj.element_signs, Vp.element_signs)
    np.testing.assert_array_equal(Vj.free_mask, Vp.free_mask)
    pts = triangle_rule(2 * order + 2).points
    for a, b in zip(bj.tabulate(pts), bp.tabulate(pts)):
        _close(a, b)
    t = np.linspace(0.0, 1.0, 7)
    for j in range(4):
        _close(jax_hdiv.legendre_01(t, j), hdiv.legendre_01(t, j))
    for e in range(3):
        _close(jax_hdiv.edge_points(e, t), hdiv.edge_points(e, t))


def test_vector_facet_matches_jax():
    mj = jax_gen.channel_with_cylinder_mesh(0.3)
    mp = generators.channel_with_cylinder_mesh(0.3)
    for order in (0, 1, 2):
        Fj = jax_hdiv.VectorFacet(mj, order, dirichlet="inlet|wall|outlet")
        Fp = hdiv.VectorFacet(mp, order, dirichlet="inlet|wall|outlet")
        assert (Fp.ndof, Fp.n_edge) == (Fj.ndof, Fj.n_edge)
        np.testing.assert_array_equal(Fj.free_mask, Fp.free_mask)
        _close(Fj.edge_tangents, Fp.edge_tangents)


@pytest.mark.parametrize("order,trace", [(2, 1), (2, None), (3, 2)])
def test_hcurldiv_triangle_matches_jax(order, trace):
    bj = jax_hcurldiv.hcurldiv_triangle(order, order_trace=trace)
    bp = hcurldiv.hcurldiv_triangle(order, order_trace=trace)
    assert (bp.n_basis, bp.n_edge, bp.n_cell, bp.name) == (
        bj.n_basis, bj.n_edge, bj.n_cell, bj.name)
    _close(bj.coeffs, bp.coeffs)
    pts = triangle_rule(2 * order + 2).points
    for a, b in zip(bj.tabulate(pts), bp.tabulate(pts)):
        _close(a, b)
    if trace is None:
        mj = jax_gen.channel_with_cylinder_mesh(0.3)
        mp = generators.channel_with_cylinder_mesh(0.3)
        Sj = jax_hcurldiv.HCurlDiv(mj, order, dirichlet="wall")
        Sp = hcurldiv.HCurlDiv(mp, order, dirichlet="wall")
        assert Sp.ndof == Sj.ndof
        np.testing.assert_array_equal(Sj.element_dofs, Sp.element_dofs)
        np.testing.assert_array_equal(Sj.element_signs, Sp.element_signs)
        np.testing.assert_array_equal(Sj.free_mask, Sp.free_mask)


@pytest.mark.parametrize("nq1", [4, 6])
def test_facet_geometry_matches_jax(nq1):
    mj = jax_gen.channel_with_cylinder_mesh(0.3)
    mp = generators.channel_with_cylinder_mesh(0.3)
    gj, gp = jax_facets(mj, nq1), facet_geometry(mp, nq1)
    for field in ("t", "w", "ref_points", "normal", "elen", "tau_global",
                  "t_global"):
        _close(getattr(gj, field), getattr(gp, field))
    np.testing.assert_array_equal(gj.flip, gp.flip)


def test_curved_circle_geometry_matches_jax():
    mj = jax_gen.channel_with_cylinder_mesh(0.3)
    mp = generators.channel_with_cylinder_mesh(0.3)
    gj = jax_curved.curve_to_circle(mj, "cyl", (0.2, 0.2), 0.05, order=3)
    gp = curved.curve_to_circle(mp, "cyl", (0.2, 0.2), 0.05, order=3)
    _close(gj.coords, gp.coords)
    assert gp.basis.n_basis == gj.basis.n_basis == 10
    pts = triangle_rule(8).points
    for a, b in zip(jax_curved.geometry_tables(gj, pts),
                    curved.geometry_tables(gp, pts)):
        _close(a, b)
    _close(jax_curved.geometry_hessian(gj, pts),
           curved.geometry_hessian(gp, pts))
    # the snapped cylinder nodes lie on the circle
    on = np.abs(np.linalg.norm(gp.coords - 0.2, axis=-1) - 0.05) < 1e-12
    assert on.sum() > 0
    with pytest.raises(ValueError):
        curved.curve_to_circle(generators.channel_with_cylinder_mesh_3d(0.6),
                               "cyl", (0.2, 0.2), 0.05)


@pytest.mark.parametrize("curved_map", [False, True])
def test_assembly_tables_match_jax(curved_map):
    mj = jax_gen.channel_with_cylinder_mesh(0.3)
    mp = generators.channel_with_cylinder_mesh(0.3)
    geo_j = geo_p = None
    if curved_map:
        geo_j = jax_curved.curve_to_circle(mj, "cyl", (0.2, 0.2), 0.05, 3)
        geo_p = curved.curve_to_circle(mp, "cyl", (0.2, 0.2), 0.05, 3)
    Uj, Up = jax_spaces.H1(mj, 2), spaces.H1(mp, 2)
    Pj, Pp = jax_spaces.H1(mj, 1), spaces.H1(mp, 1)
    tj = jax_asm.make_tables(Uj, 5, jnp.float64, geometry=geo_j)
    tp = asm.make_tables(Up, 5, torch.float64, geometry=geo_p, device="cpu")
    tjp = jax_asm.make_tables(Pj, 5, jnp.float64, geometry=geo_j)
    tpp = asm.make_tables(Pp, 5, torch.float64, geometry=geo_p, device="cpu")
    for field in ("qw", "val", "grad", "detj", "jinv", "qpts"):
        _close(getattr(tj, field), getattr(tp, field).numpy())
    np.testing.assert_array_equal(np.asarray(tj.eldofs), tp.eldofs.numpy())
    assert tp.ndof == tj.ndof
    pairs = [
        (jax_asm.mass_local(tj), asm.mass_local(tp)),
        (jax_asm.stiffness_local(tj), asm.stiffness_local(tp)),
        (jax_asm.phys_grad(tj), asm.phys_grad(tp)),
        (jax_asm.divergence_local(tjp, tj), asm.divergence_local(tpp, tp)),
    ]
    fq = np.random.default_rng(0).standard_normal(tp.qpts.shape[:2])
    pairs.append((jax_asm.linear_form_local(tj, jnp.asarray(fq)),
                  asm.linear_form_local(tp, torch.from_numpy(fq))))
    for a, b in pairs:
        _close(np.asarray(a), b.numpy())
    # the space form of stiffness_local (host, affine) agrees on straight
    # elements
    if not curved_map:
        _close(np.asarray(jax_asm.stiffness_local(tj)),
               asm.stiffness_local(Up))
