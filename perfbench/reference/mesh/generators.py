"""Frozen copy of ``navier_stokes_tpu_torch/mesh/generators.py`` for the benchmark's
plain reference (imports nothing of the program).

Mesh generators for the reference benchmark geometries.

The port's own copy of ``navier_stokes_tpu/mesh/generators.py``: the unit
square, the channel rectangle and the lid-driven cavity, the unit cube
(``unit_cube_mesh``), the 2D Schaefer-Turek channel with its cylinder
(reference run.py:22-29), its extrusion to tets and
``channel_with_cylinder_mesh_3d`` (reference
templates/NavierStokesSIMPLE_test_3D.py:8-16), and the general polygon
frontend ``polygon_mesh``.  Host-side numpy/scipy.
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh

_TOL = 1e-9


def unit_square_mesh(maxh: float = 0.1) -> Mesh:
    """Structured triangulation of (0,1)^2 with NGSolve boundary names.

    Boundary names match netgen's unit_square: bottom, right, top, left.
    """
    n = max(1, round(1.0 / maxh))
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (n + 1) + j

    tris = []
    for i in range(n):
        for j in range(n):
            v00, v10 = vid(i, j), vid(i + 1, j)
            v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
            # alternate the diagonal for isotropy
            if (i + j) % 2 == 0:
                tris += [[v00, v10, v11], [v00, v11, v01]]
            else:
                tris += [[v00, v10, v01], [v10, v11, v01]]
    mesh = Mesh(pts, np.array(tris, dtype=np.int32))
    mesh.ensure_positive_orientation()
    mesh.tag_boundary_by_predicate("bottom", lambda p: np.abs(p[:, :, 1]) < _TOL)
    mesh.tag_boundary_by_predicate("right", lambda p: np.abs(p[:, :, 0] - 1) < _TOL)
    mesh.tag_boundary_by_predicate("top", lambda p: np.abs(p[:, :, 1] - 1) < _TOL)
    mesh.tag_boundary_by_predicate("left", lambda p: np.abs(p[:, :, 0]) < _TOL)
    return mesh


def rectangle_mesh(
    maxh: float = 0.1, length: float = 2.0, height: float = 0.41
) -> Mesh:
    """Structured channel rectangle: inlet (x=0), outlet (x=length),
    wall (y=0, y=height)."""
    nx = max(1, round(length / maxh))
    ny = max(1, round(height / maxh))
    xs = np.linspace(0.0, length, nx + 1)
    ys = np.linspace(0.0, height, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    tris = []
    for i in range(nx):
        for j in range(ny):
            v00, v10 = vid(i, j), vid(i + 1, j)
            v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
            if (i + j) % 2 == 0:
                tris += [[v00, v10, v11], [v00, v11, v01]]
            else:
                tris += [[v00, v10, v01], [v10, v11, v01]]
    mesh = Mesh(pts, np.array(tris, dtype=np.int32))
    mesh.ensure_positive_orientation()
    mesh.tag_boundary_by_predicate("inlet", lambda p: np.abs(p[:, :, 0]) < _TOL)
    mesh.tag_boundary_by_predicate(
        "outlet", lambda p: np.abs(p[:, :, 0] - length) < _TOL
    )
    mesh.tag_boundary_by_predicate(
        "wall",
        lambda p: (np.abs(p[:, :, 1]) < _TOL) | (np.abs(p[:, :, 1] - height) < _TOL),
    )
    return mesh


def cavity_mesh(maxh: float = 0.05) -> Mesh:
    """Unit-square lid-driven cavity: lid (top) + wall (other three sides)."""
    mesh = unit_square_mesh(maxh)
    mesh.tag_boundary_by_predicate("lid", lambda p: np.abs(p[:, :, 1] - 1) < _TOL)
    wall = np.concatenate(
        [mesh.boundary_tags[k] for k in ("bottom", "left", "right")]
    )
    mesh.boundary_tags["wall"] = np.unique(wall).astype(np.int32)
    return mesh


def extrude_to_tets(mesh2d: Mesh, z_levels: np.ndarray) -> Mesh:
    """Extrude a triangle mesh along z and split each prism into 3 tets.

    Prism splitting uses the vertex-index rule (Dompierre et al.): the
    diagonal of every quad face is chosen by global vertex ids, so adjacent
    prisms tessellate their shared faces compatibly.
    """
    nv2, nl = mesh2d.nv, len(z_levels)
    pts = np.concatenate(
        [
            np.concatenate(
                [mesh2d.points, np.full((nv2, 1), z)], axis=1
            )
            for z in z_levels
        ]
    )
    tets = []
    for layer in range(nl - 1):
        lo, hi = layer * nv2, (layer + 1) * nv2
        for tri in mesh2d.elements:
            a, b, c = (int(t) for t in tri)
            # rotate so the smallest bottom id comes first
            v = [a, b, c]
            r = int(np.argmin(v))
            v0, v1, v2 = v[r], v[(r + 1) % 3], v[(r + 2) % 3]
            b0, b1, b2 = lo + v0, lo + v1, lo + v2
            t0, t1, t2 = hi + v0, hi + v1, hi + v2
            if min(v1, v2 + nv2) < min(v2, v1 + nv2):
                tets += [[b0, b1, b2, t2], [b0, b1, t2, t1], [b0, t1, t2, t0]]
            else:
                tets += [[b0, b1, b2, t1], [b0, t1, b2, t2], [b0, t1, t2, t0]]
    mesh = Mesh(pts, np.array(tets, dtype=np.int32))
    mesh.ensure_positive_orientation()
    return mesh


def unit_cube_mesh(maxh: float = 0.25) -> Mesh:
    """Structured tet mesh of (0,1)^3 with netgen unit_cube boundary names:
    left (x=0), right (x=1), front (y=0), back (y=1), bottom (z=0), top (z=1)."""
    sq = unit_square_mesh(maxh)
    n = max(1, round(1.0 / maxh))
    mesh = extrude_to_tets(sq, np.linspace(0.0, 1.0, n + 1))
    for name, axis, val in [
        ("left", 0, 0.0), ("right", 0, 1.0), ("front", 1, 0.0),
        ("back", 1, 1.0), ("bottom", 2, 0.0), ("top", 2, 1.0),
    ]:
        mesh.tag_boundary_by_predicate(
            name, lambda p, a=axis, v=val: np.abs(p[:, :, a] - v) < _TOL
        )
    return mesh


def channel_with_cylinder_mesh_3d(
    maxh: float = 0.1,
    length: float = 2.5,
    height: float = 0.41,
    cyl_center: tuple[float, float] = (0.5, 0.2),
    cyl_radius: float = 0.05,
    circle_resolution: int = 16,
) -> Mesh:
    """3D Schaefer-Turek channel: brick (0,0,0)-(length,H,H) minus a
    z-axis-parallel cylinder at (0.5, 0.2), the geometry of
    reference templates/NavierStokesSIMPLE_test_3D.py:8-14 (the brick
    x-range is clipped by the inlet/outlet planes to [0, 2.5] there).

    Boundary names: inlet (x=0), outlet (x=length), wall (brick faces),
    cyl (cylinder surface)."""
    base = channel_with_cylinder_mesh(
        maxh, length=length, height=height,
        cyl_center=cyl_center, cyl_radius=cyl_radius,
        circle_resolution=circle_resolution,
    )
    nz = max(2, round(height / maxh))
    mesh = extrude_to_tets(base, np.linspace(0.0, height, nz + 1))
    cx, cy = cyl_center
    mesh.tag_boundary_by_predicate(
        "inlet", lambda p: np.abs(p[:, :, 0]) < _TOL
    )
    mesh.tag_boundary_by_predicate(
        "outlet", lambda p: np.abs(p[:, :, 0] - length) < _TOL
    )
    mesh.tag_boundary_by_predicate(
        "cyl",
        lambda p: np.abs(
            np.hypot(p[:, :, 0] - cx, p[:, :, 1] - cy) - cyl_radius
        ) < 1e-6 * (1 + cyl_radius),
    )
    # walls: everything else on the boundary
    tagged = np.concatenate(
        [mesh.boundary_tags[k] for k in ("inlet", "outlet", "cyl")]
    )
    wall = np.setdiff1d(mesh.boundary_facets, tagged)
    mesh.boundary_tags["wall"] = wall.astype(np.int32)
    return mesh


def channel_with_cylinder_mesh(
    maxh: float = 0.1,
    length: float = 2.0,
    height: float = 0.41,
    cyl_center: tuple[float, float] = (0.2, 0.2),
    cyl_radius: float = 0.05,
    refine_cylinder: float = 0.35,
    circle_resolution: int = 16,
) -> Mesh:
    """Schaefer-Turek channel: rectangle with a circular hole.

    Boundary names follow reference run.py:24-26: "inlet" (x=0),
    "outlet" (x=length), "wall" (y=0 and y=height), "cyl" (circle).

    Construction: graded background grid + concentric point rings around the
    cylinder, Delaunay triangulation, removal of hole triangles, and exact
    snapping of the innermost ring onto the circle.
    """
    from scipy.spatial import Delaunay

    cx, cy = cyl_center
    r = cyl_radius

    nx = max(2, round(length / maxh))
    ny = max(2, round(height / maxh))
    xs = np.linspace(0.0, length, nx + 1)
    ys = np.linspace(0.0, height, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    grid = np.stack([X.ravel(), Y.ravel()], axis=1)

    # concentric rings around the cylinder (innermost exactly on the circle)
    h_cyl = min(maxh * refine_cylinder, 2 * np.pi * r / circle_resolution)
    n_ring = max(16, int(np.ceil(2 * np.pi * r / h_cyl)))
    rings = []
    ring_radii = [r]
    rr = r
    while rr < r + 1.2 * maxh:
        rr = rr + h_cyl * (rr / r) ** 0.5
        ring_radii.append(rr)
    for i, rr in enumerate(ring_radii):
        m = max(12, int(np.ceil(2 * np.pi * rr / (h_cyl * (rr / r) ** 0.5))))
        th = np.linspace(0, 2 * np.pi, m, endpoint=False) + (i % 2) * np.pi / m
        ring = np.stack([cx + rr * np.cos(th), cy + rr * np.sin(th)], axis=1)
        rings.append(ring)
    ring_pts = np.concatenate(rings, axis=0)
    # keep ring points inside the rectangle
    ring_pts = ring_pts[
        (ring_pts[:, 0] > _TOL)
        & (ring_pts[:, 0] < length - _TOL)
        & (ring_pts[:, 1] > _TOL)
        & (ring_pts[:, 1] < height - _TOL)
    ]

    # drop grid points that are inside the outermost ring region
    d_grid = np.hypot(grid[:, 0] - cx, grid[:, 1] - cy)
    on_boundary = (
        (np.abs(grid[:, 0]) < _TOL)
        | (np.abs(grid[:, 0] - length) < _TOL)
        | (np.abs(grid[:, 1]) < _TOL)
        | (np.abs(grid[:, 1] - height) < _TOL)
    )
    keep = (d_grid > ring_radii[-1] + 0.55 * h_cyl) | (
        on_boundary & (d_grid > r + 0.5 * h_cyl)
    )
    pts = np.concatenate([grid[keep], ring_pts], axis=0)

    def triangulate(p):
        els = Delaunay(p).simplices
        cent = p[els].mean(axis=1)
        d_cent = np.hypot(cent[:, 0] - cx, cent[:, 1] - cy)
        els = els[d_cent > r * (1.0 - 1e-12)]
        v = p[els]
        area2 = np.abs(
            (v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
            - (v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1])
        )
        return els[area2 > 1e-10 * maxh * maxh]

    # points that must not move: rectangle boundary + the circle ring
    d_pts = np.hypot(pts[:, 0] - cx, pts[:, 1] - cy)
    fixed = (
        (np.abs(pts[:, 0]) < _TOL)
        | (np.abs(pts[:, 0] - length) < _TOL)
        | (np.abs(pts[:, 1]) < _TOL)
        | (np.abs(pts[:, 1] - height) < _TOL)
        | (np.abs(d_pts - r) < 1e-9 * (1 + r))
    )

    els = triangulate(pts)
    # Laplacian smoothing + re-Delaunay rounds: the raw ring-to-grid
    # transition band can contain near-degenerate slivers at coarse maxh
    # (observed aspect ~1800 at maxh=0.2), which poison both the element
    # conditioning and the f32 solver floor; a few smoothing rounds bring
    # the worst aspect down to O(5).
    for _ in range(4):
        nbr_sum = np.zeros_like(pts)
        nbr_cnt = np.zeros(len(pts))
        for a, b in ((0, 1), (1, 2), (2, 0)):
            np.add.at(nbr_sum, els[:, a], pts[els[:, b]])
            np.add.at(nbr_cnt, els[:, a], 1.0)
            np.add.at(nbr_sum, els[:, b], pts[els[:, a]])
            np.add.at(nbr_cnt, els[:, b], 1.0)
        new = nbr_sum / np.maximum(nbr_cnt, 1.0)[:, None]
        pts = np.where(fixed[:, None], pts, new)
        # keep smoothed points out of the hole
        d_new = np.hypot(pts[:, 0] - cx, pts[:, 1] - cy)
        bad = (~fixed) & (d_new < r + 0.3 * h_cyl)
        if bad.any():
            scale = (r + 0.3 * h_cyl) / np.maximum(d_new[bad], 1e-12)
            pts[bad] = np.stack(
                [cx + (pts[bad, 0] - cx) * scale,
                 cy + (pts[bad, 1] - cy) * scale], axis=1
            )
        els = triangulate(pts)

    # drop unused points and remap
    used = np.unique(els)
    remap = -np.ones(len(pts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    mesh = Mesh(pts[used], remap[els].astype(np.int32))
    mesh.ensure_positive_orientation()

    mesh.tag_boundary_by_predicate("inlet", lambda p: np.abs(p[:, :, 0]) < _TOL)
    mesh.tag_boundary_by_predicate(
        "outlet", lambda p: np.abs(p[:, :, 0] - length) < _TOL
    )
    mesh.tag_boundary_by_predicate(
        "wall",
        lambda p: (np.abs(p[:, :, 1]) < _TOL) | (np.abs(p[:, :, 1] - height) < _TOL),
    )
    mesh.tag_boundary_by_predicate(
        "cyl",
        lambda p: np.abs(np.hypot(p[:, :, 0] - cx, p[:, :, 1] - cy) - r) < 1e-6 * (1 + r),
    )
    return mesh


# ----------------------------------------------------------------------
# General 2D polygon frontend (the reference meshes arbitrary 2D spline
# geometries through Netgen, reference run.py:22-29; this is the
# rectilinear-and-polygonal slice of that capability: simple polygons
# with polygonal holes, per-edge boundary names, Delaunay + smoothing —
# combined with ``extrude_to_tets`` it also covers extruded 3D solids)
# ----------------------------------------------------------------------


def _points_in_polygon(q: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Vectorized crossing-number test: q (n, 2) inside poly (m, 2)."""
    x, y = q[:, 0:1], q[:, 1:2]
    x0, y0 = poly[:, 0][None, :], poly[:, 1][None, :]
    x1 = np.roll(poly[:, 0], -1)[None, :]
    y1 = np.roll(poly[:, 1], -1)[None, :]
    cross = ((y0 > y) != (y1 > y)) & (
        x < x0 + (y - y0) * (x1 - x0) / np.where(y1 == y0, np.inf, y1 - y0)
    )
    return (cross.sum(axis=1) % 2).astype(bool)


def _dist_to_segments(q: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Min distance from each q (n, 2) to the polygon's edges."""
    a = poly
    b = np.roll(poly, -1, axis=0)
    ab = b - a  # (m, 2)
    ab2 = np.maximum((ab * ab).sum(axis=1), 1e-300)
    aq = q[:, None, :] - a[None, :, :]  # (n, m, 2)
    t = np.clip((aq * ab[None]).sum(axis=2) / ab2[None, :], 0.0, 1.0)
    proj = a[None] + t[:, :, None] * ab[None]
    d = np.linalg.norm(q[:, None, :] - proj, axis=2)
    return d.min(axis=1)


def _sample_polygon_edges(poly: np.ndarray, maxh: float):
    """Boundary points at spacing <= maxh + per-point edge ids."""
    pts, eid = [], []
    m = len(poly)
    for i in range(m):
        a, b = poly[i], poly[(i + 1) % m]
        n = max(1, int(np.ceil(np.linalg.norm(b - a) / maxh)))
        t = np.arange(n) / n
        pts.append(a[None] + t[:, None] * (b - a)[None])
        eid.append(np.full(n, i))
    return np.concatenate(pts), np.concatenate(eid)


def polygon_mesh(
    vertices,
    maxh: float = 0.1,
    holes=None,
    names=None,
    hole_names=None,
    smooth_rounds: int = 4,
) -> Mesh:
    """Unstructured triangulation of a simple polygon with polygonal holes.

    ``vertices``: (m, 2) outer boundary, counter-clockwise.  ``holes``:
    optional list of (k, 2) hole polygons (any orientation).  ``names``:
    per-outer-edge boundary names (list of m strings, edge i = vertices
    i -> i+1), default all "boundary"; ``hole_names``: one name per hole,
    default "hole0", "hole1", ...  Construction mirrors
    ``channel_with_cylinder_mesh``: boundary sampling at spacing <= maxh,
    interior grid filtered by point-in-polygon + boundary clearance,
    Delaunay, centroid-based hole/outside removal, Laplacian smoothing
    with fixed boundary points.
    """
    from scipy.spatial import Delaunay

    outer = np.asarray(vertices, np.float64)
    holes = [np.asarray(h, np.float64) for h in (holes or [])]
    if names is None:
        names = ["boundary"] * len(outer)
    assert len(names) == len(outer), "one name per outer edge"
    if hole_names is None:
        hole_names = [f"hole{i}" for i in range(len(holes))]

    bpts, beid = _sample_polygon_edges(outer, maxh)
    hole_pts = []
    hole_eids = []
    for h in holes:
        hp, _ = _sample_polygon_edges(h, maxh)
        hole_pts.append(hp)
    all_b = np.concatenate([bpts] + hole_pts) if hole_pts else bpts

    lo, hi = outer.min(axis=0), outer.max(axis=0)
    nx = max(2, int(np.ceil((hi[0] - lo[0]) / maxh)))
    ny = max(2, int(np.ceil((hi[1] - lo[1]) / maxh)))
    gx = np.linspace(lo[0], hi[0], nx + 1)
    gy = np.linspace(lo[1], hi[1], ny + 1)
    GX, GY = np.meshgrid(gx, gy, indexing="ij")
    grid = np.stack([GX.ravel(), GY.ravel()], axis=1)
    inside = _points_in_polygon(grid, outer)
    for h in holes:
        inside &= ~_points_in_polygon(grid, h)
    clear = _dist_to_segments(grid, outer) > 0.45 * maxh
    for h in holes:
        clear &= _dist_to_segments(grid, h) > 0.45 * maxh
    pts = np.concatenate([all_b, grid[inside & clear]])
    n_fixed = len(all_b)

    def triangulate(p):
        els = Delaunay(p).simplices
        cent = p[els].mean(axis=1)
        keep = _points_in_polygon(cent, outer)
        for h in holes:
            keep &= ~_points_in_polygon(cent, h)
        els = els[keep]
        v = p[els]
        area2 = np.abs(
            (v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
            - (v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1])
        )
        return els[area2 > 1e-10 * maxh * maxh]

    fixed = np.zeros(len(pts), bool)
    fixed[:n_fixed] = True
    els = triangulate(pts)
    for _ in range(smooth_rounds):
        nbr_sum = np.zeros_like(pts)
        nbr_cnt = np.zeros(len(pts))
        for a, b in ((0, 1), (1, 2), (2, 0)):
            np.add.at(nbr_sum, els[:, a], pts[els[:, b]])
            np.add.at(nbr_cnt, els[:, a], 1.0)
            np.add.at(nbr_sum, els[:, b], pts[els[:, a]])
            np.add.at(nbr_cnt, els[:, b], 1.0)
        new = nbr_sum / np.maximum(nbr_cnt, 1.0)[:, None]
        cand = np.where(fixed[:, None], pts, new)
        ok = _points_in_polygon(cand, outer)
        for h in holes:
            ok &= ~_points_in_polygon(cand, h)
        pts = np.where((fixed | ~ok)[:, None], pts, cand)
        els = triangulate(pts)

    used = np.unique(els)
    remap = -np.ones(len(pts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    mesh = Mesh(pts[used], remap[els].astype(np.int32))
    mesh.ensure_positive_orientation()

    tol = 1e-7 * (1.0 + np.abs(hi - lo).max())

    def seg_predicate(poly, i):
        a, b = poly[i], poly[(i + 1) % len(poly)]

        def pred(p):
            # p: (nbf, 2, 2) facet vertex coords; near-segment test
            q = p.reshape(-1, 2)
            ab = b - a
            ab2 = max(float(ab @ ab), 1e-300)
            t = np.clip(((q - a) @ ab) / ab2, 0.0, 1.0)
            d = np.linalg.norm(q - (a + t[:, None] * ab), axis=1)
            return (d < tol).reshape(p.shape[:2])

        return pred

    # group outer edges by name so repeated names merge into one tag
    by_name: dict[str, list[int]] = {}
    for i, nm in enumerate(names):
        by_name.setdefault(nm, []).append(i)
    for nm, idxs in by_name.items():
        preds = [seg_predicate(outer, i) for i in idxs]
        mesh.tag_boundary_by_predicate(
            nm, lambda p, preds=preds: np.any([pr(p) for pr in preds],
                                              axis=0)
        )
    for h, nm in zip(holes, hole_names):
        preds = [seg_predicate(h, i) for i in range(len(h))]
        mesh.tag_boundary_by_predicate(
            nm, lambda p, preds=preds: np.any([pr(p) for pr in preds],
                                              axis=0)
        )
    return mesh
