"""Each configuration's byte count against a hand count at maxh 0.6: the
sizes counted here straight from the mesh's element table, the applies of
one unit written out again."""

import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import harness
from perfbench.reference.mesh.generators import channel_with_cylinder_mesh_3d

REPO = Path(__file__).resolve().parents[2]
MAXH = 0.6


def _config(name):
    spec = json.loads((REPO / f"perfbench/configs/{name}.json").read_text())
    spec["maxh"] = MAXH
    mod = harness.load_module(REPO / f"perfbench/configs/{name}.py",
                              "t_" + name.replace("-", "_").replace(".", "_"))
    return spec, mod


@pytest.fixture(scope="module")
def mesh():
    m = channel_with_cylinder_mesh_3d(MAXH)
    el = np.sort(m.elements, axis=1)
    tri = np.concatenate([el[:, [1, 2, 3]], el[:, [0, 2, 3]],
                          el[:, [0, 1, 3]], el[:, [0, 1, 2]]])
    faces, count = np.unique(tri, axis=0, return_counts=True)
    return m, faces, count


def test_mesh_counts(mesh):
    m, faces, count = mesh
    assert (m.ne, m.nv, len(faces)) == (3384, 888, len(m.faces))
    assert set(count) == {1, 2}


def test_mcs_step_bytes(mesh):
    m, faces, _ = mesh
    spec, mod = _config("mcs3d-cyl-h0.09")
    sz = mod.sizes(spec)
    ne, nf, nv = m.ne, len(faces), m.nv
    # BDM_2: 6 normal moments per face, 6 interior per tet; the order-1
    # tangential facet space: 3 modes x 2 tangents per face
    n = 6 * nf + 6 * ne + 6 * nf
    nb, nbv, mq = 4 * 6 + 6 + 4 * 6, 30, 4
    # the collapsed Gauss rules: degree 6 on the tet, (6 + 4) // 2 = 5
    # points per direction; degree 6 on the face triangles, (6 + 3) // 2 = 4
    nq, nq2 = 5 ** 3, 4 ** 2
    outlet = np.zeros(nv, bool)
    outlet[np.unique(m.faces[m.boundary_tags["outlet"]])] = True
    coarse = nv - outlet.sum()
    assert sz == {"ne": ne, "nfacet": nf, "nv": nv, "n": n, "nq": 4 * ne,
                  "nb": nb, "nbv": nbv, "mq": mq, "coarse_free": coarse,
                  "vol_points": nq, "face_points": nq2}
    k_m, k_p = 31, 26
    per_elem = ne * nb * nb + 2 * n
    hand = 4 * (
        (k_m + 1) * per_elem                       # A
        + (k_m + 15 * (k_p + 1)) * per_elem        # M, Chebyshev degree 16
        + 2 * (k_p + 1) * (ne * mq * nb + n + 4 * ne)   # B and B^T
        + (k_p + 1) * (ne * 16 + 8 * ne)           # element Schur inverses
        + (k_p + 1) * (coarse ** 2 + 2 * nv)       # dense P1 coarse
        + (ne * nq * 3 * nbv + ne * nbv * nq * 9   # convection
           + 2 * nf * nq2 * 3 * nbv + 2 * n))
    got = mod.table_bytes(spec, "simple_step",
                          {"mstar": k_m, "project": k_p}, sz)
    assert got == hand
    assert mod.table_bytes(spec, "stokes_solve", {"its": 100}, sz) is None


def test_hdg_solve_bytes(mesh):
    m, faces, _ = mesh
    spec, mod = _config("hdg3d-cyl-h0.09")
    sz = mod.sizes(spec)
    ne, nf, nv = m.ne, len(faces), m.nv
    # BDM_2 (6 per face, 6 per tet) and the order-2 facet space (6 modes x
    # 2 tangents per face)
    n = 6 * nf + 6 * ne + 12 * nf
    nb = 4 * 6 + 6 + 4 * 12
    dirichlet = set()
    for name in ("inlet", "wall", "cyl"):
        dirichlet |= {tuple(f) for f in m.faces[m.boundary_tags[name]]}
    # a vertex star: the free face dofs (18 per face off the Dirichlet
    # boundary) of the faces at the vertex, the 6 interior dofs of each
    # tet at it
    width = np.zeros(nv, np.int64)
    for f in m.faces:
        if tuple(f) not in dirichlet:
            width[f] += 18
    np.add.at(width, m.elements.ravel(), 6)
    width = width[width > 0]
    on_dir = np.zeros(nv, bool)
    on_dir[np.unique(np.array(sorted(dirichlet)))] = True
    coarse = nv - on_dir.sum()
    assert sz == {"ne": ne, "nv": nv, "n": n, "nq": 4 * ne, "nb": nb,
                  "mq": 4, "star_entries": int((width ** 2).sum()),
                  "star_dofs": int(width.sum()), "stars": len(width),
                  "coarse_free": coarse}
    k = 548
    hand = 8 * (
        (k + 46) * (ne * nb * nb + 2 * n)
        + (k + 45) * (int((width ** 2).sum()) + 2 * int(width.sum())
                      + coarse ** 2 + 6 * nv)
        + (2 * k + 8) * (ne * 4 * nb + n + 4 * ne))
    assert mod.table_bytes(spec, "stokes_solve", {"its": k}, sz) == hand
