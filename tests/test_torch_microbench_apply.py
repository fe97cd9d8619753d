"""The port's ``microbench_apply`` and ``microbench_apply3`` scripts on the
CPU, against the JAX scripts' lines.

Both ``main``s run at maxh 0.6 (3,384 x 54 x 54 element blocks) with
``device="cpu"``: the kernel wrappers take their plain versions and no
time is taken.  The JAX scripts' line labels are read from their
``print`` calls (``scripts/microbench_apply.py``, ``microbench_apply3.py``);
the port's rows must carry them in the same order (``microbench_apply``:
under each of JAX's two matmul precisions, with the port's extra kernel-1
face-block line after JAX's face-block line), every deviation within its
stated bound (``DEV_TOL`` 1e-5 relative l2; the library einsum under TF32
``TF32_TOL`` 1e-2) and finite, and every timing None.  A control: the
face-block apply on a table with one block perturbed must deviate beyond
``DEV_TOL`` from the gather apply, so the deviation check sees a wrong
table.
"""

import os
import re

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu_torch.fem.hdiv3d import HDiv3D
from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu_torch.models.stokes_hybrid3d import (
    HybridVelocitySpace3D,
    VectorFacet3D,
)
from navier_stokes_tpu_torch.ops import assembly as asm
from navier_stokes_tpu_torch.ops.faceblock import FaceBlockLayout
from navier_stokes_tpu_torch.scripts import microbench_apply as mb1
from navier_stokes_tpu_torch.scripts import microbench_apply2 as mb2
from navier_stokes_tpu_torch.scripts import microbench_apply3 as mb3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAXH = 0.6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def jax_labels(script):
    """The labels of the JAX script's result lines, in its order."""
    with open(os.path.join(ROOT, "scripts", script)) as fh:
        return re.findall(r'print\(\s*f"\s*([A-Za-z][^:"{=]*):\s', fh.read())


def test_microbench_apply_lines():
    labels = jax_labels("microbench_apply.py")
    assert labels == ["gather-einsum-scatter", "face-block apply",
                      "einsum only"]
    rows = mb1.main(MAXH, device="cpu")
    assert [r["precision"] for r in rows] == ["default"] * 4 + ["highest"] * 4
    for prec in ("default", "highest"):
        mine = [r["label"] for r in rows if r["precision"] == prec]
        assert [lb for lb in mine if lb in labels] == labels
        assert mine == ["gather-einsum-scatter", "face-block apply",
                        "face-block apply (block_mv)", "einsum only"]
    for r in rows:
        assert r["ms"] is None and r["graph_ms"] is None
        if r["label"] == "gather-einsum-scatter":
            assert r["dev"] is None
            continue
        assert np.isfinite(r["dev"]) and r["dev"] <= r["bound"]
        assert r["bound"] == (mb1.TF32_TOL if (r["label"] == "einsum only"
                                               and r["precision"] ==
                                               "default")
                              else mb1.DEV_TOL)
    assert mb1.DEV_TOL == 1e-5 and mb1.TF32_TOL == 1e-2


def test_microbench_apply3_lines():
    labels = jax_labels("microbench_apply3.py")
    assert len(labels) == 6
    rows = mb3.main(MAXH, device="cpu")
    assert [r["label"] for r in rows] == labels
    assert [r["kernel"] for r in rows] == ["library", "block_mv", "library",
                                           "block_mv", "library",
                                           "block_mv2"]
    for r in rows:
        assert r["ms"] is None and r["graph_ms"] is None and r["gbps"] is None
        if r["kernel"] == "library":
            assert r["dev"] is None
        else:
            assert np.isfinite(r["dev"]) and r["dev"] <= mb2.DEV_TOL
    assert mb2.DEV_TOL == 1e-5


def test_face_apply_deviation_sees_a_wrong_table():
    """The check the scripts make, on a table the face apply reads wrong:
    one element's block scaled by 2 in the face-major copy only."""
    mesh = channel_with_cylinder_mesh_3d(MAXH)
    Xv = HybridVelocitySpace3D(HDiv3D(mesh, 2), VectorFacet3D(mesh, 1))
    lay = FaceBlockLayout(Xv, "cpu")
    rng = np.random.default_rng(0)
    A = rng.standard_normal((mesh.ne, lay.nb, lay.nb)).astype(np.float32)
    u = torch.as_tensor(rng.standard_normal(Xv.ndof).astype(np.float32))
    eldofs = torch.as_tensor(np.asarray(Xv.element_dofs))
    y1 = asm.apply_local_matrices(torch.as_tensor(A), eldofs, Xv.ndof, u,
                                  use_kernel=True)
    A_perm = lay.permute_blocks(A)
    good = lay.elem_apply(torch.as_tensor(A_perm), use_kernel=True)(u)
    assert mb1.rel_dev(good, y1) <= mb1.DEV_TOL
    A_perm[mesh.ne // 2] *= 2.0
    bad = lay.elem_apply(torch.as_tensor(A_perm), use_kernel=True)(u)
    assert mb1.rel_dev(bad, y1) > mb1.DEV_TOL
