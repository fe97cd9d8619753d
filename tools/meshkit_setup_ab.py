"""Does the C++ meshkit move the host setup?  Times the port's
``precond.jacobi.extract_blocks_from_local`` (the CSR sub-block
extraction, ``utils/native.extract_blocks_csr``) through the C++ kernel and
through its numpy fallback, inside two real setups, and the whole setup
around it:

  hdg2d   the 2D HDG Stokes system of run.py at maxh 0.01 (BDM 2, the
          curved cylinder, its edge-block preconditioner: 42,260 blocks;
          ``build_hybrid_stokes_system``)
  mcs3d   the face blocks of the 3D MCS model's Gauss-Seidel preconditioner
          (``free_blocks(Xv, "face")`` on A_cond) on the straight channel at
          ``--maxh``

Per case and route: seconds inside the extraction (each call), seconds of
the whole setup, and whether both routes give the same blocks.

    python3 tools/meshkit_setup_ab.py [--cases hdg2d,mcs3d] [--maxh 0.35]
        [--device cuda]
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _routes():
    """(name, context) for the C++ kernel and the numpy fallback."""
    from navier_stokes_tpu_torch.utils import native

    class Route:
        def __init__(self, name, off):
            self.name, self.off = name, off

        def __enter__(self):
            self.keep = native._lib
            if self.off:
                native._lib = lambda: None
            return self

        def __exit__(self, *exc):
            native._lib = self.keep
            return False

    return [Route("C++", False), Route("numpy", True)]


def _timed_extraction():
    """Wrap extract_blocks_from_local in the modules that call it; returns
    the list that receives (seconds, blocks) per call, and an undo."""
    import importlib

    from navier_stokes_tpu_torch.precond import jacobi

    calls = []
    own = jacobi.extract_blocks_from_local

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = own(*a, **k)
        calls.append((time.perf_counter() - t0, out[1]))
        return out

    mods = [importlib.import_module(f"navier_stokes_tpu_torch.{m}")
            for m in ("precond.jacobi", "models.stokes_hybrid",
                      "models.navier_stokes_mcs", "precond.twolevel",
                      "models.stokes_hybrid3d")]
    for m in mods:
        m.extract_blocks_from_local = timed

    def undo():
        for m in mods:
            m.extract_blocks_from_local = own

    return calls, undo


def hdg2d(device):
    import torch

    from navier_stokes_tpu_torch.mesh.curved import curve_to_circle
    from navier_stokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_mesh,
    )
    from navier_stokes_tpu_torch.models import discretizations as disc
    from navier_stokes_tpu_torch.models import stokes as st
    from navier_stokes_tpu_torch.models.stokes_hybrid import (
        build_hybrid_stokes_system,
    )

    mesh = channel_with_cylinder_mesh(0.01)

    def setup():
        geo = curve_to_circle(mesh, "cyl", (0.2, 0.2), 0.05, 3)
        system = build_hybrid_stokes_system(
            mesh, disc.bdm_hybrid(2, 10)[0], uin=st.default_inlet_profile(),
            geometry=geo, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return system

    return setup


def mcs3d(device, maxh):
    from navier_stokes_tpu_torch.flagship import build_model
    from navier_stokes_tpu_torch.models.stokes_hybrid3d import free_blocks
    from navier_stokes_tpu_torch.precond import jacobi

    m = build_model(maxh, curved=False, device=device)
    blks = free_blocks(m.Xv, "face")

    def setup():
        return jacobi.extract_blocks_from_local(
            m.A_cond_np, m.Xv.element_dofs, blks, m.n)

    return setup


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="hdg2d,mcs3d")
    ap.add_argument("--maxh", type=float, default=0.35)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from navier_stokes_tpu_torch.utils import native

    print(f"meshkit C++ available: {native.available()}", flush=True)
    for case in args.cases.split(","):
        setup = (hdg2d(args.device) if case == "hdg2d"
                 else mcs3d(args.device, args.maxh))
        blocks = {}
        for route in _routes() + _routes():  # C++, numpy, C++, numpy
            calls, undo = _timed_extraction()
            try:
                with route:
                    t0 = time.perf_counter()
                    setup()
                    secs = time.perf_counter() - t0
            finally:
                undo()
            blocks.setdefault(route.name, [c[1] for c in calls])
            print(f"{case} {route.name}: setup {secs:.3f} s, extraction "
                  + ", ".join(f"{c[0]:.3f}" for c in calls) + " s ("
                  + ", ".join(str(tuple(c[1].shape)) for c in calls) + ")",
                  flush=True)
        same = all(np.array_equal(a, b) for a, b in
                   zip(blocks["C++"], blocks["numpy"]))
        print(f"{case}: C++ and numpy blocks {'equal' if same else 'DIFFER'}",
              flush=True)


if __name__ == "__main__":
    main()
