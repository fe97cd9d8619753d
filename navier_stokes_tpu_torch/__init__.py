"""PyTorch + CUDA port of ``navier_stokes_tpu`` for NVIDIA Hopper.

Same layout as the JAX package (mesh/, fem/, linalg/, ops/, models/,
precond/, solvers/); the hot block matvecs are hand-written CUDA kernels
(``csrc/block_mv.cu`` bound in ``ops/block_mv.py``, ``csrc/local_mv.cu``
bound in ``ops/local_mv.py``).  ``flagship.py`` drives the initial Stokes
solve of the 3D MCS channel to a true f64 relative residual of 1e-8 and the
transient SIMPLE steps of ``models.NavierStokesMCS``, whose own initial
solve (``SolveInitial``) is the JAX model's Bramble-Pasciak CG
(``solvers/bpcg.py``); ``python -m navier_stokes_tpu_torch.bench`` prints
bench.py's JSON line for the port.  ``models.NavierStokesHDG3D`` is the 3D
interior-penalty H(div) model, ``solvers/refinement.py`` holds the
mixed-precision refinement drivers, and ``scripts/navier_stokes_3d.py`` the
3D demo.  ``models.NavierStokesMCS`` also takes a triangle mesh (the 2D
MCS model), ``models.NavierStokes`` is the Taylor-Hood model in 2D and 3D,
and ``scripts/navier_stokes_2d.py`` / ``navier_stokes_cavity.py`` the 2D
demos.  Every scatter-add is deterministic (``ops.assembly.ScatterPlan``).
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
