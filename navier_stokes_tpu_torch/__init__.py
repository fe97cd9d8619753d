"""PyTorch + CUDA port of ``navier_stokes_tpu`` for NVIDIA Hopper.

Same layout as the JAX package (mesh/, fem/, linalg/, ops/, models/,
precond/, solvers/); the hot block matvecs are hand-written CUDA kernels
(``csrc/block_mv.cu`` bound in ``ops/block_mv.py``, ``csrc/local_mv.cu``
bound in ``ops/local_mv.py``).  ``flagship.py`` drives the initial Stokes
solve of the 3D MCS channel to a true f64 relative residual of 1e-8 and the
transient SIMPLE steps of ``models.NavierStokesMCS``.  Entry points run on
CUDA unless the caller passes ``device="cpu"``.
"""
