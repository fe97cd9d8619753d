"""The JAX package's ``scripts/`` that the port carries, run as modules:
``python -m navier_stokes_tpu_torch.scripts.<name>``."""
