from .lanczos import lanczos_eigenvalues

__all__ = ["lanczos_eigenvalues"]
