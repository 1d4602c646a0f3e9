"""eigen_value — maximum-eigenvalue framework in JAX.

A brand-new JAX/XLA/Pallas implementation of the similarity-transform method
for the maximum eigenvalue and eigenvector of positive square matrices, with
the full capability surface of the reference SYCL library
(itzmeanjan/eigen_value): kernel pipeline, convergence semantics,
verification fixtures, benchmark harness, Python API — re-designed for an
accelerator (on-device `lax.while_loop`, an upper-triangle Pallas kernel for
symmetric inputs, mesh sharding across cards, vmapped batched solves).
"""

from . import checkpoint, fixtures
from .api import (
    EigenValue,
    eigen_residual,
    max_eigenvalue,
    max_eigenvalue_batch,
    max_eigenvalue_operator,
)
from .config import DEFAULT_CONFIG, EPS, MAX_ITR, SolverConfig
from .ops.solver import SolveResult

__version__ = "0.1.0"

__all__ = [
    "EigenValue",
    "eigen_residual",
    "checkpoint",
    "fixtures",
    "max_eigenvalue",
    "max_eigenvalue_batch",
    "max_eigenvalue_operator",
    "SolverConfig",
    "SolveResult",
    "DEFAULT_CONFIG",
    "EPS",
    "MAX_ITR",
]
