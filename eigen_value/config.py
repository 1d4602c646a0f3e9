"""Solver configuration.

The reference keeps its two knobs as compile-time constants
(``EPS = 1e-3``, ``MAX_ITR = 1000`` — reference
``include/similarity_transform.hpp:4-5``) plus runtime args ``dim`` and
``wg_size``.  Here the same knobs live in a small frozen dataclass whose
defaults replicate the reference exactly.  There is no ``wg_size``
analog: XLA picks the launch shape of the dense product itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax.numpy as jnp

#: Convergence tolerance — reference include/similarity_transform.hpp:4.
EPS: float = 1e-3
#: Iteration cap — reference include/similarity_transform.hpp:5.
MAX_ITR: int = 1000


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """All knobs of the similarity-transform solver.

    CONSISTENCY CONTRACT: every public entry point (max_eigenvalue —
    single-device and mesh — max_eigenvalue_batch, max_eigenvalue_operator,
    EigenValue) either HONORS a knob or REJECTS it with a ValueError;
    non-default knobs are never silently dropped (api.py).  The low-level
    solvers (``parallel/``, ``ops/``) take the knobs they consume as
    explicit arguments instead — routing is the entry points' job.

    Attributes:
      eps: convergence tolerance on adjacent row-sum differences
        (wraparound neighborhood — reference similarity_transform.cpp:385-417).
      max_itr: iteration cap (reference include/similarity_transform.hpp:5).
      dtype: compute dtype. The reference device path is float32 throughout
        (include/similarity_transform.hpp:8-9); its sequential oracle is
        float64 (main.py NumPy default).
      backend: "auto" | "xla" | "matvec" | "multiround":
          * "xla": the reference's own structure — each round rewrites A
            with the similarity update and sums its rows (1 read + 1
            write of A per round once XLA fuses the two).
          * "matvec": power form — one product against the ORIGINAL A per
            round (1 read, no writes; see solver_matvec.py).
          * "multiround": the matvec form with the loop's continue
            decision taken on the host once per ``chunk`` rounds instead
            of every round (solver_matvec.solve_multiround).
        "auto" resolves to "matvec" at every n.
      interpret: run the Pallas kernel (only ``symmetric=True`` runs one)
        through the Pallas interpreter.  None = compile it, which needs a
        GPU; asking for a kernel on another platform without
        ``interpret=True`` is an error, never a silent fallback.
    """

    eps: float = EPS
    max_itr: int = MAX_ITR
    #: Stop-tolerance semantics: "absolute" (reference-exact — its EPS is a
    #: raw threshold, similarity_transform.hpp:4) or "relative" (opt-in:
    #: tol = eps·max|v|, scale-invariant).  Absolute mode is silently
    #: unsound for operators with large λ: f32 row-sum rounding noise
    #: ~λ·n·2⁻²⁴ can exceed eps=1e-3 so the check never fires (see
    #: ops.solver.stop_check).  Relative mode changes round counts, so the
    #: parity tables only apply to the default.
    eps_mode: str = "absolute"
    dtype: Any = jnp.float32
    backend: str = "auto"
    interpret: Optional[bool] = None
    #: Optional reduced-precision MATRIX storage (e.g. jnp.bfloat16): halves
    #: the bytes read per round on the matvec path; O(n) state stays
    #: float32.  Accuracy loosens to ~2e-3 (solver_matvec.solve_matvec_storage).
    storage_dtype: Optional[Any] = None
    #: Rounds per host check for backend="multiround" (None = 18, the
    #: flagship family's 17 rounds + 1).  Size it to the workload's
    #: expected round count + 1: rounds after convergence inside a chunk
    #: are frozen but their products still run.  Semantics never change —
    #: the stop is checked every round regardless (solve_multiround).
    chunk: Optional[int] = None
    #: DECLARES the matrix symmetric (the caller's promise, like a BLAS
    #: ``symv`` — nothing is checked unless the entry point's ``validate``
    #: flag is set; a lie gives a wrong answer).  Implemented by the
    #: upper-triangle kernel (ops/pallas/kernels.symv), which reads ≈ half
    #: of A per round.  Explicit "matvec"/"multiround" backends honor it;
    #: under "auto" the kernel is taken where it wins (f32 storage on a
    #: GPU) and the dense product keeps the job elsewhere (declaring
    #: symmetry never changes results, only traffic); "xla" rejects it.
    symmetric: bool = False

    def __post_init__(self) -> None:
        if self.backend not in ("auto", "xla", "matvec", "multiround"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.chunk is not None and self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if self.max_itr < 0:
            raise ValueError("max_itr must be >= 0")
        if self.eps <= 0:
            raise ValueError("eps must be > 0")
        if self.eps_mode not in ("absolute", "relative"):
            raise ValueError(
                f"eps_mode must be 'absolute' or 'relative', got {self.eps_mode!r}"
            )
        if jnp.dtype(self.dtype) == jnp.dtype("float64"):
            import jax

            if not jax.config.jax_enable_x64:
                raise ValueError(
                    "dtype=float64 needs x64 mode (jax.config.update"
                    "('jax_enable_x64', True)); without it JAX silently "
                    "downcasts to float32"
                )


DEFAULT_CONFIG = SolverConfig()
