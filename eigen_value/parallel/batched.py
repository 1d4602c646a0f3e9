"""Batched solves: `vmap` of the solver, optionally sharded over a mesh.

The reference's Python test loops over independent random matrices
(wrapper/python/test.py:13); this build generalizes that to a first-class
batched mode (BASELINE.json config 4: 256 independent 512² matrices across
a device mesh).

Per-matrix convergence differs, so the loop must run until ALL matrices in
the (local) batch converge while freezing finished ones — JAX's while_loop
batching rule does exactly this: the predicate becomes "any still running"
and each instance's carry is select-frozen once its own predicate is false,
preserving per-matrix round counts (SURVEY.md §7 step 6).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_CONFIG, SolverConfig
from ..ops.solver import SolveResult
from ..ops.solver_matvec import solve_matvec
from .sharded import require_axis


@partial(jax.jit, static_argnames=("eps", "max_itr", "storage_dtype", "eps_mode"))
def solve_batched(
    As: jax.Array,
    eps: float,
    max_itr: int,
    storage_dtype=None,
    ev0=None,
    eps_mode: str = "absolute",
) -> SolveResult:
    """Solve a batch of positive matrices ``As`` of shape (B, n, n).

    Returns a SolveResult whose leaves carry a leading batch axis; ``rounds``
    is per-matrix (frozen at each matrix's own convergence round).  Uses the
    matvec-form solver — under vmap the hot op becomes a batched gemv
    against the original matrices, still 1 read of each A per round.

    ``storage_dtype`` (e.g. ``jnp.bfloat16``) enables the reduced-precision
    fast mode per matrix (see solver_matvec.solve_matvec_storage).

    ``eps_mode`` applies per matrix with the single-chip semantics
    (ops/solver.stop_check): ``"relative"`` is the sound stop for
    large-λ batches — e.g. random-positive matrices at large n, whose
    λ ≈ n/2 crowds the absolute eps once λ ≳ 10³.

    ``ev0`` (shape (n,), shared by every matrix) overrides the all-ones
    start vector — scale-invariant (solver_matvec.py); the bench harness
    threads inter-solve dependence through it.
    """
    if As.ndim != 3 or As.shape[1] != As.shape[2]:
        raise ValueError(f"expected (B, n, n), got {As.shape}")
    if storage_dtype is not None:
        from ..ops.solver_matvec import solve_matvec_storage

        return jax.vmap(
            lambda A: solve_matvec_storage(
                A, eps, max_itr, storage_dtype, ev0=ev0, eps_mode=eps_mode
            )
        )(As)
    return jax.vmap(
        lambda A: solve_matvec(A, eps, max_itr, ev0=ev0, eps_mode=eps_mode)
    )(As)


def solve_batched_sharded(
    As: jax.Array,
    mesh: Mesh,
    axis_name: str = "batch",
    config: SolverConfig = DEFAULT_CONFIG,
) -> SolveResult:
    """Batched solve with the batch axis sharded across ``mesh`` (DP-like).

    Each device runs the masked vmapped loop on its local slice; the solves
    are independent, so the per-round compute is embarrassingly parallel.
    One caveat on stragglers: under jit+GSPMD the batched while-loop's
    predicate is a GLOBAL any-not-converged reduce, so every device iterates
    until the slowest matrix anywhere converges (finished matrices are
    frozen by the mask, costing bandwidth but not correctness).  Wall time
    therefore scales with max-rounds over the whole batch, not per-shard
    max — plan capacity accordingly.
    """
    B = As.shape[0]
    n_shards = require_axis(mesh, axis_name)
    if B % n_shards != 0:
        raise ValueError(f"batch {B} not divisible by {n_shards} shards")
    As = jax.device_put(As, NamedSharding(mesh, P(axis_name, None, None)))
    out_sharding = SolveResult(
        NamedSharding(mesh, P(axis_name)),
        NamedSharding(mesh, P(axis_name, None)),
        NamedSharding(mesh, P(axis_name)),
        NamedSharding(mesh, P(axis_name)),
    )
    return _batched_sharded_jit(
        config.eps,
        config.max_itr,
        config.storage_dtype,
        out_sharding,
        config.eps_mode,
    )(As)


@lru_cache(maxsize=None)
def _batched_sharded_jit(
    eps: float,
    max_itr: int,
    storage_dtype,
    out_sharding: SolveResult,
    eps_mode: str = "absolute",
):
    """Cache the jitted executable per config+sharding — a fresh jax.jit
    wrapper per call would re-trace on every invocation."""
    return jax.jit(
        partial(
            solve_batched,
            eps=eps,
            max_itr=max_itr,
            storage_dtype=storage_dtype,
            eps_mode=eps_mode,
        ),
        out_shardings=out_sharding,
    )
