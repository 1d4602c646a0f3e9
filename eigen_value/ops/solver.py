"""Single-chip similarity-transform solver: `jit` + `lax.while_loop`.

This is the on-device re-expression of the reference's host-side
convergence loop (``similarity_transform.cpp:5-75``).  The reference submits
6 kernels per round and blocks on a device→host read of the stop flag every
round (``similarity_transform.cpp:45-50``); here the whole iteration is one
XLA while loop carrying ``(A, v, ev, λ, i, done)`` — zero host round-trips.

Round structure (must match the reference ordering exactly for round-count
parity, SURVEY.md §0):

  round i: [v given]  →  m = max(v)          (find_max, cpp:154-227)
                      →  ev *= v / m          (compute_eigen_vector, cpp:229-265)
                      →  done = stop(v)       (wraparound check, cpp:332-460)
                      →  if done: λ = v[0]; exit with rounds = i
                      →  else A *= outer(1/v, v); v = rowsum(A)
                         (compute_next_matrix cpp:286-330 fused with the NEXT
                          round's sum_across_rows cpp:77-152 — both touch all
                          of A, so fusing halves HBM traffic per round)

The initial ``v = rowsum(A)`` runs once before the loop.  The O(n) ops
(max/ev/stop) are plain jnp — XLA fuses them into negligible work; the two
O(n²) passes are pluggable (``rowsum``, ``scale_rowsum``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax


class SolveResult(NamedTuple):
    """Result pytree of one dense solve.

    ``eigenvalue`` is v[0] at the round where convergence was detected
    (reference reads the first element of the sum vector,
    similarity_transform.cpp:60-65).  ``rounds`` uses the reference's
    parallel convention: 0-based index of the converging round
    (similarity_transform.cpp:39-54); ``rounds == max_itr`` with
    ``converged == False`` means the cap was hit.
    """

    eigenvalue: jax.Array
    eigenvector: jax.Array
    rounds: jax.Array
    converged: jax.Array


RowsumFn = Callable[[jax.Array], jax.Array]
ScaleRowsumFn = Callable[[jax.Array, jax.Array], Tuple[jax.Array, jax.Array]]


def rowsum_xla(A: jax.Array) -> jax.Array:
    """Row sums of A — jnp expression of sum_across_rows (cpp:77-152)."""
    return jnp.sum(A, axis=1)


def scale_rowsum_xla(A: jax.Array, v: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Fused similarity update + next row sums, pure-jnp form.

    ``A'[r][c] = A[r][c] * (1/v[r]) * v[c]`` — same reciprocal-then-multiply
    arithmetic as the reference kernel (similarity_transform.cpp:324-325) —
    followed by the next round's row sums.  XLA output-fuses the reduction
    with the producer, so this is ~1 read + 1 write of A.
    """
    one = jnp.asarray(1.0, A.dtype)
    A = A * ((one / v)[:, None] * v[None, :])
    return A, jnp.sum(A, axis=1)


def stop_check(v: jax.Array, eps: float, eps_mode: str = "absolute") -> jax.Array:
    """Wraparound stop criterion: all |v[i] - v[(i+1) % n]| < tol.

    Matches the reference's parallel `stop` kernel exactly — including the
    wraparound pair, which its subgroup-shuffle + boundary-read implements
    (similarity_transform.cpp:385-417).  Expressed as fused slices rather
    than ``jnp.roll`` (roll can materialize a rotated copy; the slices
    fuse into the reduction).

    ``eps_mode`` picks the tolerance semantics:

    * ``"absolute"`` (default, reference-exact): ``tol = eps`` — the
      reference's EPS is absolute (similarity_transform.hpp:4).  SCALE
      LIMIT: the row sums converge to λ, whose float32 representation
      carries rounding noise ~λ·n·2⁻²⁴ per matvec — once λ ≳ 10³ at
      n ~ 10³⁺ that noise approaches eps=1e-3 and the check may NEVER
      fire (the round-2 silicon failure mode of the Kronecker operator,
      whose λ = λ_B·λ_C reaches 10²–10³).
    * ``"relative"`` (opt-in): ``tol = eps · max|v|`` — scale-invariant;
      sound for any λ.  Not the reference's semantics, so round counts
      are NOT comparable to the parity tables.
    """
    e = jnp.asarray(eps, v.dtype)
    if eps_mode == "relative":
        e = e * jnp.max(jnp.abs(v))
    elif eps_mode != "absolute":
        raise ValueError(f"eps_mode must be 'absolute' or 'relative', got {eps_mode!r}")
    adjacent_ok = jnp.all(jnp.abs(v[1:] - v[:-1]) < e)
    wrap_ok = jnp.abs(v[-1] - v[0]) < e
    return adjacent_ok & wrap_ok


class _Carry(NamedTuple):
    A: jax.Array
    v: jax.Array
    ev: jax.Array
    lam: jax.Array  # λ snapshot (v[0]) of the last round advanced past
    i: jax.Array


def solve_loop(
    A: jax.Array,
    *,
    rowsum: RowsumFn,
    scale_rowsum: ScaleRowsumFn,
    eps: float,
    max_itr: int,
    ev0: jax.Array | None = None,
    eps_mode: str = "absolute",
) -> SolveResult:
    """Run the convergence loop with pluggable O(n²) passes (traced; jit me).

    Round-2 loop structure (see ops/solver_matvec.py for the full
    semantics argument): the stop check lives in the while COND, so the
    converging round's O(n²) update is skipped by loop EXIT — exactly the
    reference's break-before-update (similarity_transform.cpp:45-52) —
    with no `lax.cond` branch or `where` bookkeeping in the body.  The
    converging round's ev update runs after the loop; on cap-exhaustion
    the reported λ is the last CHECKED round's v[0] (the ``lam`` carry).
    The v-sequence is bit-identical to the round-1 structure.

    ``ev0`` overrides the all-ones start vector (the iteration is
    scale-invariant in ev — the accumulated products cancel in the
    normalized eigenvector; λ and round counts are read from v, which
    ev never feeds).  Used by bench chains to thread inter-solve data
    dependence at O(n) cost.
    """
    n = A.shape[0]
    dtype = A.dtype
    v0 = rowsum(A)
    if ev0 is None:
        ev0 = jnp.ones((n,), dtype)  # initialise_eigen_vector, cpp:267-284

    def cond(c: _Carry) -> jax.Array:
        return (c.i < max_itr) & jnp.logical_not(stop_check(c.v, eps, eps_mode))

    def body(c: _Carry) -> _Carry:
        v = c.v
        m = jnp.max(v)
        ev = c.ev * (v / m)
        lam = v[0]
        A, v = scale_rowsum(c.A, v)
        return _Carry(A, v, ev, lam, c.i + 1)

    init = _Carry(A, v0, ev0, jnp.asarray(0.0, dtype), jnp.asarray(0, jnp.int32))
    out = lax.while_loop(cond, body, init)
    converged = out.i < max_itr
    ev = jnp.where(converged, out.ev * (out.v / jnp.max(out.v)), out.ev)
    lam = jnp.where(converged, out.v[0], out.lam)
    return SolveResult(lam, ev, out.i, converged)


@partial(jax.jit, static_argnames=("eps", "max_itr", "eps_mode"))
def solve_xla(
    A: jax.Array,
    eps: float,
    max_itr: int,
    ev0: jax.Array | None = None,
    eps_mode: str = "absolute",
) -> SolveResult:
    """Pure-XLA solver (no Pallas): the minimum end-to-end slice."""
    return solve_loop(
        A,
        rowsum=rowsum_xla,
        scale_rowsum=scale_rowsum_xla,
        eps=eps,
        max_itr=max_itr,
        ev0=ev0,
        eps_mode=eps_mode,
    )
