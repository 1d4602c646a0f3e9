"""Matvec ("power-form") solver: the algebraic fast path.

The similarity update is a pure diagonal conjugation, so the iterated
matrix never needs to be materialized: with ``A_{k+1} = D_k⁻¹ A_k D_k``
(D_k = diag(v_k)) one shows by induction that

    A_k[r][c] = A_0[r][c] · q_k[c] / q_k[r],     q_{k+1} = q_k ∘ v_k,

and therefore the only quantity the algorithm observes — the row-sum
vector — is

    v_k[r] = (A_0 · q_k)[r] / q_k[r].

Because this ratio is scale-invariant in q, the reference's own
eigenvector accumulator ``ev_k = Π v_i/m_i`` (proportional to q_k) can be
used directly:  **one matvec against the ORIGINAL matrix per round**:

    v_k = (A_0 @ ev_k) / ev_k.

This is the similarity-transform method revealed as (diagonally
renormalized) power iteration.  Per-round HBM traffic drops from the
reference's 3·n²·4B (read for row-sum + read/write for the update,
similarity_transform.cpp:40,52) to 1·n²·4B — 3× less than the reference's
structure — and A is never written, so max-size solves need only one matrix buffer.

Convergence semantics are IDENTICAL to the iterated form (same v_k
sequence in exact arithmetic; float32 rounding differs slightly from the
mutate-A-each-round path, which tests pin to the reference's round counts
— SURVEY.md §7 "hard parts").  ev stays max-normalized every round, so no
overflow for convergent inputs (unnormalized q_k would grow like λ^k).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .solver import SolveResult, stop_check


def dot_f32(A: jax.Array, x: jax.Array) -> jax.Array:
    """``A @ x`` pinned to f32 precision on every backend.

    A GPU may run a float32 product in TF32 (about three decimal digits);
    the resulting row-sum noise (~λ·2⁻¹¹) dwarfs the absolute eps = 1e-3
    stop whenever λ ≳ 1, and the solve silently exhausts MAX_ITR.
    ``Precision.HIGHEST`` keeps full f32 products, which the
    bandwidth-bound matrix-vector product never notices.
    """
    return jnp.dot(A, x, precision=jax.lax.Precision.HIGHEST)


class _Carry(NamedTuple):
    ev: jax.Array
    v: jax.Array
    lam: jax.Array  # λ snapshot (v[0]) of the last round advanced past
    i: jax.Array


def _make_cond_body(matvec, eps: float, max_itr: int, eps_mode: str = "absolute"):
    """The ONE definition of the matvec-form round (shared by the plain
    and λ-traced loops so their semantics can never diverge).

    Round-2 structure: the stop check lives in the while-loop COND, so the
    body is branch-free — no `lax.cond` matvec skip, no `where`
    bookkeeping, no `done` carry.  The converging round's eigenvector update moves to
    :func:`_finish`; the v-sequence — and hence the float32 round count —
    is bit-identical to the round-1 structure (same expressions, same
    order).
    """

    def cond(c: _Carry) -> jax.Array:
        return (c.i < max_itr) & jnp.logical_not(stop_check(c.v, eps, eps_mode))

    def body(c: _Carry) -> _Carry:
        v = c.v
        m = jnp.max(v)
        ev = c.ev * (v / m)
        lam = v[0]
        return _Carry(ev, matvec(ev), lam, c.i + 1)

    return cond, body


def _init_carry(n: int, matvec, dtype, ev0=None) -> _Carry:
    if ev0 is None:
        ev0 = jnp.ones((n,), dtype)
    else:
        # a caller-supplied start vector joins the O(n) state: cast it to
        # the state dtype (review r5c: a mismatched ev0 either crashed
        # the while_loop carry at trace time or silently dropped the
        # stop check to reduced precision)
        ev0 = jnp.asarray(ev0, dtype)
    v0 = matvec(ev0)  # == row sums of A_0
    return _Carry(ev0, v0, jnp.asarray(0.0, dtype), jnp.asarray(0, jnp.int32))


def _finish(out: _Carry, max_itr: int) -> SolveResult:
    """Post-loop epilogue shared by every matvec-form solver.

    Exit cases (reference semantics, similarity_transform.cpp:39-54):
      * converged at round k < max_itr — the loop exited because the stop
        fired on ``out.v``: apply the converging round's ev update, read
        λ = v[0], rounds = k.
      * cap exhaustion (i == max_itr) — rounds v_0..v_{max−1} were checked
        and advanced past; report the last CHECKED round's λ (the ``lam``
        carry), ev as updated through round max_itr−1, converged = False.
        ``out.v`` (= v_max) was computed but never checked — exactly like
        the reference, whose loop exits before round max_itr's stop.
    """
    converged = out.i < max_itr  # early exit ⇔ stop fired on out.v
    m = jnp.max(out.v)
    ev = jnp.where(converged, out.ev * (out.v / m), out.ev)
    lam = jnp.where(converged, out.v[0], out.lam)
    return SolveResult(lam, ev, out.i, converged)


def solve_matvec_loop(
    A: jax.Array,
    matvec,
    eps: float,
    max_itr: int,
    state_dtype=None,
    ev0=None,
    eps_mode: str = "absolute",
) -> SolveResult:
    """Convergence loop over a pluggable ``matvec(ev) -> (A @ ev) / ev``.

    ``state_dtype`` sets the dtype of the O(n) iteration state (ev, v, λ,
    stop check) independently of the matrix storage — reduced-precision
    storage keeps float32 state (bf16 cannot even represent the 1e-3 stop
    tolerance at λ-scale values).

    ``ev0`` overrides the all-ones start vector (the iteration is
    scale-invariant in ev, solver_matvec module docstring) — used by the
    bench harness to thread inter-solve data dependence through one O(n)
    op per SOLVE instead of one per round."""
    cond, body = _make_cond_body(matvec, eps, max_itr, eps_mode)
    if state_dtype is None:
        # reduced-precision A without an explicit state dtype still gets
        # f32 O(n) state (checkpoint._state_dtype's rule): bf16 cannot
        # even represent the 1e-3 stop tolerance at λ-scale values, so a
        # bf16 state would silently mis-count rounds or exhaust the cap
        # (review r5c)
        state_dtype = (
            jnp.float32 if jnp.dtype(A.dtype).itemsize < 4 else A.dtype
        )
    init = _init_carry(A.shape[0], matvec, state_dtype, ev0)
    out = lax.while_loop(cond, body, init)
    return _finish(out, max_itr)


def solve_operator(
    matvec,
    n: int,
    eps: float,
    max_itr: int,
    dtype=jnp.float32,
    ev0: jax.Array | None = None,
    eps_mode: str = "absolute",
) -> SolveResult:
    """MATRIX-FREE solve: ``matvec(x) -> A @ x`` for an implicit positive
    matrix that is never materialized.

    The power-form loop (module docstring) observes A only through one
    matvec per round, so any positive linear operator works: structured
    matrices with fast matvecs (Hankel/Toeplitz via FFT — the Hilbert
    benchmark matrix is Hankel, giving O(n log n) PER-ROUND cost instead
    of O(n²); see ops/structured.py and examples/matrix_free.py),
    sums/products of operators, or matrices too large to materialize at
    all.  The reference requires a
    dense float32 buffer (similarity_transform.hpp:8-9) — this entry has
    no reference analog; it falls out of the functional design.

    Semantics are the standard ones (wraparound stop, λ = v[0], 0-based
    rounds, stop before update).  Round counts may differ ±1 from the
    dense solver when the operator's floating-point matvec differs from
    the dense row-sum reduction order (e.g. FFT).  Traced — wrap in
    ``jax.jit`` (with ``n``/``eps``/``max_itr`` static) for production.
    """

    def next_v(ev):
        return matvec(ev) / ev

    cond, body = _make_cond_body(next_v, eps, max_itr, eps_mode)
    init = _init_carry(n, next_v, dtype, ev0)
    out = lax.while_loop(cond, body, init)
    return _finish(out, max_itr)


@partial(jax.jit, static_argnames=("eps", "max_itr", "eps_mode"))
def solve_matvec(
    A: jax.Array,
    eps: float,
    max_itr: int,
    ev0: jax.Array | None = None,
    eps_mode: str = "absolute",
) -> SolveResult:
    """Single-chip matvec-form solve (works for any n, no tile alignment).

    ``ev0`` overrides the all-ones start vector (scale-invariant in ev;
    see :func:`solve_matvec_loop`)."""

    def matvec(ev):
        return dot_f32(A, ev) / ev

    return solve_matvec_loop(A, matvec, eps, max_itr, ev0=ev0, eps_mode=eps_mode)


@partial(jax.jit, static_argnames=("eps", "max_itr"))
def solve_matvec_traced(A: jax.Array, eps: float, max_itr: int):
    """Matvec-form solve that also records the PER-ROUND λ estimate (v[0]
    at each round's stop check) — convergence observability the reference
    has no analog for (its only per-solve metrics are ms + final rounds,
    SURVEY.md §5).  Returns ``(SolveResult, lam_history)`` where
    ``lam_history`` has shape ``(max_itr,)``; entries past the converging
    round repeat the final λ (the loop exits early — no extra compute).

    The round itself is the SAME ``_make_cond_body`` body as
    :func:`solve_matvec` — only the history write wraps it — so the two
    stay bit-identical by construction.
    """

    def next_v(ev):
        return dot_f32(A, ev) / ev

    return _solve_traced(next_v, A.shape[0], A.dtype, eps, max_itr)


def solve_operator_traced(
    matvec, n: int, eps: float, max_itr: int, dtype=jnp.float32,
    eps_mode: str = "absolute",
):
    """:func:`solve_operator` with the per-round λ history of
    :func:`solve_matvec_traced` — convergence observability for
    MATRIX-FREE operators (feed the history to
    `ops.spectral.convergence_report` to estimate |λ₂/λ₁|; for a
    stochastic operator like the PageRank Google matrix that ratio IS the
    chain's mixing rate).  Traced — wrap in ``jax.jit`` with the
    non-array arguments static."""

    def next_v(ev):
        return matvec(ev) / ev

    return _solve_traced(next_v, n, dtype, eps, max_itr, eps_mode)


def _solve_traced(
    next_v, n: int, dtype, eps: float, max_itr: int, eps_mode: str = "absolute"
):
    cond, body = _make_cond_body(next_v, eps, max_itr, eps_mode)
    init = _init_carry(n, next_v, dtype)
    hist0 = jnp.zeros((max_itr,), dtype)

    def cond_t(ch):
        return cond(ch[0])

    def body_t(ch):
        c, hist = ch
        c2 = body(c)
        # the body just advanced past round c.i, whose λ is c2.lam
        return c2, lax.dynamic_update_index_in_dim(hist, c2.lam, c.i, axis=0)

    out, hist = lax.while_loop(cond_t, body_t, (init, hist0))
    res = _finish(out, max_itr)
    if max_itr > 0:
        # the converging round never ran a body — write its λ (on cap
        # exhaustion the clamped index rewrites hist[max-1] with the same
        # value, a no-op), then pad the tail with the final λ so
        # downstream plots/deltas are clean
        hist = lax.dynamic_update_index_in_dim(
            hist, res.eigenvalue, jnp.minimum(res.rounds, max_itr - 1), axis=0
        )
        hist = jnp.where(jnp.arange(max_itr) <= res.rounds, hist, res.eigenvalue)
    return res, hist




def storage_matvec(Aq: jax.Array, ev: jax.Array) -> jax.Array:
    """``Aq @ ev`` for a matrix held in reduced precision (bf16, f16):
    every entry is widened to f32 (exactly) and multiplied by the f32
    ``ev``, and the products are summed in f32.

    The ONE storage-mode product, shared by the dense, multi-round,
    checkpoint and sharded storage bodies.  The vector is never
    quantized: a round computed against ``bf16(ev)`` and divided by it
    injects ~λ·2⁻⁹ of noise into v on every round, which the absolute
    eps = 1e-3 stop can never pass.  Written as a product-and-reduce so
    XLA fuses the widening into the one pass over ``Aq`` and never
    materializes an f32 copy of the matrix."""
    return jnp.sum(Aq.astype(jnp.float32) * ev[None, :], axis=1)


def _round_product(A: jax.Array, storage_dtype, symmetric: bool, interpret: bool):
    """``(A as stored, O(n) state dtype, ev -> A @ ev)`` for one solve:
    the symmetric kernel when A is declared symmetric, else
    :func:`storage_matvec` for reduced-precision A, else ``dot_f32``."""
    if storage_dtype is not None:
        A = A.astype(storage_dtype)
    # reduced-precision A keeps f32 O(n) state (solve_matvec_loop's rule)
    dtype = jnp.float32 if jnp.dtype(A.dtype).itemsize < 4 else A.dtype
    if symmetric:
        from .pallas import kernels

        def product(ev):
            return kernels.symv(A, ev, interpret=interpret).astype(dtype)
    elif dtype != A.dtype:
        def product(ev):
            return storage_matvec(A, ev)
    else:
        def product(ev):
            return dot_f32(A, ev)
    return A, dtype, product


@partial(
    jax.jit, static_argnames=("eps", "max_itr", "storage_dtype", "eps_mode")
)
def solve_matvec_storage(
    A: jax.Array,
    eps: float,
    max_itr: int,
    storage_dtype=jnp.bfloat16,
    ev0: jax.Array | None = None,
    eps_mode: str = "absolute",
) -> SolveResult:
    """Matvec-form solve with reduced-precision matrix STORAGE.

    A is cast once to ``storage_dtype`` (half the bytes per round in bf16
    or f16); each round is :func:`storage_matvec`, and all O(n) state
    (v, ev, stop check, λ) stays float32.

    Accuracy: bf16 quantizes A's entries to ~3 decimal digits, so λ
    carries a ~1e-3 relative error and ``A·v ≈ λ·v`` holds to ~2e-3 —
    looser than the float32 path's 1e-3.  Round counts land within ±1 of
    the float32 ones.  This is the opt-in fast mode; the default stays
    float32.

    ``A`` may already be in ``storage_dtype`` (the cast is then a no-op):
    that is how dims whose float32 copy would not fit device memory are
    solved, with the matrix generated on the device in bf16.

    ``storage_dtype=jnp.float16`` carries less λ error than bf16 at the
    same bytes, but f16's narrow exponent underflows below ~6e-5, so it
    is only safe while the matrix entries stay in f16's normal range
    (Hilbert beyond ~16384² does not); bf16 keeps f32's exponent range.
    """
    Aq, dtype, product = _round_product(A, storage_dtype, False, False)
    return solve_matvec_loop(
        Aq, lambda ev: product(ev) / ev, eps, max_itr, state_dtype=dtype,
        ev0=ev0, eps_mode=eps_mode,
    )


@partial(
    jax.jit,
    static_argnames=("eps", "max_itr", "eps_mode", "storage_dtype", "interpret"),
)
def solve_matvec_symmetric(
    A: jax.Array,
    eps: float,
    max_itr: int,
    ev0: jax.Array | None = None,
    eps_mode: str = "absolute",
    storage_dtype=None,
    interpret: bool = False,
) -> SolveResult:
    """Matvec-form solve of a matrix DECLARED symmetric (checked nowhere,
    like BLAS ``symv``; a non-symmetric A gives a wrong answer): each
    round's product is :func:`..pallas.kernels.symv`, which reads only
    A's upper triangle.  Same loop as :func:`solve_matvec`; the kernel
    sums in another order than XLA's dense product, so round counts may
    differ by the usual ±1 of float32.  ``interpret`` runs the kernel
    through the Pallas interpreter."""
    A, dtype, product = _round_product(A, storage_dtype, True, interpret)
    return solve_matvec_loop(
        A, lambda ev: product(ev) / ev, eps, max_itr, state_dtype=dtype,
        ev0=ev0, eps_mode=eps_mode,
    )


@partial(
    jax.jit,
    static_argnames=(
        "eps", "max_itr", "chunk", "eps_mode", "storage_dtype", "symmetric",
        "interpret",
    ),
)
def solve_multiround(
    A: jax.Array,
    eps: float,
    max_itr: int,
    chunk: int = 18,
    ev0: jax.Array | None = None,
    eps_mode: str = "absolute",
    storage_dtype=None,
    symmetric: bool = False,
    interpret: bool = False,
) -> SolveResult:
    """Matvec-form solve that decides whether to go on once per ``chunk``
    rounds instead of once per round.

    The outer ``lax.while_loop`` runs chunks; each chunk is a fixed-trip
    loop of ``chunk`` rounds that checks the stop before every round and
    FREEZES the state (a select, no branch) once it fires or the cap is
    reached.  On a GPU a while loop reads its predicate back to the host
    on every trip, while a loop of known trip count does not, so a
    17-round solve with the default ``chunk=18`` pays one or two of
    those reads instead of eighteen.  The cost is the frozen rounds'
    products: a solve converging at round c computes
    ``(-c) mod chunk`` products it throws away.  Size ``chunk`` to the
    workload's round count + 1 (``fixtures.HILBERT_ROUNDS``).

    Semantics are bit-exact with :func:`solve_matvec_loop` given the same
    product: the round is the same ``_make_cond_body`` body and the
    epilogue the shared :func:`_finish`.

    The product is dense ``dot_f32``; :func:`storage_matvec` with
    ``storage_dtype``; and with ``symmetric=True`` — a DECLARATION that A
    is symmetric, checked nowhere, like BLAS ``symv`` — the upper-triangle
    kernel :func:`..pallas.kernels.symv`, which reads ≈ half of A per
    round.  ``interpret`` runs that kernel through the Pallas interpreter.
    """
    A, dtype, product = _round_product(A, storage_dtype, symmetric, interpret)

    def next_v(ev):
        return product(ev) / ev

    cond, body = _make_cond_body(next_v, eps, max_itr, eps_mode)

    def step(_, c: _Carry) -> _Carry:
        go = cond(c)
        nxt = body(c)
        return jax.tree.map(lambda a, b: jnp.where(go, a, b), nxt, c)

    def run_chunk(c: _Carry) -> _Carry:
        return lax.fori_loop(0, chunk, step, c)

    init = _init_carry(A.shape[0], next_v, dtype, ev0)
    return _finish(lax.while_loop(cond, run_chunk, init), max_itr)
