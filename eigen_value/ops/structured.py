"""Fast matvecs for structured matrices — operands for the matrix-free
operator API (:func:`..api.max_eigenvalue_operator`).

A structured positive matrix need never be materialized: its matvec is
all the power-form solver observes (solver_matvec.py module docstring).
The constructors here replace the O(n²) dense pass with the structure's
natural cost — O(n log n) FFT for Hankel/Toeplitz/circulant (the
benchmark family itself: the Hilbert matrix ``A[r][c] = 1/(r+c+1)`` is
Hankel with profile ``h[k] = 1/(k+1)``), small matmuls for Kronecker and
low-rank, O(nnz) gathers for sparse — and the combinators
(:func:`add_matvec`, :func:`scale_matvec`) compose them.

The reference has no analog: its kernels require a dense float32 buffer
(similarity_transform.hpp:8-9).  FFT rounding differs from the dense
row-sum reduction order, so round counts may differ ±1 from the dense
solver (documented at the operator entry).

Everything is jit-compatible; the FFT plans are baked at trace time for
a static ``n``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _fft_len(min_len: int) -> int:
    """Smallest power of two ≥ min_len (power-of-two FFTs are the fast
    path on every backend)."""
    return 1 << (min_len - 1).bit_length()


def _spectrum_rfft(arr, m: int):
    """rfft of a profile vector, as a HOST constant when possible.

    The factories below close over the precomputed spectrum.  Computing
    the O(n) spectrum with numpy keeps it a host constant that jit embeds
    in the program (O(n), unlike the O(n²) arrays that must travel as
    arguments).  Precision: the host spectrum is f64-computed then cast
    to complex64, so it differs from a device f32 FFT by f32 accumulation
    error that grows with m — covered by the operators' documented ±1
    round-count tolerance.  Traced inputs (factory called under jit) keep
    the jnp path.
    """
    if isinstance(arr, jax.core.Tracer):
        return jnp.fft.rfft(arr.astype(jnp.float32), m)
    return np.fft.rfft(np.asarray(arr, np.float32), m).astype(np.complex64)


def _spectrum_operand(Sf):
    """Closure over a precomputed spectrum, called inside the matvec to
    get it as an operand.

    A host (numpy) complex64 spectrum is split into its two f32 halves
    and rebuilt with ``lax.complex`` per call: eager and jitted calls of
    an operator then compute bit-identical products (with a complex64
    constant, XLA's jitted product differs in the last bits, ~1e-6, from
    the op-by-op one).  Under jit both halves embed as constants and the
    complex() folds at compile time.  Traced spectra (factory called
    under jit) pass through untouched."""
    if isinstance(Sf, np.ndarray) and np.iscomplexobj(Sf):
        re = np.ascontiguousarray(Sf.real.astype(np.float32))
        im = np.ascontiguousarray(Sf.imag.astype(np.float32))
        return lambda: jax.lax.complex(jnp.asarray(re), jnp.asarray(im))
    return lambda: Sf


def _matmul_f32(a, b):
    """Matmul pinned to full float32 on every backend.

    A GPU may run float32 matmuls in TF32 (about three decimal digits):
    fine for ML, fatal for the operator stop check — a row-sum noise of
    ~λ·2⁻¹¹ dwarfs the ABSOLUTE eps=1e-3 stop whenever λ ≳ 1, so the
    Kronecker/low-rank solves would silently exhaust MAX_ITR on the card
    while converging on the CPU.  ``Precision.HIGHEST`` keeps full f32
    products at a FLOP cost that is irrelevant here (these matvecs are
    thin).
    """
    return jnp.matmul(
        a,
        b,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )


def hankel_matvec(h: jax.Array, n: int):
    """Matvec closure for the n×n Hankel matrix ``A[r][c] = h[r+c]``
    (constant anti-diagonals; ``len(h) = 2n-1``).

    ``y[r] = Σ_c h[r+c] x[c]`` is a correlation — equivalently the slice
    ``[n-1 : 2n-1]`` of the linear convolution ``h ⊛ reverse(x)`` —
    computed by real FFT in O(n log n).
    """
    if h.shape[0] != 2 * n - 1:
        raise ValueError(f"need len(h) == 2n-1 == {2 * n - 1}, got {h.shape[0]}")
    # m >= 2n-1 suffices even though the full linear convolution is length
    # 3n-2: circular aliasing wraps entries s >= m onto s - m < n-1, all
    # in the DISCARDED prefix of the slice below (verified bit-comparable
    # to the 3n-2 transform).  rfft rejects bf16/f16, so compute in f32
    # and cast back — the operator then composes with reduced-precision
    # solver state.
    m = _fft_len(2 * n - 1)
    Hf = _spectrum_operand(_spectrum_rfft(h, m))

    def matvec(x: jax.Array) -> jax.Array:
        z = jnp.fft.irfft(Hf() * jnp.fft.rfft(x[::-1].astype(jnp.float32), m), m)
        return z[n - 1 : 2 * n - 1].astype(x.dtype)

    return matvec


def toeplitz_matvec(c: jax.Array, r: jax.Array, n: int):
    """Matvec closure for the n×n Toeplitz matrix with first column ``c``
    and first row ``r`` (``A[i][j] = c[i-j]`` for i ≥ j, ``r[j-i]`` for
    j ≥ i; ``c[0]`` must equal ``r[0]``).

    ``y = A x`` is the middle slice of the linear convolution of the
    diagonal profile ``t = [r[n-1..1] reversed | c]`` with ``x``:
    ``y[i] = Σ_j t[(n-1) + (i-j)] x[j]``.
    """
    if c.shape[0] != n or r.shape[0] != n:
        raise ValueError(f"need len(c) == len(r) == n == {n}")
    # t[k] = A[i][j] with i-j = k-(n-1).  Eager inputs build t on host:
    # a jnp.concatenate would put t on the default device only for
    # _spectrum_rfft to pull it straight back.
    if isinstance(c, jax.core.Tracer) or isinstance(r, jax.core.Tracer):
        t = jnp.concatenate([r[1:][::-1], c])
    else:
        t = np.concatenate(
            [np.asarray(r, np.float32)[1:][::-1], np.asarray(c, np.float32)]
        )
    m = _fft_len(2 * n - 1)  # aliasing only corrupts the discarded prefix
    Tf = _spectrum_operand(_spectrum_rfft(t, m))

    def matvec(x: jax.Array) -> jax.Array:
        z = jnp.fft.irfft(Tf() * jnp.fft.rfft(x.astype(jnp.float32), m), m)
        return z[n - 1 : 2 * n - 1].astype(x.dtype)

    return matvec


def hilbert_matvec(n: int, dtype=jnp.float32):
    """The Hilbert matrix ``A[r][c] = 1/(r+c+1)`` as an O(n)-memory FFT
    operator — the benchmark family without its n² bytes."""
    h = 1.0 / jnp.arange(1, 2 * n, dtype=dtype)
    return hankel_matvec(h, n)


def circulant_matvec(c: jax.Array, n: int):
    """Matvec closure for the n×n circulant matrix ``A[i][j] =
    c[(i-j) mod n]`` (first column ``c``).

    Circulants diagonalize in the Fourier basis, so ``y = A x`` is the
    EXACT circular convolution ``irfft(rfft(c)·rfft(x))`` — no padding,
    no aliasing slice (the special case of Toeplitz where wraparound is
    the structure itself).  O(n log n) per matvec, O(n) memory.
    """
    if c.shape[0] != n:
        raise ValueError(f"need len(c) == n == {n}, got {c.shape[0]}")
    Cf = _spectrum_operand(_spectrum_rfft(c, n))

    def matvec(x: jax.Array) -> jax.Array:
        z = jnp.fft.irfft(Cf() * jnp.fft.rfft(x.astype(jnp.float32)), n)
        return z.astype(x.dtype)

    return matvec


def low_rank_matvec(U: jax.Array, V: jax.Array, diag: jax.Array | None = None):
    """Matvec closure for ``A = U Vᵀ (+ diag)`` — a positive rank-k
    matrix (plus an optional elementwise-nonnegative diagonal), never
    materialized.

    ``y = U (Vᵀ x) + diag·x`` is two skinny matmuls, O(n·k) FLOPs and
    O(n·k) memory vs the dense pass's O(n²) — and like
    :func:`kron_matvec` the work is matmuls.  Positivity
    contract (the solver requires a positive A,
    similarity_transform.hpp:4-5 semantics): every entry of ``U Vᵀ``
    must be > 0 — entrywise-positive ``U`` and ``V`` suffice — and
    ``diag``, if given, must be ≥ 0 elementwise.  Rank-one positive
    updates of a known operator (e.g. teleportation terms in
    PageRank-style chains) are the canonical use.
    """
    n, k = U.shape
    n2, k2 = V.shape
    if n != n2 or k != k2:
        raise ValueError(f"need U and V both n×k, got {U.shape} and {V.shape}")
    if diag is not None and diag.shape != (n,):
        raise ValueError(f"need diag of shape ({n},), got {diag.shape}")

    def matvec(x: jax.Array) -> jax.Array:
        # f32-pinned matmuls: a TF32 product breaks the absolute-eps stop
        # for λ ≳ 1 (see _matmul_f32).
        y = _matmul_f32(U, _matmul_f32(V.T, x)).astype(x.dtype)
        return y if diag is None else y + diag * x

    return matvec


def sparse_matvec(A_sp):
    """Matvec closure for a ``jax.experimental.sparse.BCOO`` matrix —
    O(nnz) per round instead of the dense pass's O(n²).

    Positivity contract: the similarity-transform method's convergence
    theory assumes a POSITIVE matrix (similarity_transform.hpp comments;
    SURVEY.md §0), and a sparse matrix is at best NONNEGATIVE.  The
    iteration remains well-defined (all iterates stay positive) whenever
    every row has at least one positive entry, and the row sums converge
    to λ_max whenever the matrix is primitive (irreducible + aperiodic —
    e.g. any irreducible matrix with a positive diagonal entry).  For
    merely irreducible-periodic matrices the row-sum sequence oscillates
    and the solve hits the MAX_ITR cap (``converged=False``) — the same
    failure surface the dense solver has for that input.

    BCOO matvec lowers to gather/segment-sum — correct and
    jit-compatible everywhere, but scatter-heavy.  For bounded row
    degree, :func:`ell_matvec` is the better layout (dense vectorized
    gather, no scatter).
    """
    from jax.experimental import sparse as jsparse

    if not isinstance(A_sp, jsparse.BCOO):
        raise TypeError(f"need a jax.experimental.sparse.BCOO, got {type(A_sp)}")
    n, n2 = A_sp.shape
    if n != n2:
        raise ValueError(f"need a square matrix, got {A_sp.shape}")

    def matvec(x: jax.Array) -> jax.Array:
        return A_sp @ x

    return matvec


def ell_matvec(cols: jax.Array, vals: jax.Array):
    """Matvec closure for a sparse matrix in padded ELL row format — the
    vector-friendly sparse layout: ``cols``/``vals`` are (n, k) with row ``i``
    holding its ≤k nonzeros ``A[i, cols[i, j]] = vals[i, j]`` (pad unused
    slots with ``vals = 0``; the padded ``cols`` entry is arbitrary, 0 by
    convention).

    ``y = (vals * x[cols]).sum(axis=1)`` is one dense vectorized gather
    plus a lane reduction — no scatter, no segment sums, static shapes —
    which is why ELL beats COO/CSR on vector hardware whenever the row
    degree is bounded.  O(n·k) per round.  Positivity contract as in
    :func:`sparse_matvec` (rows must not be all-padding).
    """
    if cols.shape != vals.shape or cols.ndim != 2:
        raise ValueError(
            f"need matching (n, k) cols/vals, got {cols.shape} and {vals.shape}"
        )

    def matvec(x: jax.Array) -> jax.Array:
        return jnp.sum(vals * x[cols], axis=1)

    return matvec


def ell_from_coo(rows, cols, vals, n: int):
    """Pack COO triplets into the padded (cols, vals) ELL arrays of
    :func:`ell_matvec` (host-side preprocessing, NumPy in, jax.Array out).
    k = max row degree; duplicate (row, col) entries land in separate
    slots, so the matvec's lane reduction sums them.

    Fully vectorized (argsort + cumsum + one fancy-indexed scatter): the
    dims this sparse path exists for are 10⁵–10⁶ rows, where a Python
    per-row loop would take minutes.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if len(rows) and (rows.min() < 0 or rows.max() >= n):
        raise ValueError(f"row indices must be in [0, {n}), got [{rows.min()}, {rows.max()}]")
    if len(cols) and (cols.min() < 0 or cols.max() >= n):
        raise ValueError(f"col indices must be in [0, {n}), got [{cols.min()}, {cols.max()}]")
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], np.asarray(vals)[order]
    counts = np.bincount(rows_s, minlength=n) if len(rows) else np.zeros(n, np.int64)
    k = int(counts.max()) if len(rows) else 1
    ell_cols = np.zeros((n, max(k, 1)), np.int32)
    ell_vals = np.zeros((n, max(k, 1)), np.float32)
    if len(rows):
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(rows_s)) - starts[rows_s]  # position within row
        ell_cols[rows_s, slot] = cols_s
        ell_vals[rows_s, slot] = vals_s
    return jnp.asarray(ell_cols), jnp.asarray(ell_vals)


def add_matvec(*matvecs):
    """Operator sum: the matvec of ``A₁ + A₂ + …`` from the constituent
    matvecs.  Sums of positive (or nonnegative, per the sparse contract)
    operators are positive — the composition rule that lets structured
    parts combine without materializing anything (e.g. sparse + rank-one
    teleportation = the PageRank operator, examples/pagerank.py)."""
    if not matvecs:
        raise ValueError("need at least one matvec")

    def matvec(x: jax.Array) -> jax.Array:
        y = matvecs[0](x)
        for mv in matvecs[1:]:
            y = y + mv(x)
        return y

    return matvec


def scale_matvec(matvec, alpha: float):
    """Operator scaling: the matvec of ``α·A`` (α > 0 preserves
    positivity and scales λ_max by exactly α — the eigenvector is
    unchanged, a useful normalization for operators whose λ would
    over/underflow reduced-precision state)."""
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0 to preserve positivity, got {alpha}")

    def scaled(x: jax.Array) -> jax.Array:
        return alpha * matvec(x)

    return scaled


def kron_matvec(B: jax.Array, C: jax.Array):
    """Matvec closure for the Kronecker product ``A = B ⊗ C`` (B p×p,
    C q×q, A n×n with n = p·q) — never materialized.

    With x viewed row-major as the p×q matrix X (``x[i·q + j] = X[i,j]``),
    ``(B ⊗ C) x = vec(B X Cᵀ)``: two dense matmuls, O(pq(p+q)) FLOPs vs
    the dense pass's O(p²q²) — and unlike the FFT operators these are
    matrix products, so large Kronecker-structured solves are
    compute-dense, not bandwidth-bound.  B, C positive ⇒ A positive
    (entrywise product of positives), and λ_max(A) = λ_max(B)·λ_max(C) —
    tests pin that identity against the dense solve.
    """
    p, p2 = B.shape
    q, q2 = C.shape
    if p != p2 or q != q2:
        raise ValueError(f"need square factors, got {B.shape} and {C.shape}")

    def matvec(x: jax.Array) -> jax.Array:
        X = x.reshape(p, q)
        # f32-pinned matmuls: at the λ = λ_B·λ_C scales Kronecker products
        # reach (10²–10³ for random positive factors), TF32 products leave
        # row-sum noise ≫ the absolute eps=1e-3 stop and the solve
        # exhausts MAX_ITR (see _matmul_f32).
        Y = _matmul_f32(_matmul_f32(B, X), C.T)
        return Y.reshape(-1).astype(x.dtype)

    return matvec
