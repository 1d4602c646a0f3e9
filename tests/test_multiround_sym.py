"""The upper-triangle kernel (kernels.symv) and the solves built on it
(solve_matvec_symmetric, solve_multiround(symmetric=True)), in Pallas
interpret mode.

For a SYMMETRIC matrix each product reads only the g(g+1)/2 tiles on or
above the diagonal — about half the bytes of the bandwidth-bound solve.
The kernel sums in another f32 order than XLA's dense product, so parity
with the dense solve is round counts + λ tolerance, while chunking and
repeated calls stay bit-exact.  tests/test_gpu_hw.py re-pins parity on
the card.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from eigen_value import SolverConfig, max_eigenvalue, fixtures
from eigen_value.config import EPS, MAX_ITR
from eigen_value.ops.pallas import kernels
from eigen_value.ops.pallas.kernels import sym_tiles
from eigen_value.ops.solver_matvec import (
    solve_matvec,
    solve_matvec_symmetric,
    solve_multiround,
)
from eigen_value.reference_impl import parallel_oracle

T = kernels.SYM_TILE


def _sym(n: int, seed: int = 3, scale: float = 1.0) -> jnp.ndarray:
    """A random symmetric matrix with all entries > 0."""
    r = np.random.default_rng(seed).random((n, n), np.float32) + 0.1
    return jnp.asarray((r + r.T) * scale)


def _solve_sym(A, chunk=18, **kw):
    return solve_multiround(
        A, EPS, MAX_ITR, chunk=chunk, interpret=True, symmetric=True, **kw
    )


def _symv(A, x):
    return np.asarray(kernels.symv(A, x, interpret=True))


class TestSymTile:
    def test_picks_largest_dividing_multiple_of_128(self):
        """The tile table enumerates exactly the g(g+1)/2 tiles with
        i ≤ j, row-major, for any n (edge tiles cover the remainder)."""
        for n in (64, 128, 200, 8192):
            i, j = sym_tiles(n)
            g = -(-n // T)
            assert i.size == g * (g + 1) // 2
            assert (i <= j).all() and j.max() == g - 1
            assert list(zip(i, j)) == sorted(zip(i, j))
            assert i.dtype == np.int32 and j.dtype == np.int32

    def test_none_when_unalignable(self):
        """No dim is unalignable: a dim below one tile is a single tile."""
        for n in (1, 3, T - 1):
            i, j = sym_tiles(n)
            assert list(zip(i, j)) == [(0, 0)]


@pytest.mark.parametrize("n", [1, 3, 63, 64, 65, 100, 130, 257])
def test_symv_matches_dense(n):
    """The kernel's product against a float64 dense one, for dims that are
    no multiple of the tile and dims smaller than one tile."""
    A = _sym(n, seed=n)
    x = np.random.default_rng(n).random(n, np.float32) + 0.5
    want = np.asarray(A, np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(_symv(A, jnp.asarray(x)), want, rtol=2e-6)


def test_symv_repeated_calls_bit_identical():
    """No atomics: the partials are summed in a fixed order, so a product
    never depends on the order in which blocks ran."""
    A = _sym(300)
    x = jnp.asarray(np.random.default_rng(1).random(300, np.float32) + 0.5)
    first = _symv(A, x)
    for _ in range(3):
        np.testing.assert_array_equal(_symv(A, x), first)


def test_symv_lower_triangle_never_read():
    """NaN below the diagonal changes nothing: the diagonal tiles load
    their upper triangle only, and no tile below the diagonal is loaded."""
    n = 200
    A = np.asarray(_sym(n))
    poisoned = A.copy()
    poisoned[np.tril_indices(n, -1)] = np.nan
    x = jnp.asarray(np.random.default_rng(2).random(n, np.float32) + 0.5)
    np.testing.assert_array_equal(_symv(jnp.asarray(poisoned), x), _symv(A, x))


def test_symv_bf16_storage_widened_exactly():
    """bf16 entries are widened to f32 inside the kernel: the product
    equals the f32 kernel's on the widened matrix, bit for bit."""
    A = _sym(130).astype(jnp.bfloat16)
    x = jnp.asarray(np.random.default_rng(4).random(130, np.float32) + 0.5)
    np.testing.assert_array_equal(_symv(A, x), _symv(A.astype(jnp.float32), x))


def test_symv_requires_gpu_without_interpret():
    """Asked for on the CPU without interpret=True, the kernel is an
    error, never a silent interpreter."""
    with pytest.raises(ValueError, match="interpret=True"):
        max_eigenvalue(
            fixtures.hilbert_matrix(128),
            SolverConfig(backend="matvec", symmetric=True),
        )


@pytest.mark.parametrize("n", [128, 256, 512])
def test_round_parity_vs_parity_table(n):
    """Hilbert round counts must match HILBERT_ROUNDS (the reference
    parity invariant) despite the kernel's summation order."""
    H = fixtures.hilbert_matrix(n)
    want = solve_matvec(H, EPS, MAX_ITR)
    got = _solve_sym(H)
    assert int(got.rounds) == fixtures.HILBERT_ROUNDS[n]
    assert bool(got.converged)
    assert float(got.eigenvalue) == pytest.approx(
        float(want.eigenvalue), rel=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(got.eigenvector), np.asarray(want.eigenvector), rtol=1e-4
    )


def test_multiple_tiles_per_side_and_dot_formulation():
    """n = 512 is 8×8 tiles (36 tiles, 28 off the diagonal); the
    per-round and chunked loops agree bit for bit."""
    H = fixtures.hilbert_matrix(512)
    per_round = solve_matvec_symmetric(H, EPS, MAX_ITR, interpret=True)
    chunked = _solve_sym(H)
    assert int(per_round.rounds) == fixtures.HILBERT_ROUNDS[512]
    assert float(chunked.eigenvalue) == float(per_round.eigenvalue)
    np.testing.assert_array_equal(
        np.asarray(chunked.eigenvector), np.asarray(per_round.eigenvector)
    )


@pytest.mark.parametrize("chunk", [1, 2, 5, 16, 40])
def test_chunk_boundaries_are_invisible(chunk):
    """Chunking the symmetric round sequence is bit-invisible (the same
    freeze-at-convergence argument as the dense loop)."""
    H = fixtures.hilbert_matrix(256)
    want = _solve_sym(H, chunk=18)
    got = _solve_sym(H, chunk=chunk)
    assert int(got.rounds) == int(want.rounds)
    assert float(got.eigenvalue) == float(want.eigenvalue)
    np.testing.assert_array_equal(
        np.asarray(got.eigenvector), np.asarray(want.eigenvector)
    )


@pytest.mark.parametrize("cap", [0, 1, 9, 10])
def test_cap_exhaustion(cap):
    """rounds == cap, converged False, λ = last checked round's v[0] —
    same cap semantics as the production loop."""
    H = fixtures.hilbert_matrix(256)
    want = solve_matvec_symmetric(H, EPS, cap, interpret=True)
    got = solve_multiround(H, EPS, cap, chunk=4, interpret=True, symmetric=True)
    assert int(got.rounds) == int(want.rounds) == min(
        cap, fixtures.HILBERT_ROUNDS[256]
    )
    assert bool(got.converged) == bool(want.converged) == (
        cap > fixtures.HILBERT_ROUNDS[256]
    )
    assert float(got.eigenvalue) == float(want.eigenvalue)


def test_only_the_upper_block_triangle_is_read():
    """THE defining property: corrupt everything strictly below the
    diagonal of a symmetric matrix — the symmetric solve must not notice
    (bit-identical result)."""
    A = _sym(256)
    below = jnp.tril(jnp.ones((256, 256), bool), -1)
    corrupted = jnp.where(below, jnp.float32(7.25), A)
    want = _solve_sym(A)
    got = _solve_sym(corrupted)
    assert int(got.rounds) == int(want.rounds)
    assert float(got.eigenvalue) == float(want.eigenvalue)
    np.testing.assert_array_equal(
        np.asarray(got.eigenvector), np.asarray(want.eigenvector)
    )


def test_relative_eps_mode():
    """eps_mode='relative' reaches the symmetric solve's stop."""
    A = _sym(128, scale=1e5)
    want = solve_matvec(A, EPS, MAX_ITR, eps_mode="relative")
    got = _solve_sym(A, eps_mode="relative")
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged)
    assert float(got.eigenvalue) == pytest.approx(
        float(want.eigenvalue), rel=1e-5
    )


def test_bf16_storage():
    """Reduced-precision STORAGE composes: bf16 tiles, f32 state —
    anchored on the float64 oracle (±1 round, λ within 2e-3)."""
    H = fixtures.hilbert_matrix(256)
    ref = parallel_oracle(np.asarray(H), dtype=np.float64)
    got = _solve_sym(H, chunk=12, storage_dtype=jnp.bfloat16)
    assert abs(int(got.rounds) - fixtures.HILBERT_ROUNDS[256]) <= 1
    assert bool(got.converged)
    assert float(got.eigenvalue) == pytest.approx(ref.eigenvalue, rel=2e-3)
    assert got.eigenvalue.dtype == jnp.float32


def test_unalignable_dim_raises():
    """Dims with no relation to the tile solve too: 96 (two tiles, the
    second partial) and the 3×3 anchor (one partial tile)."""
    H = fixtures.hilbert_matrix(96)
    want = solve_matvec(H, EPS, MAX_ITR)
    got = _solve_sym(H)
    assert abs(int(got.rounds) - int(want.rounds)) <= 1
    assert float(got.eigenvalue) == pytest.approx(
        float(want.eigenvalue), rel=1e-5
    )
    anchor = jnp.asarray(fixtures.ANCHOR_3X3, jnp.float32)
    # the anchor is not symmetric: symmetrize it for the declaration
    sym3 = (anchor + anchor.T) / 2
    got3 = _solve_sym(sym3)
    want3 = solve_matvec(sym3, EPS, MAX_ITR)
    assert float(got3.eigenvalue) == pytest.approx(
        float(want3.eigenvalue), rel=1e-5
    )


class TestConfigRouting:
    """The honored-or-rejected contract for the ``symmetric`` knob."""

    def test_explicit_multiround_backend_uses_triangle(self):
        """Via the public config, a below-diagonal corruption is invisible
        — proof the triangle kernel (not the dense product) ran."""
        A = _sym(256)
        corrupted = jnp.where(
            jnp.tril(jnp.ones((256, 256), bool), -1), jnp.float32(9.5), A
        )
        for backend in ("multiround", "matvec"):
            cfg = SolverConfig(backend=backend, symmetric=True, interpret=True)
            want = max_eigenvalue(A, cfg)
            got = max_eigenvalue(corrupted, cfg)
            assert float(got.eigenvalue) == float(want.eigenvalue), backend
            assert int(got.rounds) == int(want.rounds), backend

    def test_auto_consumes_the_declaration_on_cpu(self):
        """Under backend='auto' on the CPU the dense product keeps the job;
        declaring symmetry must neither raise nor change the answer."""
        H = fixtures.hilbert_matrix(256)
        want = max_eigenvalue(H)
        got = max_eigenvalue(H, SolverConfig(symmetric=True))
        assert float(got.eigenvalue) == float(want.eigenvalue)
        assert int(got.rounds) == int(want.rounds)

    def test_explicit_other_backend_rejects(self):
        H = fixtures.hilbert_matrix(128)
        with pytest.raises(ValueError, match="symmetric"):
            max_eigenvalue(H, SolverConfig(backend="xla", symmetric=True))

    def test_validate_checks_the_promise(self):
        A = np.array(_sym(128))  # writable copy
        A[3, 2] += 0.5  # break symmetry
        with pytest.raises(ValueError, match="not bitwise symmetric"):
            max_eigenvalue(
                jnp.asarray(A),
                SolverConfig(backend="multiround", symmetric=True, interpret=True),
                validate=True,
            )

    def test_mesh_path_rejects(self):
        import jax
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("rows",))
        H = fixtures.hilbert_matrix(256)
        with pytest.raises(ValueError, match="symmetric"):
            max_eigenvalue(H, SolverConfig(symmetric=True), mesh=mesh)

    def test_batch_and_operator_reject(self):
        from eigen_value import (
            max_eigenvalue_batch,
            max_eigenvalue_operator,
        )

        mats = jnp.stack([_sym(64), _sym(64, seed=5)])
        with pytest.raises(ValueError, match="symmetric"):
            max_eigenvalue_batch(mats, SolverConfig(symmetric=True))
        A = _sym(64)
        with pytest.raises(ValueError, match="symmetric"):
            max_eigenvalue_operator(
                lambda x: A @ x, 64, SolverConfig(symmetric=True)
            )
