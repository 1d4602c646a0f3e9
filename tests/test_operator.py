"""Matrix-free operator API (solve_operator / max_eigenvalue_operator)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eigen_value import fixtures, max_eigenvalue, max_eigenvalue_operator
from eigen_value.config import EPS, MAX_ITR
from eigen_value.ops.solver_matvec import solve_matvec, solve_operator


def test_dense_backed_operator_is_bitexact():
    """An operator wrapping a dense A@x must reproduce the dense matvec
    solver exactly (identical op sequence → identical f32 rounding)."""
    H = fixtures.hilbert_matrix(256)
    got = solve_operator(lambda x: H @ x, 256, EPS, MAX_ITR)
    want = solve_matvec(H, EPS, MAX_ITR)
    assert int(got.rounds) == int(want.rounds)
    assert float(got.eigenvalue) == float(want.eigenvalue)
    np.testing.assert_array_equal(
        np.asarray(got.eigenvector), np.asarray(want.eigenvector)
    )


def test_fft_hankel_operator_matches_dense():
    """The Hilbert matrix as an O(n)-memory FFT Hankel operator: λ within
    1e-4 relative of the dense solve, rounds within ±1 (FFT rounding
    differs from the dense reduction order), eigen-pair property holds."""
    from eigen_value.ops.structured import hilbert_matvec

    n = 256
    mv = hilbert_matvec(n)
    got = max_eigenvalue_operator(mv, n)
    want = max_eigenvalue(fixtures.hilbert_matrix(n))
    assert abs(int(got.rounds) - int(want.rounds)) <= 1
    assert float(got.eigenvalue) == pytest.approx(
        float(want.eigenvalue), rel=1e-4
    )
    H = np.asarray(fixtures.hilbert_matrix(n))
    v = np.asarray(got.eigenvector)
    assert np.allclose(H @ v, float(got.eigenvalue) * v, atol=1e-3)


def test_operator_is_jittable():
    n = 128
    H = fixtures.hilbert_matrix(n)
    f = jax.jit(lambda A: max_eigenvalue_operator(lambda x: A @ x, n))
    res = f(H)
    assert int(res.rounds) == fixtures.HILBERT_ROUNDS[n]
    assert bool(res.converged)


def test_operator_cap_exhaustion():
    H = fixtures.hilbert_matrix(128)
    res = solve_operator(lambda x: H @ x, 128, EPS, max_itr=2)
    assert not bool(res.converged) and int(res.rounds) == 2


class TestStructuredMatvecs:
    """FFT matvecs vs explicit dense constructions."""

    def test_hankel_matches_dense(self, rng):
        from eigen_value.ops.structured import hankel_matvec

        n = 96
        h = jnp.asarray(rng.random(2 * n - 1, dtype=np.float32) + 0.1)
        A = np.asarray(h)[np.add.outer(np.arange(n), np.arange(n))]
        x = jnp.asarray(rng.random(n, dtype=np.float32))
        got = np.asarray(hankel_matvec(h, n)(x))
        np.testing.assert_allclose(got, A @ np.asarray(x), rtol=2e-5, atol=1e-5)

    def test_spectrum_operand_split_is_exact(self, rng):
        """The spectrum closure (host complex64 split into f32 halves,
        rebuilt with lax.complex on device) must reproduce the raw complex
        constant BIT-EXACTLY — jitted and eager; the split exists so that
        eager and jitted operator calls agree bit for bit."""
        from eigen_value.ops.structured import _spectrum_operand

        Sf = np.fft.rfft(
            rng.random(257, dtype=np.float32), 512
        ).astype(np.complex64)
        rebuilt = np.asarray(_spectrum_operand(Sf)())
        assert rebuilt.dtype == np.complex64
        np.testing.assert_array_equal(rebuilt, Sf)
        # jit path: consumed inside a traced multiply, same product
        x = jnp.asarray(rng.random(257, dtype=np.float32))
        op = _spectrum_operand(Sf)
        got = np.asarray(jax.jit(lambda v: (op() * jnp.fft.rfft(v, 512)))(x))
        want = Sf * np.asarray(jnp.fft.rfft(x, 512))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        # traced spectra pass through untouched
        jitted = jax.jit(
            lambda h: _spectrum_operand(jnp.fft.rfft(h, 512))()[0]
        )
        assert np.isfinite(float(np.asarray(jitted(x)).real))

    def test_hankel_eager_dispatch_matches_jit(self, rng):
        """The factory closures must be usable EAGERLY (op-by-op
        dispatch), not only under jit, with bit-identical results."""
        from eigen_value.ops.structured import hankel_matvec

        n = 96
        h = jnp.asarray(rng.random(2 * n - 1, dtype=np.float32) + 0.1)
        x = jnp.asarray(rng.random(n, dtype=np.float32))
        mv = hankel_matvec(h, n)
        np.testing.assert_array_equal(
            np.asarray(mv(x)), np.asarray(jax.jit(mv)(x))
        )

    def test_toeplitz_matches_dense(self, rng):
        from eigen_value.ops.structured import toeplitz_matvec

        n = 96
        c = jnp.asarray(rng.random(n, dtype=np.float32) + 0.1)
        r = jnp.asarray(rng.random(n, dtype=np.float32) + 0.1).at[0].set(c[0])
        idx = np.subtract.outer(np.arange(n), np.arange(n))  # i - j
        A = np.where(idx >= 0, np.asarray(c)[np.abs(idx)], np.asarray(r)[np.abs(idx)])
        x = jnp.asarray(rng.random(n, dtype=np.float32))
        got = np.asarray(toeplitz_matvec(c, r, n)(x))
        np.testing.assert_allclose(got, A @ np.asarray(x), rtol=2e-5, atol=1e-5)

    def test_length_validation(self):
        from eigen_value.ops.structured import hankel_matvec, toeplitz_matvec

        with pytest.raises(ValueError, match="2n-1"):
            hankel_matvec(jnp.ones(5), 4)
        with pytest.raises(ValueError, match="len"):
            toeplitz_matvec(jnp.ones(3), jnp.ones(4), 4)

    def test_circulant_matches_dense(self, rng):
        from eigen_value.ops.structured import circulant_matvec

        n = 96
        c = jnp.asarray(rng.random(n, dtype=np.float32) + 0.1)
        idx = np.mod(np.subtract.outer(np.arange(n), np.arange(n)), n)
        A = np.asarray(c)[idx]
        x = jnp.asarray(rng.random(n, dtype=np.float32))
        got = np.asarray(circulant_matvec(c, n)(x))
        np.testing.assert_allclose(got, A @ np.asarray(x), rtol=2e-5, atol=1e-5)

    def test_circulant_operator_solve(self, rng):
        """A positive circulant's Perron eigenvalue is its column sum
        (constant row sums ⇒ the all-ones vector is the eigenvector and
        the solve stops in round 0)."""
        from eigen_value.ops.structured import circulant_matvec

        n = 128
        c = jnp.asarray(rng.random(n, dtype=np.float32) + 0.1)
        got = solve_operator(circulant_matvec(c, n), n, EPS, MAX_ITR)
        assert bool(got.converged)
        assert int(got.rounds) == 0
        assert float(got.eigenvalue) == pytest.approx(float(c.sum()), rel=1e-5)

    def test_kron_matches_dense(self, rng):
        from eigen_value.ops.structured import kron_matvec

        B = rng.random((12, 12), dtype=np.float32) + 0.1
        C = rng.random((8, 8), dtype=np.float32) + 0.1
        x = jnp.asarray(rng.random(96, dtype=np.float32))
        got = np.asarray(kron_matvec(jnp.asarray(B), jnp.asarray(C))(x))
        np.testing.assert_allclose(
            got, np.kron(B, C) @ np.asarray(x), rtol=2e-5, atol=1e-5
        )

    def test_kron_operator_solve(self, rng):
        """λ_max(B ⊗ C) = λ_max(B)·λ_max(C): the operator solve must
        recover the product of the factors' dense solves."""
        from eigen_value.ops.structured import kron_matvec

        B = jnp.asarray(rng.random((16, 16), dtype=np.float32) + 0.1)
        C = jnp.asarray(rng.random((24, 24), dtype=np.float32) + 0.1)
        got = solve_operator(kron_matvec(B, C), 16 * 24, EPS, MAX_ITR)
        lam_b = float(solve_matvec(B, EPS, MAX_ITR).eigenvalue)
        lam_c = float(solve_matvec(C, EPS, MAX_ITR).eigenvalue)
        assert bool(got.converged)
        assert float(got.eigenvalue) == pytest.approx(lam_b * lam_c, rel=1e-3)

    def test_kron_shape_validation(self):
        from eigen_value.ops.structured import kron_matvec

        with pytest.raises(ValueError, match="square"):
            kron_matvec(jnp.ones((3, 4)), jnp.ones((2, 2)))

    def test_matmul_operators_pin_f32_precision(self):
        """Every matmul-based operator must carry Precision.HIGHEST: at
        reduced precision (TF32 on a GPU) the row-sum noise at the
        λ-scales Kronecker products reach (10²–10³) dwarfs the absolute
        eps=1e-3 stop and the solve silently exhausts MAX_ITR."""
        from eigen_value.ops.structured import kron_matvec, low_rank_matvec

        kron = jax.make_jaxpr(kron_matvec(jnp.ones((4, 4)), jnp.ones((8, 8))))(
            jnp.ones(32)
        )
        assert str(kron).count("HIGHEST") >= 2, kron
        lr = jax.make_jaxpr(
            low_rank_matvec(jnp.ones((16, 2)), jnp.ones((16, 2)))
        )(jnp.ones(16))
        assert str(lr).count("HIGHEST") >= 2, lr

    def test_low_rank_matches_dense(self, rng):
        from eigen_value.ops.structured import low_rank_matvec

        n, k = 96, 4
        U = jnp.asarray(rng.random((n, k), dtype=np.float32) + 0.1)
        V = jnp.asarray(rng.random((n, k), dtype=np.float32) + 0.1)
        d = jnp.asarray(rng.random(n, dtype=np.float32))
        x = jnp.asarray(rng.random(n, dtype=np.float32))
        got = np.asarray(low_rank_matvec(U, V, d)(x))
        A = np.asarray(U) @ np.asarray(V).T + np.diag(np.asarray(d))
        np.testing.assert_allclose(got, A @ np.asarray(x), rtol=2e-5, atol=1e-5)

    def test_low_rank_operator_solve(self, rng):
        """A positive rank-k + diagonal operator solved matrix-free
        matches the dense matvec solver (λ within the FP reassociation
        tolerance, rounds within ±1)."""
        from eigen_value.ops.structured import low_rank_matvec

        n, k = 128, 3
        U = jnp.asarray(rng.random((n, k), dtype=np.float32) + 0.1)
        V = jnp.asarray(rng.random((n, k), dtype=np.float32) + 0.1)
        d = jnp.asarray(rng.random(n, dtype=np.float32))
        got = solve_operator(low_rank_matvec(U, V, d), n, EPS, MAX_ITR)
        want = solve_matvec(U @ V.T + jnp.diag(d), EPS, MAX_ITR)
        assert bool(got.converged)
        assert abs(int(got.rounds) - int(want.rounds)) <= 1
        assert float(got.eigenvalue) == pytest.approx(
            float(want.eigenvalue), rel=1e-4
        )

    def test_low_rank_shape_validation(self):
        from eigen_value.ops.structured import low_rank_matvec

        with pytest.raises(ValueError, match="n×k"):
            low_rank_matvec(jnp.ones((8, 2)), jnp.ones((8, 3)))
        with pytest.raises(ValueError, match="diag"):
            low_rank_matvec(jnp.ones((8, 2)), jnp.ones((8, 2)), jnp.ones(7))

    def test_toeplitz_operator_solve(self, rng):
        """A positive symmetric Toeplitz operator solved matrix-free
        matches the dense matvec solver."""
        from eigen_value.config import EPS, MAX_ITR
        from eigen_value.ops.structured import toeplitz_matvec

        n = 128
        c = jnp.asarray(1.0 / (1.0 + np.arange(n, dtype=np.float32)))
        mv = toeplitz_matvec(c, c, n)
        got = solve_operator(mv, n, EPS, MAX_ITR)
        idx = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
        A = jnp.asarray(np.asarray(c)[idx])
        want = solve_matvec(A, EPS, MAX_ITR)
        assert abs(int(got.rounds) - int(want.rounds)) <= 1
        assert float(got.eigenvalue) == pytest.approx(
            float(want.eigenvalue), rel=1e-4
        )


def test_operator_vmap_batched(rng):
    """Batched matrix-free solves: vmap over a batch of Hankel profiles
    (the structured analog of solve_batched)."""
    from eigen_value.ops.structured import hankel_matvec

    n, B = 64, 3
    hs = jnp.asarray(rng.random((B, 2 * n - 1), dtype=np.float32) + 0.1)

    def solve_one(h):
        return max_eigenvalue_operator(hankel_matvec(h, n), n)

    res = jax.vmap(solve_one)(hs)
    assert res.eigenvalue.shape == (B,)
    assert bool(jnp.all(res.converged))
    for b in range(B):
        A = np.asarray(hs[b])[np.add.outer(np.arange(n), np.arange(n))]
        v = np.asarray(res.eigenvector[b])
        lam = float(res.eigenvalue[b])
        assert np.allclose(A @ v, lam * v, atol=1e-2 * max(lam, 1.0))


class TestSparseOperators:
    """Sparse layouts (BCOO, padded ELL) and the operator combinators."""

    @staticmethod
    def _random_sparse(rng, n: int, deg: int):
        """COO triplets of a random nonnegative matrix with a positive
        diagonal (⇒ primitive, so the iteration converges) and ``deg``
        off-diagonal entries per row."""
        rows = np.repeat(np.arange(n), deg)
        cols = (rows + 1 + rng.integers(0, n - 1, size=rows.shape)) % n
        vals = rng.random(rows.shape[0], dtype=np.float32) + 0.1
        rows = np.concatenate([rows, np.arange(n)])
        cols = np.concatenate([cols, np.arange(n)])
        vals = np.concatenate([vals, np.ones(n, np.float32)])
        return rows, cols, vals

    @staticmethod
    def _dense(rows, cols, vals, n):
        A = np.zeros((n, n), np.float32)
        np.add.at(A, (rows, cols), vals)
        return A

    def test_ell_matches_dense(self, rng):
        from eigen_value.ops.structured import ell_from_coo, ell_matvec

        n = 96
        rows, cols, vals = self._random_sparse(rng, n, 4)
        A = self._dense(rows, cols, vals, n)
        mv = ell_matvec(*ell_from_coo(rows, cols, vals, n))
        x = jnp.asarray(rng.random(n, dtype=np.float32))
        np.testing.assert_allclose(
            np.asarray(mv(x)), A @ np.asarray(x), rtol=1e-5, atol=1e-6
        )

    def test_ell_from_coo_sums_duplicates(self):
        from eigen_value.ops.structured import ell_from_coo, ell_matvec

        rows = [0, 0, 1]
        cols = [1, 1, 0]
        vals = [2.0, 3.0, 4.0]
        mv = ell_matvec(*ell_from_coo(rows, cols, vals, 2))
        y = np.asarray(mv(jnp.asarray([1.0, 1.0], dtype=jnp.float32)))
        np.testing.assert_allclose(y, [5.0, 4.0])

    def test_ell_from_coo_packs_million_nnz_fast(self, rng):
        """The packer is vectorized (argsort + cumsum + one scatter): a
        ~10⁶-nnz matrix must pack in well under a second (the old per-row
        Python loop took minutes at the 10⁵–10⁶-row dims this sparse path
        exists for), and the result must match the equivalence oracle on a
        sampled matvec."""
        import time

        n = 200_000
        rows, cols, vals = self._random_sparse(rng, n, 4)  # 10⁶ nnz
        from eigen_value.ops.structured import ell_from_coo, ell_matvec

        # min-of-3: the single-shot wall raced transient host load and
        # flaked twice on 2026-08-19/20 (measured 0.03-0.2 s nominal); a
        # real regression to per-row Python packing is >10 s, so the
        # bound still bites
        pack_s = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            ell_cols, ell_vals = ell_from_coo(rows, cols, vals, n)
            pack_s = min(pack_s, time.perf_counter() - t0)
        assert pack_s < 1.0, f"packing 10⁶ nnz took {pack_s:.2f}s (min of 3)"
        assert ell_cols.shape == ell_vals.shape and ell_cols.shape[0] == n
        # row sums through the packed layout == COO row sums
        got = np.asarray(ell_matvec(ell_cols, ell_vals)(jnp.ones((n,), jnp.float32)))
        want = np.bincount(rows, weights=vals, minlength=n)
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-5)

    def test_ell_shape_validation(self):
        from eigen_value.ops.structured import ell_matvec

        with pytest.raises(ValueError, match="matching"):
            ell_matvec(jnp.zeros((4, 3), jnp.int32), jnp.zeros((4, 2)))

    def test_ell_from_coo_rejects_out_of_range_indices(self):
        """A typo'd index must raise, not vanish (row ≥ n used to be
        silently dropped by the bincount/packing loop; col ≥ n would be
        clamped by the gather at matvec time)."""
        from eigen_value.ops.structured import ell_from_coo

        with pytest.raises(ValueError, match="row indices"):
            ell_from_coo([0, 7], [1, 1], [1.0, 2.0], 4)
        with pytest.raises(ValueError, match="col indices"):
            ell_from_coo([0, 1], [1, 9], [1.0, 2.0], 4)
        with pytest.raises(ValueError, match="row indices"):
            ell_from_coo([-1], [0], [1.0], 4)

    def test_bcoo_matches_dense(self, rng):
        from jax.experimental import sparse as jsparse

        from eigen_value.ops.structured import sparse_matvec

        n = 64
        rows, cols, vals = self._random_sparse(rng, n, 3)
        A = self._dense(rows, cols, vals, n)
        A_sp = jsparse.BCOO.fromdense(jnp.asarray(A))
        mv = sparse_matvec(A_sp)
        x = jnp.asarray(rng.random(n, dtype=np.float32))
        np.testing.assert_allclose(
            np.asarray(mv(x)), A @ np.asarray(x), rtol=1e-5, atol=1e-6
        )

    def test_sparse_validation(self):
        from jax.experimental import sparse as jsparse

        from eigen_value.ops.structured import sparse_matvec

        with pytest.raises(TypeError, match="BCOO"):
            sparse_matvec(jnp.ones((4, 4)))
        rect = jsparse.BCOO.fromdense(jnp.ones((4, 3)))
        with pytest.raises(ValueError, match="square"):
            sparse_matvec(rect)

    def test_sparse_operator_solve_matches_dense(self, rng):
        """ELL sparse solve through the full operator path vs the dense
        solver on the materialized matrix — identical matvec algebra up
        to reduction order."""
        from eigen_value.ops.structured import ell_from_coo, ell_matvec

        n = 128
        rows, cols, vals = self._random_sparse(rng, n, 6)
        A = self._dense(rows, cols, vals, n)
        got = max_eigenvalue_operator(ell_matvec(*ell_from_coo(rows, cols, vals, n)), n)
        want = max_eigenvalue(jnp.asarray(A))
        assert bool(got.converged)
        assert abs(int(got.rounds) - int(want.rounds)) <= 1
        assert float(got.eigenvalue) == pytest.approx(
            float(want.eigenvalue), rel=1e-4
        )

    def test_combinators_match_dense(self, rng):
        """scale_matvec/add_matvec algebra: α·A + B vs the dense sum."""
        from eigen_value.ops.structured import (
            add_matvec,
            low_rank_matvec,
            scale_matvec,
        )

        n = 48
        U = jnp.asarray(rng.random((n, 2), dtype=np.float32) + 0.1)
        V = jnp.asarray(rng.random((n, 2), dtype=np.float32) + 0.1)
        B = jnp.asarray(rng.random((n, n), dtype=np.float32) + 0.1)
        mv = add_matvec(scale_matvec(low_rank_matvec(U, V), 0.25), lambda x: B @ x)
        x = jnp.asarray(rng.random(n, dtype=np.float32))
        want = 0.25 * (np.asarray(U) @ (np.asarray(V).T @ np.asarray(x))) + (
            np.asarray(B) @ np.asarray(x)
        )
        np.testing.assert_allclose(np.asarray(mv(x)), want, rtol=1e-5, atol=1e-6)

    def test_combinator_validation(self):
        from eigen_value.ops.structured import add_matvec, scale_matvec

        with pytest.raises(ValueError, match="at least one"):
            add_matvec()
        with pytest.raises(ValueError, match="alpha"):
            scale_matvec(lambda x: x, 0.0)

    def test_scale_scales_lambda_exactly(self, rng):
        """λ(α·A) = α·λ(A) with the eigenvector unchanged — the documented
        normalization contract of scale_matvec."""
        from eigen_value.ops.structured import scale_matvec

        n = 64
        A = jnp.asarray(rng.random((n, n), dtype=np.float32) + 0.1)
        base = max_eigenvalue_operator(lambda x: A @ x, n)
        scaled = max_eigenvalue_operator(scale_matvec(lambda x: A @ x, 4.0), n)
        assert float(scaled.eigenvalue) == pytest.approx(
            4.0 * float(base.eigenvalue), rel=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(scaled.eigenvector),
            np.asarray(base.eigenvector),
            rtol=1e-4,
            atol=1e-5,
        )

    def test_pagerank_operator_lambda_is_one(self, rng):
        """Sparse link matrix + rank-one teleportation (the PageRank
        Google matrix) solved matrix-free: a column-stochastic matrix has
        λ_max = 1 exactly — a free oracle for the composed operator."""
        from eigen_value.ops.structured import (
            add_matvec,
            ell_from_coo,
            ell_matvec,
            low_rank_matvec,
        )

        n, d, alpha = 200, 4, 0.85
        src = np.repeat(np.arange(n), d)
        dst = (src + 1 + rng.integers(0, n - 1, size=src.shape)) % n
        cols, vals = ell_from_coo(dst, src, np.full(len(src), alpha / d, np.float32), n)
        ones = jnp.ones((n, 1), jnp.float32)
        google = add_matvec(
            ell_matvec(cols, vals), low_rank_matvec(ones * ((1 - alpha) / n), ones)
        )
        res = max_eigenvalue_operator(google, n)
        assert bool(res.converged)
        assert float(res.eigenvalue) == pytest.approx(1.0, abs=2e-3)

    def test_ell_ragged_degrees_match_dense(self, rng):
        """Variable row degrees (1..12 nonzeros per row plus diagonal)
        exercise the ELL padding: padded slots contribute exactly 0."""
        from eigen_value.ops.structured import ell_from_coo, ell_matvec

        n = 80
        rows_l, cols_l, vals_l = [], [], []
        for i in range(n):
            deg = int(rng.integers(1, 13))
            cs = (i + 1 + rng.integers(0, n - 1, size=deg)) % n
            rows_l += [i] * deg
            cols_l += list(cs)
            vals_l += list(rng.random(deg) + 0.1)
        rows_a = np.concatenate([np.array(rows_l), np.arange(n)])
        cols_a = np.concatenate([np.array(cols_l), np.arange(n)])
        vals_a = np.concatenate(
            [np.array(vals_l, np.float32), np.ones(n, np.float32)]
        )
        A = self._dense(rows_a, cols_a, vals_a, n)
        mv = ell_matvec(*ell_from_coo(rows_a, cols_a, vals_a, n))
        x = jnp.asarray(rng.random(n, dtype=np.float32))
        np.testing.assert_allclose(
            np.asarray(mv(x)), A @ np.asarray(x), rtol=1e-5, atol=1e-6
        )
        got = max_eigenvalue_operator(mv, n)
        want = max_eigenvalue(jnp.asarray(A))
        assert bool(got.converged)
        assert float(got.eigenvalue) == pytest.approx(
            float(want.eigenvalue), rel=1e-4
        )
