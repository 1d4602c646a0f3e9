"""The round body's passes in their XLA form — the reference-structure
oracle (ops/solver.py): row sums, the similarity update, the fused
update + row sums, the wraparound stop, and the iterated solve built from
them, each checked against plain NumPy."""

import numpy as np
import pytest

import jax.numpy as jnp

from eigen_value import fixtures
from eigen_value.ops.solver import rowsum_xla, scale_rowsum_xla, solve_xla, stop_check
from eigen_value.ops.solver_matvec import solve_matvec

EPS = 1e-3
MAX_ITR = 1000


def _scale_np(A, v):
    """The reference kernel's reciprocal-then-multiply update
    (similarity_transform.cpp:324-325) in float32 NumPy."""
    one = np.float32(1.0)
    return A * ((one / v)[:, None] * v[None, :])


def _stop_np(v, eps):
    return bool(np.all(np.abs(v - np.roll(v, -1)) < np.float32(eps)))


class TestRowsum:
    def test_identity(self):
        # reference analog: row sums of identity are exactly 1 (tests/test.cpp:22-30)
        v = rowsum_xla(fixtures.identity_matrix(256))
        assert (np.asarray(v) == 1.0).all()

    @pytest.mark.parametrize("n", [128, 512])
    def test_matches_jnp(self, n, rng):
        A = rng.random((n, n), dtype=np.float32)
        got = np.asarray(rowsum_xla(jnp.asarray(A)))
        np.testing.assert_allclose(got, A.astype(np.float64).sum(axis=1), rtol=1e-6)

    def test_multi_column_block_accumulation(self, rng):
        # a dim that is no power of two
        A = rng.random((1000, 1000), dtype=np.float32)
        got = np.asarray(rowsum_xla(jnp.asarray(A)))
        np.testing.assert_allclose(got, A.astype(np.float64).sum(axis=1), rtol=1e-6)


class TestScale:
    @pytest.mark.parametrize("n", [128, 256])
    def test_matches_jnp(self, n, rng):
        A = rng.random((n, n), dtype=np.float32) + 0.1
        v = rng.random(n, dtype=np.float32) + 0.5
        got, _ = scale_rowsum_xla(jnp.asarray(A), jnp.asarray(v))
        np.testing.assert_array_equal(np.asarray(got), _scale_np(A, v))


class TestScaleRowsum:
    @pytest.mark.parametrize("n", [128, 512])
    def test_matches_separate_passes(self, n, rng):
        A = rng.random((n, n), dtype=np.float32) + 0.1
        v = rng.random(n, dtype=np.float32) + 0.5
        A2, v2 = scale_rowsum_xla(jnp.asarray(A), jnp.asarray(v))
        A2_want = _scale_np(A, v)
        np.testing.assert_array_equal(np.asarray(A2), A2_want)
        np.testing.assert_allclose(
            np.asarray(v2), A2_want.astype(np.float64).sum(axis=1), rtol=1e-6
        )


class TestStopKernel:
    def test_reference_fixtures(self):
        # the reference's stop success/fail fixture pair (tests/test.cpp:56-73)
        assert bool(stop_check(fixtures.stop_success_vector(4096), 1e-3))
        assert not bool(stop_check(fixtures.stop_fail_vector(4096), 1e-3))

    @pytest.mark.parametrize("idx", [0, 255, 256, 4095, 2048 + 7])
    def test_single_break_detected(self, idx):
        v = np.full(4096, 1.0, np.float32)
        v[idx] = 2.0
        assert not bool(stop_check(jnp.asarray(v), 1e-3))

    def test_rows_not_divisible_by_block_rows(self):
        # a length with no power-of-two factor beyond 4: the fused slices
        # must still pair every element with its wraparound neighbour
        v = fixtures.stop_fail_vector(12 * 257)
        assert bool(stop_check(v, 1e-3)) == _stop_np(np.asarray(v), 1e-3)
        assert bool(stop_check(fixtures.stop_success_vector(12 * 257), 1e-3))

    def test_fuzz_matches_stop_check(self, rng):
        for i in range(10):
            v = rng.random(2048, dtype=np.float32) * (0.2 if i % 2 else 1.0)
            assert bool(stop_check(jnp.asarray(v), 0.5)) == _stop_np(v, 0.5)


class TestSolvePallas:
    @pytest.mark.parametrize("n", [128, 256, 512])
    def test_hilbert_round_parity(self, n):
        res = solve_xla(fixtures.hilbert_matrix(n), EPS, MAX_ITR)
        assert bool(res.converged)
        assert int(res.rounds) == fixtures.HILBERT_ROUNDS[n]

    def test_matches_xla_solver(self, rng):
        """The iterated form and the matvec form are the same iteration
        in exact arithmetic (solver_matvec module docstring)."""
        mat = jnp.asarray(rng.random((256, 256), dtype=np.float32) + 1e-4)
        got = solve_xla(mat, EPS, MAX_ITR)
        want = solve_matvec(mat, EPS, MAX_ITR)
        assert int(got.rounds) == int(want.rounds)
        assert abs(float(got.eigenvalue) - float(want.eigenvalue)) < 1e-3
        np.testing.assert_allclose(
            np.asarray(got.eigenvector), np.asarray(want.eigenvector), atol=1e-4
        )

    def test_eigen_pair_property(self, rng):
        mat = rng.random((256, 256), dtype=np.float32)
        res = solve_xla(jnp.asarray(mat), EPS, MAX_ITR)
        v = np.asarray(res.eigenvector)
        assert np.allclose(mat @ v, float(res.eigenvalue) * v, atol=1e-3)
