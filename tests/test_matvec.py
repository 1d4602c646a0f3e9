"""Matvec (power-form) solver tests: the algebraic identity
v_k = (A₀·ev_k)/ev_k must reproduce the iterated solver's results —
round counts, eigenvalue, eigenvector — on all fixtures."""

import numpy as np
import pytest

import jax.numpy as jnp

from eigen_value import fixtures
from eigen_value.ops.solver import solve_xla
from eigen_value.ops.solver_matvec import (
    solve_matvec,
    solve_matvec_storage,
    storage_matvec,
)
from eigen_value.reference_impl import parallel_oracle

EPS = 1e-3
MAX_ITR = 1000


class TestMatvecKernel:
    @pytest.mark.parametrize("shape", [(128, 128), (256, 512)])
    def test_matches_jnp(self, shape, rng):
        """The storage product: bf16 entries widened exactly and multiplied
        by the UNQUANTIZED f32 vector, summed in f32."""
        Aq = jnp.asarray(rng.random(shape, dtype=np.float32)).astype(jnp.bfloat16)
        x = rng.random(shape[1], dtype=np.float32) + 0.5
        got = np.asarray(storage_matvec(Aq, jnp.asarray(x)))
        want = np.asarray(Aq.astype(jnp.float32), np.float64) @ x.astype(np.float64)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6)


class TestSolveMatvec:
    @pytest.mark.parametrize("n", [128, 256, 512, 1024])
    def test_hilbert_round_parity(self, n):
        res = solve_matvec(fixtures.hilbert_matrix(n), EPS, MAX_ITR)
        assert bool(res.converged)
        assert int(res.rounds) == fixtures.HILBERT_ROUNDS[n]

    def test_3x3_anchor(self):
        res = solve_matvec(jnp.asarray(fixtures.ANCHOR_3X3, jnp.float32), EPS, MAX_ITR)
        assert abs(float(res.eigenvalue) - fixtures.ANCHOR_3X3_EIGENVALUE) < EPS
        for got, want in zip(
            np.asarray(res.eigenvector), fixtures.ANCHOR_3X3_EIGENVECTOR
        ):
            assert abs(got - want) < EPS

    @pytest.mark.parametrize("n", [128, 256])
    def test_matches_iterated_solver(self, n, rng):
        mat = jnp.asarray(rng.random((n, n), dtype=np.float32) + 1e-4)
        got = solve_matvec(mat, EPS, MAX_ITR)
        want = solve_xla(mat, EPS, MAX_ITR)
        assert int(got.rounds) == int(want.rounds)
        assert abs(float(got.eigenvalue) - float(want.eigenvalue)) < 1e-4
        np.testing.assert_allclose(
            np.asarray(got.eigenvector), np.asarray(want.eigenvector), atol=1e-4
        )

    def test_matches_parallel_oracle(self, rng):
        mat = rng.random((256, 256), dtype=np.float32) + np.float32(1e-4)
        got = solve_matvec(jnp.asarray(mat), EPS, MAX_ITR)
        want = parallel_oracle(mat)
        assert int(got.rounds) == want.rounds
        assert abs(float(got.eigenvalue) - want.eigenvalue) < EPS

    def test_cap_exhaustion(self):
        res = solve_matvec(fixtures.hilbert_matrix(128), EPS, 3)
        assert not bool(res.converged) and int(res.rounds) == 3


class TestSolveMatvecBf16:
    @pytest.mark.parametrize("n", [128, 512])
    def test_hilbert_converges_near_parity(self, n):
        # bf16 is the opt-in fast mode: strict round parity is NOT part of
        # its contract (quantization shifts the stop crossing by ±1 round
        # depending on platform accumulation order); convergence and a
        # near-reference round count are.
        res = solve_matvec_storage(fixtures.hilbert_matrix(n), EPS, MAX_ITR)
        assert bool(res.converged)
        assert abs(int(res.rounds) - fixtures.HILBERT_ROUNDS[n]) <= 1

    def test_eigenvalue_within_loosened_tolerance(self):
        H = fixtures.hilbert_matrix(256)
        got = solve_matvec_storage(H, EPS, MAX_ITR)
        want = solve_matvec(H, EPS, MAX_ITR)
        assert abs(float(got.eigenvalue) - float(want.eigenvalue)) < 2e-3

    def test_state_stays_float32(self):
        res = solve_matvec_storage(fixtures.hilbert_matrix(128), EPS, MAX_ITR)
        import jax.numpy as jnp
        assert res.eigenvector.dtype == jnp.float32
        assert res.eigenvalue.dtype == jnp.float32

    def test_prequantized_input_matches_cast_path(self):
        """A matrix already in the storage dtype (how 65536²-scale solves
        avoid ever materializing a f32 copy) must give bit-identical
        results to the cast-from-f32 path, with f32 state."""
        H = fixtures.hilbert_matrix(256)
        Hq = H.astype(jnp.bfloat16)  # the exact quantization the cast path does
        a = solve_matvec_storage(H, EPS, MAX_ITR)
        b = solve_matvec_storage(Hq, EPS, MAX_ITR)
        assert b.eigenvector.dtype == jnp.float32
        assert int(a.rounds) == int(b.rounds)
        assert float(a.eigenvalue) == float(b.eigenvalue)
        np.testing.assert_array_equal(
            np.asarray(a.eigenvector), np.asarray(b.eigenvector)
        )

    def test_api_accepts_prequantized(self):
        from eigen_value import SolverConfig, max_eigenvalue

        Hq = fixtures.hilbert_matrix(128, dtype=jnp.bfloat16)
        res = max_eigenvalue(Hq, SolverConfig(storage_dtype=jnp.bfloat16))
        assert bool(res.converged)
        assert res.eigenvalue.dtype == jnp.float32


class TestSolveMatvecPallas:
    """The default route (backend="auto" → dense matvec form)."""

    @pytest.mark.parametrize("n", [128, 512])
    def test_hilbert_round_parity(self, n):
        from eigen_value import max_eigenvalue

        res = max_eigenvalue(fixtures.hilbert_matrix(n))
        assert bool(res.converged)
        assert int(res.rounds) == fixtures.HILBERT_ROUNDS[n]

    def test_eigen_pair_property(self, rng):
        from eigen_value import max_eigenvalue

        mat = rng.random((256, 256), dtype=np.float32)
        res = max_eigenvalue(mat)
        v = np.asarray(res.eigenvector)
        assert np.allclose(mat @ v, float(res.eigenvalue) * v, atol=1e-3)

    @pytest.mark.parametrize("n", [128, 256, 512])
    def test_fused_round_kernel_bitexact(self, n):
        """One round per dispatch (checkpoint.step with 1 round) must be
        bit-exact vs the one-shot while loop."""
        from eigen_value import checkpoint

        H = fixtures.hilbert_matrix(n)
        a = solve_matvec(H, EPS, MAX_ITR)
        st = checkpoint.init_state(H)
        while not bool(st.done) and int(st.rounds) < MAX_ITR:
            st = checkpoint.step(st, 1, EPS, MAX_ITR)
        b = checkpoint.to_result(st)
        assert int(a.rounds) == int(b.rounds) == fixtures.HILBERT_ROUNDS[n]
        assert float(a.eigenvalue) == float(b.eigenvalue)
        np.testing.assert_array_equal(
            np.asarray(a.eigenvector), np.asarray(b.eigenvector)
        )


class TestTracedSolve:
    def test_history_matches_oracle_rounds(self):
        from eigen_value.ops.solver_matvec import solve_matvec_traced
        from eigen_value.reference_impl import parallel_oracle

        H = fixtures.hilbert_matrix(256)
        res, hist = solve_matvec_traced(H, EPS, 50)
        assert int(res.rounds) == fixtures.HILBERT_ROUNDS[256]
        assert hist.shape == (50,)
        # final entries repeat the converged λ
        np.testing.assert_array_equal(
            np.asarray(hist[int(res.rounds):]), float(res.eigenvalue)
        )
        # the recorded per-round λ sequence approaches the oracle value
        # (row sums equalize toward λ)
        want = parallel_oracle(np.asarray(H)).eigenvalue
        errs = np.abs(np.asarray(hist) - want)
        assert errs[int(res.rounds)] < 1e-3
        assert errs[0] > errs[int(res.rounds)]
        # and the INTERIOR entries are the true per-round v[0] sequence:
        # reproduce the matvec recurrence in numpy f32 (reduction order
        # differs from XLA's, hence the tolerance — but a wrong round
        # index or wrong recorded quantity lands far outside it)
        A = np.asarray(H, np.float64)
        pvec = np.ones(A.shape[0], np.float64)
        for k in range(int(res.rounds) + 1):
            v = (A @ pvec) / pvec
            np.testing.assert_allclose(
                float(hist[k]), v[0], rtol=1e-4, err_msg=f"round {k}"
            )
            pvec = pvec * (v / v.max())

    def test_result_matches_untraced(self):
        from eigen_value.ops.solver_matvec import solve_matvec_traced

        H = fixtures.hilbert_matrix(128)
        a = solve_matvec(H, EPS, MAX_ITR)
        b, _ = solve_matvec_traced(H, EPS, 100)
        assert int(a.rounds) == int(b.rounds)
        assert float(a.eigenvalue) == float(b.eigenvalue)
        np.testing.assert_array_equal(
            np.asarray(a.eigenvector), np.asarray(b.eigenvector)
        )


def test_f16_storage_mode():
    """storage_dtype=float16: same bytes as bf16 with ~5x less lambda error
    (more mantissa) — valid when entries stay above f16's normal range
    (see solve_matvec_storage docstring for the underflow caveat)."""
    import jax.numpy as jnp

    from eigen_value.ops.solver_matvec import (
        solve_matvec,
        solve_matvec_storage,
    )

    H = fixtures.hilbert_matrix(1024)
    want = solve_matvec(H, EPS, MAX_ITR)
    f16 = solve_matvec_storage(H, EPS, MAX_ITR, jnp.float16)
    bf16 = solve_matvec_storage(H, EPS, MAX_ITR, jnp.bfloat16)
    assert f16.eigenvalue.dtype == jnp.float32
    assert bool(f16.converged)
    assert abs(int(f16.rounds) - int(want.rounds)) <= 1
    err_f16 = abs(float(f16.eigenvalue) - float(want.eigenvalue))
    err_bf16 = abs(float(bf16.eigenvalue) - float(want.eigenvalue))
    assert err_f16 < 2e-4 * float(want.eigenvalue)
    assert err_f16 < err_bf16  # the mantissa advantage is real
