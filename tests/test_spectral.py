"""Spectral diagnostics (`ops/spectral`): operator residual, convergence-rate
report from the traced λ history, float64 host-side refinement.

The reference's only outputs are (λ, v, ms, rounds)
(wrapper/python/similarity_transform.py:42-78); these tests pin the extra
observability/accuracy surface this build adds on top.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from eigen_value import fixtures, max_eigenvalue
from eigen_value.config import EPS, MAX_ITR
from eigen_value.ops.solver_matvec import solve_matvec_traced
from eigen_value.ops.spectral import (
    convergence_report,
    operator_residual,
    power_eigenpair,
    refine_eigenpair,
    subdominant_eigenpair,
)


def test_operator_residual_matches_dense_definition():
    """operator_residual == max |A·v − λ·v| computed by hand (the wrapper
    test's acceptance check, reference wrapper/python/test.py:15-16)."""
    n = 256
    H = fixtures.hilbert_matrix(n)
    res = max_eigenvalue(H)
    got = float(operator_residual(lambda x: H @ x, res))
    want = float(
        np.max(
            np.abs(
                np.asarray(H) @ np.asarray(res.eigenvector)
                - float(res.eigenvalue) * np.asarray(res.eigenvector)
            )
        )
    )
    assert got == pytest.approx(want, rel=1e-6)
    assert got < 1e-2  # converged solve ⇒ small residual


def test_convergence_report_estimates_subdominant_ratio():
    """The delta-ratio estimate recovers |λ₂/λ₁| on a symmetric positive
    matrix with a known (numpy) spectrum."""
    n = 64
    H = fixtures.hilbert_matrix(n)
    # tight eps → a long geometric tail for the estimator to average
    res, hist = solve_matvec_traced(H, 1e-6, 200)
    assert bool(res.converged)
    rep = convergence_report(np.asarray(hist), int(res.rounds))
    w = np.sort(np.abs(np.linalg.eigvalsh(np.asarray(H, np.float64))))
    ratio = float(w[-2] / w[-1])
    assert rep.deltas_used >= 2
    assert rep.rate == pytest.approx(ratio, rel=0.25)
    assert rep.digits_per_round == pytest.approx(-np.log10(rep.rate))
    # the λ-error estimate should bound the actual remaining error's order
    lam_true = float(w[-1] * 0 + np.max(np.linalg.eigvalsh(np.asarray(H, np.float64))))
    actual_err = abs(float(res.eigenvalue) - lam_true)
    assert rep.lam_error_estimate == pytest.approx(actual_err, abs=10 * actual_err + 1e-6)


def test_convergence_report_short_history_is_nan():
    rep = convergence_report([2.0, 2.1], 1)
    assert np.isnan(rep.rate) and rep.deltas_used == 0


def test_convergence_report_roundoff_floor_excluded():
    """Deltas at f32 round-off scale must not pollute the rate estimate:
    a history that converges then sits flat gives the same answer as the
    clean prefix."""
    hist = [4.0, 3.0, 2.5, 2.25, 2.125, 2.0625]
    pad = hist + [hist[-1]] * 10  # flat tail = zero deltas (below floor)
    a = convergence_report(hist, len(hist) - 1)
    b = convergence_report(pad, len(pad) - 1)
    assert a.rate == pytest.approx(0.5, rel=1e-6)
    assert b.rate == pytest.approx(a.rate, rel=1e-6)


def test_convergence_report_f64_history_keeps_deep_tail():
    """The round-off floor scales with the HISTORY's dtype: an f64 history
    whose geometric tail sits below the f32 floor (|Δ| ~ 1e-6·λ) but well
    above f64 round-off still yields a rate, instead of rate=NaN from an
    all-excluded tail."""
    lam, r = 2.0, 0.5
    # deltas span 1e-7·λ … 1e-11·λ — every one below 100·f32eps·λ ≈ 2.4e-5·λ
    hist = np.array([lam - 2e-7 * r**k for k in range(15)], np.float64)
    rep = convergence_report(hist, len(hist) - 1)
    assert rep.deltas_used >= 2
    assert rep.rate == pytest.approx(r, rel=1e-3)
    # the same values with no dtype information assume f32 origin → NaN
    rep32 = convergence_report(list(hist), len(hist) - 1)
    assert np.isnan(rep32.rate)


class TestRefineEigenpair:
    def test_hilbert_refines_to_f64(self):
        """f32 solve + host f64 polish reaches oracle-grade accuracy: λ
        matches numpy's f64 eigensolver far beyond the f32 stop tolerance."""
        n = 512
        H = fixtures.hilbert_matrix(n)
        res = max_eigenvalue(H)
        A64 = np.asarray(H, np.float64)
        ref = refine_eigenpair(A64, res)
        lam_true = float(np.max(np.linalg.eigvalsh(A64)))
        coarse_err = abs(float(res.eigenvalue) - lam_true)
        fine_err = abs(ref.eigenvalue - lam_true)
        assert fine_err < 1e-10 * lam_true
        assert fine_err < coarse_err  # strictly better than the f32 readout
        assert ref.residual < 1e-11
        assert ref.spread < 1e-9
        assert float(np.max(ref.eigenvector)) == pytest.approx(1.0)

    def test_matrix_free_matvec(self):
        """A callable f64 matvec works in place of the dense matrix."""
        n = 128
        H = fixtures.hilbert_matrix(n)
        A64 = np.asarray(H, np.float64)
        res = max_eigenvalue(H)
        dense = refine_eigenpair(A64, res)
        mfree = refine_eigenpair(lambda x: A64 @ x, res)
        assert mfree.eigenvalue == pytest.approx(dense.eigenvalue, rel=1e-13)
        assert mfree.residual < 1e-11

    def test_rejects_nonpositive_seed(self):
        res = max_eigenvalue(fixtures.hilbert_matrix(64))
        bad = res._replace(eigenvector=jnp.zeros(64) - 1.0)
        with pytest.raises(ValueError, match="finite and positive"):
            refine_eigenpair(np.eye(64) + 1.0, bad)

    def test_reports_rounds_and_stops(self):
        """Stops at the round-off floor well under max_rounds and reports
        the count actually run."""
        n = 256
        H = fixtures.hilbert_matrix(n)
        res = max_eigenvalue(H)
        ref = refine_eigenpair(np.asarray(H, np.float64), res, max_rounds=50)
        assert 1 <= ref.rounds < 50


def test_operator_traced_matches_dense_traced():
    """solve_operator_traced with a dense-backed matvec is bit-identical
    to solve_matvec_traced (same loop body by construction)."""
    import jax

    from eigen_value.ops.solver_matvec import solve_operator_traced

    n = 128
    H = fixtures.hilbert_matrix(n)
    want, want_hist = solve_matvec_traced(H, EPS, MAX_ITR)
    got, got_hist = jax.jit(
        lambda A: solve_operator_traced(lambda x: A @ x, n, EPS, MAX_ITR)
    )(H)
    assert int(got.rounds) == int(want.rounds)
    assert float(got.eigenvalue) == float(want.eigenvalue)
    np.testing.assert_array_equal(np.asarray(got_hist), np.asarray(want_hist))


def test_operator_traced_rate_matches_dense_rate():
    """The convergence-rate estimate through the FFT Hankel operator
    agrees with the dense solver's (same matrix, same asymptote)."""
    from eigen_value.ops.solver_matvec import solve_operator_traced
    from eigen_value.ops.structured import hilbert_matvec

    n = 64
    res_d, hist_d = solve_matvec_traced(fixtures.hilbert_matrix(n), 1e-6, 200)
    res_o, hist_o = solve_operator_traced(hilbert_matvec(n), n, 1e-6, 200)
    rep_d = convergence_report(np.asarray(hist_d), int(res_d.rounds))
    rep_o = convergence_report(np.asarray(hist_o), int(res_o.rounds))
    assert rep_o.rate == pytest.approx(rep_d.rate, rel=0.15)


def test_convergence_report_alternating_subdominant():
    """A NEGATIVE λ₂ alternates the delta signs; |λ₂/λ₁| must still be
    recovered.  Construction: 11ᵀ − 0.45·ssᵀ (s = alternating signs) has
    entries in {0.55, 1.45} > 0 and spectrum {n, −0.45n, 0, …}; a
    positive-diagonal similarity D·A·D⁻¹ keeps entries positive and the
    spectrum exact while moving the Perron vector off the all-ones start
    (otherwise the solve converges instantly and leaves no tail)."""
    n = 16
    s = np.array([(-1.0) ** i for i in range(n)])
    A = np.ones((n, n)) - 0.45 * np.outer(s, s)
    d = 1.0 + 0.3 * np.arange(n) / n
    B = (np.diag(d) @ A @ np.diag(1.0 / d)).astype(np.float32)
    assert (B > 0).all()
    res, hist = solve_matvec_traced(jnp.asarray(B), 1e-6, 200)
    assert bool(res.converged)
    rep = convergence_report(np.asarray(hist), int(res.rounds))
    assert rep.deltas_used >= 2
    assert rep.rate == pytest.approx(0.45, rel=0.05)


class TestPowerEigenpair:
    """General (indefinite-operator) power iteration — the engine behind
    Hotelling deflation; no reference analog (positive matrices only)."""

    def test_recovers_dominant_pair_of_random_symmetric(self):
        rng = np.random.default_rng(7)
        M = rng.standard_normal((48, 48))
        S = ((M + M.T) / 2).astype(np.float32)
        A = jnp.asarray(S)
        res = power_eigenpair(lambda x: A @ x, 48, eps=1e-6, max_itr=5000)
        w, V = np.linalg.eigh(S.astype(np.float64))
        k = int(np.argmax(np.abs(w)))
        assert bool(res.converged)
        assert float(res.eigenvalue) == pytest.approx(w[k], rel=1e-4)
        v = np.asarray(res.eigenvector, np.float64)
        # eigenvector up to sign
        assert abs(float(v @ V[:, k])) == pytest.approx(1.0, abs=1e-3)

    def test_negative_dominant_eigenvalue(self):
        """λ < 0 alternates the iterate's sign; the Rayleigh quotient and
        the residual stop are sign-blind."""
        S = np.diag([-3.0, 2.0, 1.0]).astype(np.float32)
        A = jnp.asarray(S)
        res = power_eigenpair(lambda x: A @ x, 3, eps=1e-6, max_itr=2000)
        assert bool(res.converged)
        assert float(res.eigenvalue) == pytest.approx(-3.0, rel=1e-5)

    def test_cap_exhaustion_reports_unconverged(self):
        S = np.diag([1.0, 0.999, 0.5]).astype(np.float32)  # near-tied pair
        A = jnp.asarray(S)
        res = power_eigenpair(lambda x: A @ x, 3, eps=1e-12, max_itr=5)
        assert not bool(res.converged)
        assert int(res.rounds) == 5

    def test_jit_composable(self):
        import jax

        S = jnp.asarray(np.diag([4.0, 1.0]).astype(np.float32))

        @jax.jit
        def run(A):
            return power_eigenpair(lambda x: A @ x, 2, eps=1e-6, max_itr=100)

        res = run(S)
        assert float(res.eigenvalue) == pytest.approx(4.0, rel=1e-5)


class TestSubdominantEigenpair:
    def test_hilbert_matches_numpy_spectrum(self):
        """λ₂ of Hilbert 64² from deflation matches eigvalsh, and the
        measured ratio cross-validates convergence_report's estimate."""
        n = 64
        H = fixtures.hilbert_matrix(n)
        res, hist = solve_matvec_traced(H, 1e-6, 200)
        assert bool(res.converged)
        sub = subdominant_eigenpair(np.asarray(H), res)
        w = np.sort(np.linalg.eigvalsh(np.asarray(H, np.float64)))
        assert sub.converged
        assert sub.eigenvalue == pytest.approx(w[-2], rel=1e-3)
        assert sub.ratio == pytest.approx(abs(w[-2] / w[-1]), rel=1e-3)
        # the residual is through the ORIGINAL A, not the deflated operator
        assert sub.residual <= 1e-3 * abs(w[-1])
        rep = convergence_report(np.asarray(hist), int(res.rounds))
        assert rep.rate == pytest.approx(sub.ratio, rel=0.25)

    def test_unrefined_pair_still_close(self):
        """refine=False bounds λ₂ accuracy at the dominant pair's residual
        (~eps·λ₁) — still a usable gap measurement from a 1e-3 solve."""
        n = 32
        H = fixtures.hilbert_matrix(n)
        res = max_eigenvalue(H)
        sub = subdominant_eigenpair(np.asarray(H), res, refine=False)
        w = np.sort(np.linalg.eigvalsh(np.asarray(H, np.float64)))
        assert sub.eigenvalue == pytest.approx(w[-2], rel=5e-2)

    def test_rejects_nonsymmetric(self):
        A = np.array([[1.0, 2.0], [0.0, 1.0]])
        res = max_eigenvalue(fixtures.hilbert_matrix(2))
        with pytest.raises(ValueError, match="SYMMETRIC"):
            subdominant_eigenpair(A, res)

    def test_accepts_refined_pair_without_repolishing(self):
        """A RefinedPair seed is used as-is (callers who already polished
        the dominant pair pay the f64 host work once) and gives the same
        λ₂ as the internally-refined path."""
        n = 48
        H = fixtures.hilbert_matrix(n)
        res = max_eigenvalue(H)
        A64 = np.asarray(H, np.float64)
        ref = refine_eigenpair(A64, res)
        via_pair = subdominant_eigenpair(A64, ref)
        via_solve = subdominant_eigenpair(A64, res)
        assert via_pair.eigenvalue == pytest.approx(
            via_solve.eigenvalue, rel=1e-6
        )


class TestTopKEigenpairs:
    def test_hilbert_top4_matches_numpy(self):
        from eigen_value.ops.spectral import top_k_eigenpairs

        n = 64
        H = fixtures.hilbert_matrix(n)
        res = max_eigenvalue(H)
        top = top_k_eigenpairs(np.asarray(H), res, k=4)
        w = np.sort(np.linalg.eigvalsh(np.asarray(H, np.float64)))[::-1]
        assert np.all(top.converged)
        # Hilbert is PSD: |λ| order == signed order
        np.testing.assert_allclose(top.eigenvalues, w[:4], rtol=1e-3)
        np.testing.assert_allclose(
            top.ratios, np.abs(w[:4]) / w[0], rtol=1e-3
        )
        # pairwise orthonormal columns (the deflation's working assumption)
        G = top.eigenvectors.astype(np.float64)
        np.testing.assert_allclose(G.T @ G, np.eye(4), atol=2e-3)
        assert np.all(top.residuals <= 1e-3 * w[0])

    def test_k1_is_the_refined_dominant(self):
        from eigen_value.ops.spectral import top_k_eigenpairs

        n = 32
        H = fixtures.hilbert_matrix(n)
        res = max_eigenvalue(H)
        top = top_k_eigenpairs(np.asarray(H), res, k=1)
        ref = refine_eigenpair(np.asarray(H, np.float64), res)
        assert top.eigenvalues[0] == pytest.approx(ref.eigenvalue, rel=1e-10)
        assert top.ratios[0] == 1.0

    def test_k2_matches_subdominant(self):
        from eigen_value.ops.spectral import top_k_eigenpairs

        n = 48
        H = fixtures.hilbert_matrix(n)
        res = max_eigenvalue(H)
        top = top_k_eigenpairs(np.asarray(H), res, k=2)
        sub = subdominant_eigenpair(np.asarray(H), res)
        assert top.eigenvalues[1] == pytest.approx(sub.eigenvalue, rel=1e-3)

    def test_validates_inputs(self):
        from eigen_value.ops.spectral import top_k_eigenpairs

        res = max_eigenvalue(fixtures.hilbert_matrix(4))
        with pytest.raises(ValueError, match="k >= 1"):
            top_k_eigenpairs(np.eye(4), res, k=0)
        with pytest.raises(ValueError, match="exceeds the dimension"):
            top_k_eigenpairs(np.eye(4), res, k=5)

    def test_power_eigenpair_vmaps_over_operator_batch(self):
        """while_loop-based power iteration composes with vmap (a batch of
        gap measurements in one compiled program)."""
        import jax

        diags = jnp.asarray(
            np.array([[5.0, 1.0, 0.5], [3.0, -1.0, 0.2]], np.float32)
        )

        def solve(d):
            return power_eigenpair(
                lambda x: d * x, 3, eps=1e-6, max_itr=500
            ).eigenvalue

        lams = jax.vmap(solve)(diags)
        np.testing.assert_allclose(np.asarray(lams), [5.0, 3.0], rtol=1e-5)
