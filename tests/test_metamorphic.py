"""Metamorphic properties of the Perron eigenpair — invariances that hold
regardless of the iteration's internals, checked through the public API."""

import numpy as np
import pytest

from eigen_value import max_eigenvalue

N = 160  # deliberately not a power of two


@pytest.fixture
def mat(rng):
    return rng.random((N, N), dtype=np.float32) + np.float32(1e-3)


def _solve(m):
    res = max_eigenvalue(m)
    assert bool(res.converged)
    v = np.asarray(res.eigenvector)
    return float(res.eigenvalue), v / v.max()  # fix normalization for compares


def test_scaling_equivariance(mat):
    """λ(cA) = c·λ(A); the eigenvector is unchanged."""
    lam, v = _solve(mat)
    for c in (0.25, 3.0):
        lam_c, v_c = _solve(np.float32(c) * mat)
        assert lam_c == pytest.approx(c * lam, rel=1e-3)
        np.testing.assert_allclose(v_c, v, atol=1e-2)


def test_permutation_equivariance(mat, rng):
    """λ(PAPᵀ) = λ(A); v(PAPᵀ) = P·v(A)."""
    perm = rng.permutation(N)
    P = np.eye(N, dtype=np.float32)[perm]
    lam, v = _solve(mat)
    lam_p, v_p = _solve(P @ mat @ P.T)
    assert lam_p == pytest.approx(lam, rel=1e-3)
    np.testing.assert_allclose(v_p, v[perm], atol=1e-2)


def test_transpose_invariance(mat):
    """A and Aᵀ share the Perron eigenvalue (spectra coincide)."""
    lam, _ = _solve(mat)
    lam_t, _ = _solve(np.ascontiguousarray(mat.T))
    assert lam_t == pytest.approx(lam, rel=1e-3)


def test_diagonal_similarity_invariance(mat, rng):
    """λ(D⁻¹AD) = λ(A) for positive diagonal D — the method's own update is
    built on exactly this invariance, so it must hold through the API."""
    d = (rng.random(N, dtype=np.float32) + 0.5).astype(np.float32)
    sim = (mat / d[:, None]) * d[None, :]
    lam, _ = _solve(mat)
    lam_s, _ = _solve(sim)
    assert lam_s == pytest.approx(lam, rel=1e-3)


def test_spectral_bounds(mat):
    """min row sum ≤ λ ≤ max row sum (Perron–Frobenius bounds)."""
    lam, _ = _solve(mat)
    sums = mat.sum(axis=1)
    assert sums.min() - 1e-3 <= lam <= sums.max() + 1e-3


def test_symmetric_declaration_is_path_invisible(rng):
    """On a symmetric matrix, SolverConfig(symmetric=True) — the
    triangle/cached kernels — must agree with the default dense path
    (λ within reduction-order tolerance, same normalized eigenvector):
    the declaration picks a faster route, never a different answer."""
    from eigen_value import SolverConfig

    n = 256  # sym-tileable (the triangle kernel needs a 128-mult tile)
    a = rng.random((n, n), dtype=np.float32) + np.float32(1e-3)
    m = np.float32((a + a.T) / 2)
    lam, v = _solve(m)
    res = max_eigenvalue(m, config=SolverConfig(symmetric=True))
    assert bool(res.converged)
    vs = np.asarray(res.eigenvector)
    assert float(res.eigenvalue) == pytest.approx(lam, rel=1e-3)
    np.testing.assert_allclose(vs / vs.max(), v, atol=1e-2)
