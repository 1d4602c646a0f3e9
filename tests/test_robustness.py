"""Robustness battery: awkward dims, dtypes, and inputs through the
public API — every odd, prime, or power-of-two-misaligned dim must solve
cleanly and still satisfy A·v = λ·v."""

import numpy as np
import pytest

import jax.numpy as jnp

from eigen_value import EigenValue, max_eigenvalue

AWKWARD_DIMS = [2, 3, 5, 17, 33, 100, 127, 129, 200, 255, 257, 384, 500, 640]


@pytest.mark.parametrize("n", AWKWARD_DIMS)
def test_awkward_dims_eigen_pair(rng, n):
    mat = rng.random((n, n), dtype=np.float32) + 1e-2
    res = max_eigenvalue(mat)
    assert bool(res.converged)
    v = np.asarray(res.eigenvector)
    lam = float(res.eigenvalue)
    assert np.allclose(mat @ v, lam * v, atol=1e-2), f"eigen-pair broken at n={n}"


def test_n_equals_1():
    res = max_eigenvalue(np.array([[4.0]], dtype=np.float32))
    assert float(res.eigenvalue) == pytest.approx(4.0)
    # a constant-row-sum 1x1 matrix converges at round 0 (stop check
    # passes before any update — the reference's 0-based counting)
    assert int(res.rounds) == 0 and bool(res.converged)


def test_float64_input_is_cast(rng):
    mat = rng.random((64, 64)) + 1e-2  # float64 numpy
    res = max_eigenvalue(mat)
    assert res.eigenvalue.dtype == jnp.float32


def test_nonsquare_raises(rng):
    with pytest.raises(ValueError, match="square"):
        max_eigenvalue(rng.random((4, 5), dtype=np.float32))
    with pytest.raises(ValueError, match="square"):
        max_eigenvalue(rng.random((4,), dtype=np.float32))


def test_validate_rejects_nonpositive(rng):
    mat = rng.random((8, 8), dtype=np.float32) + 1e-2
    mat[3, 4] = 0.0
    with pytest.raises(ValueError, match="entries > 0"):
        max_eigenvalue(mat, validate=True)


def test_noncontiguous_input(rng):
    big = rng.random((128, 256), dtype=np.float32) + 1e-2
    mat = big[:, ::2]  # non-contiguous 128×128 view
    assert not mat.flags["C_CONTIGUOUS"]
    res = max_eigenvalue(mat)
    v = np.asarray(res.eigenvector)
    assert np.allclose(np.ascontiguousarray(mat) @ v, float(res.eigenvalue) * v, atol=1e-3)


def test_class_api_int_input_rejected_gracefully(rng):
    ev = EigenValue()
    mat = (rng.random((32, 32)) * 10 + 1).astype(np.int32)
    lam, v, _, _ = ev.similarity_transform(mat)  # cast to f32 internally
    assert np.allclose(mat.astype(np.float32) @ v, lam * v, atol=1e-2)
