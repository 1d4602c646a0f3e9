"""Edge-dimension coverage: non-power-of-2, non-128-aligned, and tiny dims
routed through the auto backend (the reference only ever ran powers of 2)."""

import numpy as np
import pytest

from eigen_value import EigenValue, max_eigenvalue
from eigen_value.reference_impl import parallel_oracle


@pytest.mark.parametrize("n", [1, 2, 3, 7, 96, 100, 192, 300, 384])
def test_auto_backend_any_dim(n, rng):
    mat = rng.random((n, n), dtype=np.float32) + np.float32(1e-3)
    res = max_eigenvalue(mat)
    assert bool(res.converged)
    v = np.asarray(res.eigenvector)
    lam = float(res.eigenvalue)
    assert np.allclose(mat @ v, lam * v, atol=1e-3 * max(lam, 1.0))


@pytest.mark.parametrize("n", [7, 100, 300])
def test_matches_oracle_at_odd_dims(n, rng):
    mat = rng.random((n, n), dtype=np.float32) + np.float32(1e-3)
    got = max_eigenvalue(mat)
    want = parallel_oracle(mat)
    assert int(got.rounds) == want.rounds
    assert abs(float(got.eigenvalue) - want.eigenvalue) < 1e-3 * max(want.eigenvalue, 1.0)


def test_class_api_odd_dim(rng):
    mat = rng.random((100, 100), dtype=np.float32) + np.float32(1e-3)
    lam, vec, ms, rounds = EigenValue().similarity_transform(mat)
    assert vec.shape == (100,)
    assert np.allclose(mat @ vec, lam * vec, atol=1e-3)
