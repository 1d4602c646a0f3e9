"""Oracle tests: pin the reference semantics before anything device-shaped.

Anchors come straight from the reference (tests/test.cpp:79-104,
main.py:52-58, README round tables) — see SURVEY.md §0/§4.
"""

import numpy as np
import pytest

from eigen_value.reference_impl import parallel_oracle, sequential_oracle

EPS = 1e-3

ANCHOR = np.array([[1.0, 1.0, 2.0], [2.0, 1.0, 3.0], [2.0, 3.0, 5.0]])
ANCHOR_VAL = 7.5311
ANCHOR_VEC = (0.3941, 0.5788, 0.9975)


def _hilbert(n, dtype=np.float32):
    r = np.arange(n)[:, None]
    c = np.arange(n)[None, :]
    return (1.0 / (r + c + 1)).astype(dtype)


class TestSequentialOracle:
    def test_3x3_anchor(self):
        res = sequential_oracle(ANCHOR)
        assert abs(res.eigenvalue - ANCHOR_VAL) < EPS
        for got, want in zip(res.eigenvector, ANCHOR_VEC):
            assert abs(got - want) < EPS

    def test_vs_numpy_eig(self, rng):
        mat = rng.random((128, 128))
        res = sequential_oracle(mat)
        lam_np = np.max(np.real(np.linalg.eigvals(mat)))
        assert abs(res.eigenvalue - lam_np) < EPS
        # eigen-pair property
        assert np.allclose(mat @ res.eigenvector, res.eigenvalue * res.eigenvector, atol=1e-2)


class TestParallelOracle:
    def test_3x3_anchor(self):
        res = parallel_oracle(ANCHOR)
        assert res.converged
        assert abs(res.eigenvalue - ANCHOR_VAL) < EPS
        for got, want in zip(res.eigenvector, ANCHOR_VEC):
            assert abs(got - want) < EPS

    @pytest.mark.parametrize("n,rounds", [(128, 9), (256, 10), (512, 12), (1024, 13)])
    def test_hilbert_round_parity(self, n, rounds):
        """Primary parity target: README round counts, identical on all 6
        reference machines (BASELINE.md)."""
        res = parallel_oracle(_hilbert(n))
        assert res.converged
        assert res.rounds == rounds

    def test_eigen_pair_property(self, rng):
        mat = rng.random((256, 256)).astype(np.float32) + 1e-4
        res = parallel_oracle(mat)
        assert res.converged
        assert np.allclose(
            mat @ res.eigenvector, res.eigenvalue * res.eigenvector, atol=1e-3
        )

    def test_round_counting_is_zero_based(self):
        """A matrix whose row sums are already equal converges at round 0
        (the reference breaks before any update, iter_count = i = 0)."""
        mat = np.full((8, 8), 0.25, dtype=np.float32)
        res = parallel_oracle(mat)
        assert res.converged and res.rounds == 0
        assert abs(res.eigenvalue - 2.0) < EPS

    def test_cap_exhaustion(self):
        """With max_itr=0 the loop body never runs: not converged, λ=0."""
        res = parallel_oracle(_hilbert(64), max_itr=0)
        assert not res.converged and res.rounds == 0
        assert res.eigenvalue == 0.0  # the documented cap-exhaustion λ
