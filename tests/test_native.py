"""Native C++ library tests: build, C-ABI shape, parity with the NumPy
oracle and the reference anchors."""

import numpy as np
import pytest

from eigen_value import native
from eigen_value.reference_impl import parallel_oracle

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


@pytest.fixture(scope="module")
def solver():
    return native.NativeEigenValue()


def _hilbert(n):
    r = np.arange(n)[:, None]
    c = np.arange(n)[None, :]
    return (1.0 / (r + c + 1)).astype(np.float32)


def test_3x3_anchor(solver):
    mat = np.array([[1, 1, 2], [2, 1, 3], [2, 3, 5]], dtype=np.float32)
    lam, vec, ms, rounds = solver.similarity_transform(mat)
    assert abs(lam - 7.5311) < 1e-3
    for got, want in zip(vec, (0.3941, 0.5788, 0.9975)):
        assert abs(got - want) < 1e-3


@pytest.mark.parametrize("n,rounds", [(128, 9), (256, 10), (512, 12), (1024, 13)])
def test_hilbert_round_parity(solver, n, rounds):
    lam, vec, ms, got_rounds = solver.similarity_transform(_hilbert(n))
    assert got_rounds == rounds


def test_matches_numpy_oracle(solver, rng):
    mat = rng.random((256, 256), dtype=np.float32) + np.float32(1e-4)
    lam, vec, ms, rounds = solver.similarity_transform(mat)
    want = parallel_oracle(mat)
    assert rounds == want.rounds
    assert abs(lam - want.eigenvalue) < 1e-3
    np.testing.assert_allclose(vec, want.eigenvector, atol=1e-4)


def test_eigen_pair_property(solver, rng):
    mat = rng.random((512, 512), dtype=np.float32) + np.float32(1e-4)
    lam, vec, ms, rounds = solver.similarity_transform(mat)
    assert np.allclose(mat @ vec, lam * vec, atol=1e-3)


def test_input_not_mutated(solver):
    mat = _hilbert(64)
    orig = mat.copy()
    solver.similarity_transform(mat)
    np.testing.assert_array_equal(mat, orig)


@pytest.mark.parametrize("n,rounds", [(128, 9), (512, 12)])
def test_matvec_form_round_parity(solver, n, rounds):
    lam, vec, ms, got_rounds = solver.similarity_transform(
        _hilbert(n), matvec_form=True
    )
    assert got_rounds == rounds
    lam_it, _, _, _ = solver.similarity_transform(_hilbert(n))
    assert abs(lam - lam_it) < 1e-3


def test_matvec_form_eigen_pair(solver, rng):
    mat = rng.random((256, 256), dtype=np.float32) + np.float32(1e-4)
    lam, vec, ms, rounds = solver.similarity_transform(mat, matvec_form=True)
    assert np.allclose(mat @ vec, lam * vec, atol=1e-3)


def test_bench_kernel_us(solver):
    for name in ("row_sums", "find_max", "eigvec", "stop", "next_matrix", "matvec"):
        us = solver.bench_kernel_us(name, 256, reps=2)
        assert us > 0
    with pytest.raises(ValueError, match="unknown"):
        solver.bench_kernel_us("bogus", 256)


def test_cli_driver_builds_and_reports():
    """The native `run` binary (reference ./run analog) builds AND runs a
    small sweep with correct round counts in the report."""
    import subprocess

    out = subprocess.run(
        ["make", "-C", str(native._NATIVE_DIR), "run"],
        capture_output=True,
        text=True,
    )
    assert out.returncode == 0, out.stderr[-2000:]

    run = subprocess.run(
        [str(native._NATIVE_DIR / "run"), "8", "17"],  # dims ≤256, vecs ≤2^17
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert run.returncode == 0, run.stderr[-2000:]
    assert "Similarity Transform (native C++ iterated form)" in run.stdout
    assert "Similarity Transform (native C++ matvec form)" in run.stdout
    # both solver forms must report the reference round counts
    assert run.stdout.count("9 round(s)") == 2
    assert run.stdout.count("10 round(s)") == 2
    for kernel in ("row_sums", "next_matrix", "matvec", "find_max", "stop"):
        assert kernel in run.stdout
