"""Hardware tests on the card: Hilbert parity 128²–8192², the λ tolerance
against the float64 oracle, and each kept kernel against the plain
reference.  Every test takes the ``gpu`` fixture, which skips without a
GPU; on a machine with one:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu_hw.py
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eigen_value import EigenValue, SolverConfig, fixtures, max_eigenvalue
from eigen_value.ops.pallas import kernels
from eigen_value.ops.solver_matvec import dot_f32, solve_matvec, solve_multiround
from eigen_value.reference_impl import parallel_oracle

pytestmark = pytest.mark.gpu

DIMS = sorted(fixtures.HILBERT_ROUNDS)  # 128 … 8192


def _hilbert64(n):
    r = np.arange(n, dtype=np.float64)
    return 1.0 / (r[:, None] + r[None, :] + 1.0)


def _on(gpu, n, dtype=jnp.float32):
    return jax.device_put(fixtures.hilbert_matrix(n, dtype), gpu)


@pytest.mark.parametrize("n", DIMS)
def test_hilbert_round_parity_and_lambda(gpu, n):
    """The default route on the card: the reference's round counts, λ
    within 1e-4 relative of the float64 oracle (f32 summation of n terms
    is ~1e-6 off; a wrong round moves λ ~1e-4), residual ≤ 1e-3 at
    Precision.HIGHEST (the reference wrapper test's bound)."""
    H = _on(gpu, n)
    res = max_eigenvalue(H)
    assert res.eigenvalue.devices() == {gpu}
    assert int(res.rounds) == fixtures.HILBERT_ROUNDS[n]
    ref = parallel_oracle(_hilbert64(n), dtype=np.float64)
    assert float(res.eigenvalue) == pytest.approx(ref.eigenvalue, rel=1e-4)
    v = res.eigenvector
    assert float(jnp.max(jnp.abs(dot_f32(H, v) - res.eigenvalue * v))) <= 1e-3


@pytest.mark.parametrize("n", [1000, 8192])
def test_symv_matches_dense_on_card(gpu, n):
    """The compiled kernel against XLA's f32 product: summation order
    only (≤1e-5 relative); repeated calls are bit-identical (no atomics);
    the lower triangle is never read."""
    m = np.random.default_rng(n).random((n, n), np.float32) + 0.1
    A = jax.device_put(jnp.asarray((m + m.T) / 2), gpu)
    x = jax.device_put(jnp.ones((n,), jnp.float32), gpu)
    want = np.asarray(dot_f32(A, x), np.float64)
    got = np.asarray(kernels.symv(A, x))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(kernels.symv(A, x)), got)
    poisoned = jnp.where(jnp.tril(jnp.ones((n, n), bool), -1), jnp.nan, A)
    np.testing.assert_array_equal(np.asarray(kernels.symv(poisoned, x)), got)


@pytest.mark.parametrize("n", [128, 1024, 8192])
def test_symmetric_solve_parity(gpu, n):
    """Declared-symmetric solves take the kernel on the card (auto) and
    keep the parity table and the λ tolerance."""
    H = _on(gpu, n)
    res = max_eigenvalue(H, SolverConfig(symmetric=True))
    assert int(res.rounds) == fixtures.HILBERT_ROUNDS[n]
    want = solve_matvec(H, 1e-3, 1000)
    assert float(res.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)


def test_validate_promotes_on_card(gpu):
    """validate=True on the card routes a bitwise-symmetric matrix to the
    kernel, which then solves with parity; a matrix whose symmetry is
    declared but broken is refused."""
    H = _on(gpu, 2048)
    res = max_eigenvalue(H, validate=True)
    assert int(res.rounds) == fixtures.HILBERT_ROUNDS[2048]
    broken = H.at[5, 3].multiply(2.0)
    with pytest.raises(ValueError, match="not bitwise symmetric"):
        max_eigenvalue(broken, SolverConfig(symmetric=True), validate=True)


def test_multiround_matches_per_round_loop(gpu):
    """The chunked loop on the card: same rounds and λ as the per-round
    loop (same product, frozen state after the stop)."""
    H = _on(gpu, 4096)
    a = solve_matvec(H, 1e-3, 1000)
    b = solve_multiround(H, 1e-3, 1000, chunk=16)
    assert int(a.rounds) == int(b.rounds) == fixtures.HILBERT_ROUNDS[4096]
    assert float(b.eigenvalue) == pytest.approx(float(a.eigenvalue), rel=1e-6)


def test_bf16_storage_on_card(gpu):
    """bf16 storage: ±1 round, λ within 2e-3 relative of the f32 solve."""
    H = _on(gpu, 8192)
    f32 = max_eigenvalue(H)
    bf = max_eigenvalue(H, SolverConfig(storage_dtype=jnp.bfloat16))
    assert bool(bf.converged)
    assert abs(int(bf.rounds) - fixtures.HILBERT_ROUNDS[8192]) <= 1
    assert float(bf.eigenvalue) == pytest.approx(float(f32.eigenvalue), rel=2e-3)


def test_class_api_on_card(gpu):
    lam, vec, ts_ms, rounds = EigenValue(device=gpu).similarity_transform(
        fixtures.hilbert_matrix(1024)
    )
    assert rounds == fixtures.HILBERT_ROUNDS[1024]
    assert ts_ms > 0.0
