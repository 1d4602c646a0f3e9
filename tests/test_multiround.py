"""The multi-round loop (solve_multiround): rounds run in fixed-trip
chunks with a freeze once the stop fires, and the chunking must be
BIT-EXACT with the per-round loop given the same product.

On a GPU a while loop reads its predicate back to the host every trip;
the chunked loop reads it once per chunk.  These tests pin the
equivalence on the CPU; tests/test_gpu_hw.py re-pins round parity on the
card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eigen_value import fixtures
from eigen_value.config import EPS, MAX_ITR
from eigen_value.ops.solver_matvec import (
    solve_matvec,
    solve_matvec_symmetric,
    solve_multiround,
)
from eigen_value.reference_impl import parallel_oracle


def _assert_same(got, want, bitexact=True):
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    if bitexact:
        assert float(got.eigenvalue) == float(want.eigenvalue)
        np.testing.assert_array_equal(
            np.asarray(got.eigenvector), np.asarray(want.eigenvector)
        )
    else:
        assert float(got.eigenvalue) == pytest.approx(
            float(want.eigenvalue), rel=1e-5
        )


@pytest.mark.parametrize("n", [128, 256, 512])
def test_vpu_bitexact_vs_production(n):
    """The same round with the same dense product: results must be
    bit-identical to solve_matvec — eigenvector included."""
    H = fixtures.hilbert_matrix(n)
    want = solve_matvec(H, EPS, MAX_ITR)
    got = solve_multiround(H, EPS, MAX_ITR, chunk=18)
    _assert_same(got, want, bitexact=True)


@pytest.mark.parametrize("chunk", [1, 2, 3, 5, 7, 16, 40])
def test_chunk_boundaries_are_invisible(chunk):
    """Any chunking of the round sequence must give the same rounds, λ,
    and eigenvector — the freeze-at-convergence semantics."""
    H = fixtures.hilbert_matrix(256)
    want = solve_matvec(H, EPS, MAX_ITR)
    got = solve_multiround(H, EPS, MAX_ITR, chunk=chunk)
    _assert_same(got, want, bitexact=True)


def test_dot_formulation_round_parity():
    """With the symmetric kernel as its product (interpreted here) the
    chunked loop is bit-identical to the per-round symmetric solve, and
    meets the parity table."""
    for n in (128, 256):
        H = fixtures.hilbert_matrix(n)
        got = solve_multiround(
            H, EPS, MAX_ITR, chunk=12, symmetric=True, interpret=True
        )
        assert int(got.rounds) == fixtures.HILBERT_ROUNDS[n]
        want = solve_matvec_symmetric(H, EPS, MAX_ITR, interpret=True)
        _assert_same(got, want, bitexact=True)


@pytest.mark.parametrize("cap", [0, 1, 3, 9, 10, 11])
def test_cap_exhaustion_matches_production(cap):
    """rounds == cap, converged False, λ = last CHECKED round's v[0] —
    including caps that land mid-chunk and exactly at a chunk edge."""
    H = fixtures.hilbert_matrix(256)
    want = solve_matvec(H, EPS, cap)
    got = solve_multiround(H, EPS, cap, chunk=4)
    _assert_same(got, want, bitexact=True)


def test_round_zero_convergence():
    M = jnp.full((128, 128), 0.25, jnp.float32)
    got = solve_multiround(M, EPS, MAX_ITR, chunk=4)
    assert bool(got.converged) and int(got.rounds) == 0
    assert float(got.eigenvalue) == pytest.approx(32.0, abs=1e-3)


def test_ev0_threading_is_scale_invariant():
    """The bench chains thread dependence through ev0 — λ and rounds must
    be unchanged (scale invariance of the iteration)."""
    H = fixtures.hilbert_matrix(128)
    base = solve_multiround(H, EPS, MAX_ITR, chunk=10)
    ev0 = jnp.ones((128,), jnp.float32) * jnp.float32(1.0)
    got = solve_multiround(H, EPS, MAX_ITR, chunk=10, ev0=ev0)
    assert int(got.rounds) == int(base.rounds)
    assert float(got.eigenvalue) == float(base.eigenvalue)


def test_relative_eps_mode():
    """eps_mode='relative' in the chunked loop matches the per-round
    relative-stop solver."""
    A = jnp.asarray(
        np.random.default_rng(7).random((128, 128), np.float32) + 0.1
    ) * jnp.float32(1e5)
    want = solve_matvec(A, EPS, MAX_ITR, eps_mode="relative")
    got = solve_multiround(A, EPS, MAX_ITR, chunk=8, eps_mode="relative")
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged)
    assert float(got.eigenvalue) == pytest.approx(
        float(want.eigenvalue), rel=1e-5
    )


def test_unaligned_dim_picks_divisor_stripe():
    """n = 96: no tiling constraint of any kind — bit-identical to the
    per-round loop."""
    H = fixtures.hilbert_matrix(96)
    want = solve_matvec(H, EPS, MAX_ITR)
    got = solve_multiround(H, EPS, MAX_ITR, chunk=8)
    _assert_same(got, want, bitexact=True)


def test_tiny_unalignable_dim_raises():
    """The 3×3 cross-implementation anchor (tests/test.cpp:79-104) solves
    through the chunked loop too."""
    got = solve_multiround(
        jnp.asarray(fixtures.ANCHOR_3X3, jnp.float32), EPS, MAX_ITR, chunk=4
    )
    assert bool(got.converged)
    assert float(got.eigenvalue) == pytest.approx(
        fixtures.ANCHOR_3X3_EIGENVALUE, abs=1e-4
    )


def test_config_backend_multiround():
    """The 'multiround' backend is reachable through the public config
    (SolverConfig(backend="multiround", chunk=...) → max_eigenvalue)."""
    from eigen_value import SolverConfig, max_eigenvalue

    H = fixtures.hilbert_matrix(256)
    res = max_eigenvalue(H, SolverConfig(backend="multiround", chunk=11))
    assert int(res.rounds) == fixtures.HILBERT_ROUNDS[256]
    assert bool(res.converged)
    with pytest.raises(ValueError, match="chunk"):
        SolverConfig(backend="multiround", chunk=0)


@pytest.mark.parametrize("n", [128, 256, 512])
def test_multiround_bf16_storage(n):
    """storage_dtype composes with multiround: bf16 matrix, f32 state.
    Anchored on the oracle, not on a sibling solver: rounds within ±1 of
    the parity table and λ within 2e-3 relative of the float64
    parallel-semantics oracle (bf16 quantizes A to ~3 digits)."""
    from eigen_value import SolverConfig, max_eigenvalue

    H = fixtures.hilbert_matrix(n)
    ref = parallel_oracle(np.asarray(H), dtype=np.float64)
    got = max_eigenvalue(
        H,
        SolverConfig(backend="multiround", chunk=12, storage_dtype=jnp.bfloat16),
    )
    assert bool(got.converged)
    assert abs(int(got.rounds) - fixtures.HILBERT_ROUNDS[n]) <= 1
    assert float(got.eigenvalue) == pytest.approx(ref.eigenvalue, rel=2e-3)
    assert got.eigenvalue.dtype == jnp.float32  # state stays f32


def test_batched_and_large_suite_row_schemas():
    """The batched suite rung emits self-describing rows (CPU smoke)."""
    from eigen_value.bench.suite import bench_batched

    (r,) = bench_batched(batch=4, dim=64, reps=2, chain=3)
    for key in (
        "solves_per_s",
        "rounds_hist",
        "all_converged",
        "max_rel_residual",
        "rounds_ok",
    ):
        assert key in r, key
    assert r["all_converged"] and r["rounds_ok"]


def test_jittable_and_composes():
    H = fixtures.hilbert_matrix(128)
    res = jax.jit(
        lambda A: solve_multiround(A, EPS, MAX_ITR, chunk=10)
    )(H)
    assert int(res.rounds) == fixtures.HILBERT_ROUNDS[128]
