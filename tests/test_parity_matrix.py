"""Oracle-anchored parity matrix: every remaining backend on the Hilbert
family against the float64 parallel-semantics oracle, and on random
positive matrices against numpy's dense eigensolver."""

import numpy as np
import pytest

import jax.numpy as jnp

from eigen_value import SolverConfig, checkpoint, fixtures, max_eigenvalue
from eigen_value.reference_impl import parallel_oracle


def _stepped(A, cfg):
    st = checkpoint.init_state(jnp.asarray(A, jnp.float32))
    while not bool(st.done) and int(st.rounds) < cfg.max_itr:
        st = checkpoint.step(st, 5, cfg.eps, cfg.max_itr)
    return checkpoint.to_result(st)


#: backend → (solve(A, cfg), rounds slack vs the table, λ relative tolerance)
#: f32 paths stop at the oracle's round: λ agrees to f32 rounding (1e-5);
#: bf16 storage quantizes A to ~3 digits: ±1 round, λ within 2e-3.
BACKENDS = {
    "xla": (lambda A, c: max_eigenvalue(A, SolverConfig(backend="xla", **c)), 0, 1e-5),
    "matvec": (lambda A, c: max_eigenvalue(A, SolverConfig(backend="matvec", **c)), 0, 1e-5),
    "multiround": (
        lambda A, c: max_eigenvalue(A, SolverConfig(backend="multiround", **c)), 0, 1e-5
    ),
    "checkpointed": (lambda A, c: _stepped(A, SolverConfig(**c)), 0, 1e-5),
    "symmetric": (
        lambda A, c: max_eigenvalue(
            A, SolverConfig(backend="matvec", symmetric=True, interpret=True, **c)
        ),
        0,
        1e-5,
    ),
    "bf16_storage": (
        lambda A, c: max_eigenvalue(A, SolverConfig(storage_dtype=jnp.bfloat16, **c)),
        1,
        2e-3,
    ),
}


@pytest.mark.parametrize("n", [128, 256, 512, 1024])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_hilbert_vs_f64_oracle(backend, n):
    solve, slack, rel = BACKENDS[backend]
    r = np.arange(n, dtype=np.float64)
    ref = parallel_oracle(1.0 / (r[:, None] + r[None, :] + 1.0), dtype=np.float64)
    assert ref.rounds == fixtures.HILBERT_ROUNDS[n]
    got = solve(fixtures.hilbert_matrix(n), {})
    assert bool(got.converged), backend
    assert abs(int(got.rounds) - ref.rounds) <= slack, (backend, int(got.rounds))
    assert float(got.eigenvalue) == pytest.approx(ref.eigenvalue, rel=rel), backend


@pytest.mark.parametrize("n", [3, 100, 257, 1000])
@pytest.mark.parametrize("backend", ["xla", "matvec", "multiround"])
def test_random_positive_vs_numpy(backend, n, rng):
    """λ ≈ n/2 here, past the absolute stop's reach at large n, so these
    run the scale-invariant relative stop (tol = 1e-3·max v): λ then lies
    between the converged row sums, within 1e-3 relative of the true
    dominant eigenvalue."""
    solve, _, _ = BACKENDS[backend]
    A = rng.random((n, n), dtype=np.float32) + np.float32(0.05)
    want = float(np.max(np.linalg.eigvals(A.astype(np.float64)).real))
    got = solve(jnp.asarray(A), {"eps_mode": "relative"})
    assert bool(got.converged), backend
    assert float(got.eigenvalue) == pytest.approx(want, rel=1e-3), backend
    v = np.asarray(got.eigenvector, np.float64)
    lam = float(got.eigenvalue)
    assert np.max(np.abs(A @ v - lam * v)) <= 2e-3 * lam * np.max(np.abs(v))
