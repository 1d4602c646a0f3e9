"""Differential fuzzing: every backend against the NumPy oracle on many
random positive matrices, including adversarial shapes the reference never
exercised (near-rank-1, wide dynamic range, near-uniform)."""

import numpy as np
import pytest

import jax.numpy as jnp

from eigen_value.ops.solver import solve_xla
from eigen_value.ops.solver_matvec import solve_matvec, solve_multiround
from eigen_value.reference_impl import parallel_oracle

EPS = 1e-3
MAX_ITR = 1000

def _stepped(A):
    """One round per dispatch through the checkpoint state."""
    from eigen_value import checkpoint

    st = checkpoint.init_state(A)
    while not bool(st.done) and int(st.rounds) < MAX_ITR:
        st = checkpoint.step(st, 7, EPS, MAX_ITR)
    return checkpoint.to_result(st)


BACKENDS = {
    "xla": lambda A: solve_xla(A, EPS, MAX_ITR),
    "multiround": lambda A: solve_multiround(A, EPS, MAX_ITR, chunk=5),
    "matvec": lambda A: solve_matvec(A, EPS, MAX_ITR),
    "checkpointed": _stepped,
}


def _cases(rng, n=128, count=8):
    for _ in range(count):
        yield "uniform", rng.random((n, n), dtype=np.float32) + 1e-4
    for _ in range(3):
        # near-rank-1: dominant eigenvalue ≈ |u||w|, converges in 1-2 rounds
        u = rng.random(n, dtype=np.float32) + 0.1
        w = rng.random(n, dtype=np.float32) + 0.1
        yield "rank1ish", np.float32(np.outer(u, w) + 1e-3 * rng.random((n, n)))
    for _ in range(3):
        # wide dynamic range: entries spanning 1e-4 .. 1e2
        yield "wide", np.float32(
            10.0 ** rng.uniform(-4, 2, size=(n, n))
        )
    # near-uniform: row sums almost equal from the start
    yield "uniformish", np.float32(1.0 + 1e-4 * rng.random((n, n)))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_differential_vs_oracle(backend, rng):
    solve = BACKENDS[backend]
    for kind, mat in _cases(rng):
        want = parallel_oracle(mat)
        got = solve(jnp.asarray(mat))
        tol = 1e-3 * max(want.eigenvalue, 1.0)
        assert bool(got.converged) == want.converged, (backend, kind)
        assert int(got.rounds) == want.rounds, (
            backend,
            kind,
            int(got.rounds),
            want.rounds,
        )
        assert abs(float(got.eigenvalue) - want.eigenvalue) < tol, (backend, kind)
        v = np.asarray(got.eigenvector)
        assert np.allclose(
            mat @ v, float(got.eigenvalue) * v, atol=5 * tol
        ), (backend, kind)


class TestShardedDifferentialFuzz:
    """Round-2: the sharded solvers fuzzed against the single-chip matvec
    solver across random matrix families, dims, and mesh sizes — catches
    sharding bugs (offset slips, reduction-order drift, replication
    mistakes) that fixed-dim tests can miss."""

    @pytest.mark.parametrize("solver_name", ["gather", "ring", "iterated"])
    def test_matches_single_chip(self, solver_name, rng):
        import jax
        from jax.sharding import Mesh

        from eigen_value.parallel import (
            solve_sharded,
            solve_sharded_matvec,
            solve_sharded_matvec_ring,
        )

        solver = {
            "gather": solve_sharded_matvec,
            "ring": solve_sharded_matvec_ring,
            "iterated": solve_sharded,
        }[solver_name]
        single = {
            "gather": solve_matvec,
            "ring": solve_matvec,
            "iterated": solve_xla,
        }[solver_name]

        for n, p in ((64, 2), (96, 4), (128, 8), (160, 2)):
            mesh = Mesh(np.array(jax.devices("cpu")[:p]), ("rows",))
            # one case per family (uniform / rank1ish / wide /
            # uniformish) so every matrix family really is fuzzed
            seen = set()
            cases = [
                (k, m)
                for k, m in _cases(rng, n=n, count=2)
                if not (k in seen or seen.add(k))
            ]
            for kind, mat in cases:
                want = single(jnp.asarray(mat), EPS, MAX_ITR)
                got = solver(jnp.asarray(mat), mesh)
                assert int(got.rounds) == int(want.rounds), (
                    solver_name, n, p, kind,
                )
                assert float(got.eigenvalue) == pytest.approx(
                    float(want.eigenvalue), rel=1e-5
                ), (solver_name, n, p, kind)
                assert bool(got.converged) == bool(want.converged)

    def test_2d_matches_single_chip(self, rng):
        """2D block sharding vs single chip.  The psum along cols changes
        the float32 row-sum reduction grouping, so the round contract is
        ±1 (not bit parity); λ and the eigen-pair property must hold to
        the method's eps either way."""
        from eigen_value.parallel import make_mesh2d, solve_sharded_2d

        for n, (pr, pc) in ((64, (2, 2)), (96, (2, 4)), (128, (4, 2)), (160, (1, 8))):
            mesh = make_mesh2d(pr, pc)
            seen = set()
            cases = [
                (k, m)
                for k, m in _cases(rng, n=n, count=2)
                if not (k in seen or seen.add(k))
            ]
            for kind, mat in cases:
                want = solve_matvec(jnp.asarray(mat), EPS, MAX_ITR)
                got = solve_sharded_2d(jnp.asarray(mat), mesh)
                assert abs(int(got.rounds) - int(want.rounds)) <= 1, (
                    n, pr, pc, kind,
                )
                assert bool(got.converged)
                v = np.asarray(got.eigenvector)
                lam = float(got.eigenvalue)
                assert np.allclose(mat @ v, lam * v, atol=2e-3), (n, pr, pc, kind)


def test_differential_multiround_vs_oracle(rng):
    """The multiround family (dense product, and the upper-triangle
    kernel interpreted) against the oracle on random SYMMETRIZED positive
    matrices (the kernel requires the symv contract; symmetrizing keeps
    every entry positive).  256² is 4×4 tiles of the kernel."""
    n = 256
    backends = {
        "multiround": dict(),
        "sym": dict(symmetric=True, interpret=True),
    }
    for kind, mat in _cases(rng, n=n, count=4):
        sym = np.float32((mat + mat.T) / 2)
        want = parallel_oracle(sym)
        for name, kw in backends.items():
            got = solve_multiround(jnp.asarray(sym), EPS, MAX_ITR, chunk=6, **kw)
            tol = 1e-3 * max(want.eigenvalue, 1.0)
            assert bool(got.converged) == want.converged, (name, kind)
            assert int(got.rounds) == want.rounds, (
                name, kind, int(got.rounds), want.rounds,
            )
            assert abs(float(got.eigenvalue) - want.eigenvalue) < tol, (
                name, kind,
            )
