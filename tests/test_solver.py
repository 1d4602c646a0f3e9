"""Single-chip XLA solver tests: anchors, parity vs the parallel oracle,
eigen-pair property, cap semantics."""

import numpy as np
import pytest

import jax.numpy as jnp

from eigen_value import fixtures
from eigen_value.ops.solver import solve_xla
from eigen_value.reference_impl import parallel_oracle

EPS = 1e-3
MAX_ITR = 1000


def test_3x3_anchor():
    res = solve_xla(jnp.asarray(fixtures.ANCHOR_3X3, jnp.float32), EPS, MAX_ITR)
    assert bool(res.converged)
    assert abs(float(res.eigenvalue) - fixtures.ANCHOR_3X3_EIGENVALUE) < EPS
    for got, want in zip(np.asarray(res.eigenvector), fixtures.ANCHOR_3X3_EIGENVECTOR):
        assert abs(got - want) < EPS


@pytest.mark.parametrize("n", [128, 256, 512, 1024])
def test_hilbert_round_parity(n):
    res = solve_xla(fixtures.hilbert_matrix(n), EPS, MAX_ITR)
    assert bool(res.converged)
    assert int(res.rounds) == fixtures.HILBERT_ROUNDS[n]


@pytest.mark.parametrize("n", [128, 512])
def test_matches_parallel_oracle(n, rng):
    mat = rng.random((n, n), dtype=np.float32) + np.float32(1e-4)
    got = solve_xla(jnp.asarray(mat), EPS, MAX_ITR)
    want = parallel_oracle(mat)
    assert bool(got.converged) == want.converged
    assert int(got.rounds) == want.rounds
    assert abs(float(got.eigenvalue) - want.eigenvalue) < EPS
    np.testing.assert_allclose(
        np.asarray(got.eigenvector), want.eigenvector, atol=1e-4
    )


def test_eigen_pair_property(rng):
    # the wrapper test's Av = λv assertion (wrapper/python/test.py:15-16)
    mat = rng.random((1024, 1024), dtype=np.float32)
    res = solve_xla(jnp.asarray(mat), EPS, MAX_ITR)
    assert bool(res.converged)
    v = np.asarray(res.eigenvector)
    lam = float(res.eigenvalue)
    assert np.allclose(mat @ v, lam * v, atol=1e-3)


def test_already_converged_at_round_zero():
    mat = jnp.full((8, 8), 0.25, dtype=jnp.float32)
    res = solve_xla(mat, EPS, MAX_ITR)
    assert bool(res.converged) and int(res.rounds) == 0
    assert abs(float(res.eigenvalue) - 2.0) < EPS


def test_cap_exhaustion_semantics():
    # cap smaller than rounds-to-convergence: rounds == cap, converged False,
    # λ is the last checked v[0] (matches parallel_oracle)
    H = fixtures.hilbert_matrix(128)
    got = solve_xla(H, EPS, 3)
    want = parallel_oracle(np.asarray(H), max_itr=3)
    assert not bool(got.converged) and int(got.rounds) == 3
    assert abs(float(got.eigenvalue) - want.eigenvalue) < 1e-4


def test_eigenvector_max_component_is_one():
    # normalization is implicit: final ev has max element ~1 (SURVEY.md §0)
    res = solve_xla(fixtures.hilbert_matrix(256), EPS, MAX_ITR)
    assert abs(float(jnp.max(res.eigenvector)) - 1.0) < 1e-2


class TestRelativeStop:
    """eps_mode='relative' (VERDICT r2 item 3): scale-invariant stop for
    large-λ inputs, absolute mode untouched as the reference-exact
    default."""

    def test_config_validates_eps_mode(self):
        from eigen_value import SolverConfig

        assert SolverConfig(eps_mode="relative").eps_mode == "relative"
        with pytest.raises(ValueError, match="eps_mode"):
            SolverConfig(eps_mode="rel")

    def test_stop_check_relative_semantics(self):
        from eigen_value.ops.solver import stop_check

        v = jnp.asarray([1000.0, 1000.4, 1000.2], jnp.float32)
        assert not bool(stop_check(v, 1e-3))  # absolute: 0.4 > 1e-3
        assert bool(stop_check(v, 1e-3, "relative"))  # 0.4 < 1e-3·1000
        with pytest.raises(ValueError, match="eps_mode"):
            stop_check(v, 1e-3, "bogus")

    def test_relative_mode_is_scale_invariant(self, rng):
        """Scaling A by α scales every row sum by α: relative mode must
        give the SAME rounds at any scale, where absolute mode's rounds
        drift with α (that drift is the reference's semantics, kept as
        the default)."""
        from eigen_value.ops.solver_matvec import solve_matvec

        A = jnp.asarray(rng.random((128, 128), dtype=np.float32) + 0.1)
        r1 = solve_matvec(A, EPS, MAX_ITR, eps_mode="relative")
        r2 = solve_matvec(A * 1024.0, EPS, MAX_ITR, eps_mode="relative")
        assert bool(r1.converged) and bool(r2.converged)
        assert int(r1.rounds) == int(r2.rounds)
        assert float(r2.eigenvalue) == pytest.approx(
            1024.0 * float(r1.eigenvalue), rel=1e-5
        )

    def test_large_lambda_operator_needs_relative(self, rng):
        """The round-2 silicon failure mode, reproduced on CPU: at
        λ ~ 10⁶ the f32 matvec rounding noise (~λ·2⁻²⁴·n) exceeds the
        absolute eps=1e-3 so the stop never fires; relative mode
        converges and the eigen-pair is correct."""
        from eigen_value import SolverConfig, max_eigenvalue_operator

        n = 256
        A = rng.random((n, n), dtype=np.float32) + np.float32(0.1)
        Aj = jnp.asarray(A) * jnp.float32(1e6)
        mv = lambda x: Aj @ x  # noqa: E731

        res_abs = max_eigenvalue_operator(mv, n, SolverConfig(max_itr=200))
        assert not bool(res_abs.converged)  # cap exhaustion — the bug class

        res_rel = max_eigenvalue_operator(
            mv, n, SolverConfig(max_itr=200, eps_mode="relative")
        )
        assert bool(res_rel.converged)
        lam_np = 1e6 * np.max(np.real(np.linalg.eigvals(A.astype(np.float64))))
        assert float(res_rel.eigenvalue) == pytest.approx(lam_np, rel=1e-3)

    def test_parity_dims_unchanged_by_default(self):
        """The default config's rounds are the parity table's — adding
        eps_mode must not perturb the absolute path (guards accidental
        default flips)."""
        from eigen_value import SolverConfig, max_eigenvalue

        res = max_eigenvalue(fixtures.hilbert_matrix(256), SolverConfig())
        assert int(res.rounds) == fixtures.HILBERT_ROUNDS[256]

    def test_mesh_path_honors_relative(self, rng):
        """Round 4 closes VERDICT r3 item 6: the mesh path used to reject
        eps_mode='relative'; a large-λ matrix that needs multi-chip
        memory now has a sound stop.  Absolute mode cap-exhausts on the
        same input (λ ≈ 1e6·n/2 ⇒ f32 row-sum noise ≫ eps)."""
        from eigen_value import SolverConfig, max_eigenvalue
        from eigen_value.parallel.sharded import make_row_mesh

        A = jnp.asarray(rng.random((128, 128), dtype=np.float32) + 0.1)
        A = A * jnp.float32(1e6)
        mesh = make_row_mesh(4)
        res_abs = max_eigenvalue(A, SolverConfig(max_itr=50), mesh=mesh)
        assert not bool(res_abs.converged)  # the failure class, sharded
        res = max_eigenvalue(
            A, SolverConfig(max_itr=200, eps_mode="relative"), mesh=mesh
        )
        assert bool(res.converged)
        ref = max_eigenvalue(A, SolverConfig(max_itr=200, eps_mode="relative"))
        assert int(res.rounds) == int(ref.rounds)
        assert float(res.eigenvalue) == pytest.approx(
            float(ref.eigenvalue), rel=1e-5
        )


def test_f64_end_to_end(rng):
    """f64 solve under x64 mode (VERDICT r1 item 8): the config guard's
    happy path.  Rounds must match the f64 parallel oracle exactly; λ must
    agree with the reference's own f64 path (sequential main.py:63) and
    with numpy's eigensolver to stop-tolerance accuracy."""
    import jax

    from eigen_value import SolverConfig, max_eigenvalue
    from eigen_value.reference_impl import parallel_oracle, sequential_oracle

    mat = rng.random((96, 96)) + 0.1  # float64 numpy
    with jax.enable_x64():
        cfg = SolverConfig(dtype=jnp.float64)
        res = max_eigenvalue(jnp.asarray(mat), cfg)
        assert res.eigenvalue.dtype == jnp.float64
        assert bool(res.converged)

        want = parallel_oracle(mat, dtype=np.float64)
        assert int(res.rounds) == want.rounds
        assert float(res.eigenvalue) == pytest.approx(want.eigenvalue, rel=1e-12)

        seq = sequential_oracle(mat)
        assert float(res.eigenvalue) == pytest.approx(seq.eigenvalue, abs=2e-3)
        lam_np = np.max(np.real(np.linalg.eigvals(mat)))
        assert float(res.eigenvalue) == pytest.approx(lam_np, abs=2e-3)
