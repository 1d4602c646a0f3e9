"""Differentiable-eigenvalue tests: gradient vs finite differences and vs
the analytic Perron adjoint."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eigen_value.ops.autodiff import eigenvalue


def test_value_matches_solver(rng):
    m = jnp.asarray(rng.random((32, 32), dtype=np.float32) + 0.1)
    lam = eigenvalue(m)
    lam_np = np.max(np.real(np.linalg.eigvals(np.asarray(m, np.float64))))
    assert abs(float(lam) - lam_np) < 1e-2


def test_grad_matches_finite_differences(rng):
    m = rng.random((8, 8)).astype(np.float32) + 0.5
    m = jnp.asarray(m)
    g = jax.grad(eigenvalue)(m)
    # central finite differences on a few entries
    h = 1e-2
    for (r, c) in [(0, 0), (2, 5), (7, 1)]:
        mp = m.at[r, c].add(h)
        mm = m.at[r, c].add(-h)
        fd = (float(eigenvalue(mp)) - float(eigenvalue(mm))) / (2 * h)
        assert abs(float(g[r, c]) - fd) < 5e-2, (r, c, float(g[r, c]), fd)


def test_grad_rows_sum_structure(rng):
    # for a rank-insensitive sanity check: sum of dλ/dA over all entries
    # equals d/dt λ(A + t·ones) at t=0 — FD check of a directional derivative
    m = jnp.asarray(rng.random((16, 16), dtype=np.float32) + 0.5)
    g = jax.grad(eigenvalue)(m)
    h = 1e-3
    ones = jnp.ones_like(m)
    fd = (float(eigenvalue(m + h * ones)) - float(eigenvalue(m - h * ones))) / (2 * h)
    assert abs(float(jnp.sum(g)) - fd) < 5e-2


def test_jittable(rng):
    m = jnp.asarray(rng.random((16, 16), dtype=np.float32) + 0.5)
    lam = jax.jit(eigenvalue)(m)
    g = jax.jit(jax.grad(eigenvalue))(m)
    assert np.isfinite(float(lam)) and np.isfinite(np.asarray(g)).all()


class TestEigenpair:
    """Eigenvector VJP via the bordered adjoint system."""

    def _setup(self, n=12, seed=3):
        import numpy as np

        rng = np.random.default_rng(seed)
        A = rng.random((n, n)) + 0.1  # float64 under x64
        lam_bar = rng.standard_normal()
        v_bar = rng.standard_normal(n)
        E = rng.standard_normal((n, n))
        return A, lam_bar, v_bar, E

    def test_vjp_matches_finite_differences(self):
        import jax
        import jax.numpy as jnp
        import numpy as np
        enable_x64 = jax.enable_x64

        from eigen_value.ops.autodiff import eigenpair

        with enable_x64():
            A, lam_bar, v_bar, E = self._setup()
            A = jnp.asarray(A)
            E = jnp.asarray(E)
            lam_bar = jnp.asarray(lam_bar)
            v_bar = jnp.asarray(v_bar)

            # tight eps: the VJP is exact at the true eigenpair, so the
            # forward solve must be converged well past the FD step size
            (lam, v), vjp_fn = jax.vjp(lambda M: eigenpair(M, 1e-12, 100000), A)
            (dA,) = vjp_fn((lam_bar, v_bar))
            got = float(jnp.sum(dA * E))

            def g(M):
                l, w = eigenpair(M, 1e-12, 100000)
                return float(lam_bar) * float(l) + float(jnp.dot(v_bar, w))

            h = 1e-7
            fd = (g(A + h * E) - g(A - h * E)) / (2 * h)
            assert got == pytest.approx(fd, rel=1e-4, abs=1e-8)

    def test_reduces_to_eigenvalue_adjoint(self):
        """v̄ = 0 must reproduce the closed-form Perron adjoint."""
        import jax
        import jax.numpy as jnp
        import numpy as np
        enable_x64 = jax.enable_x64

        from eigen_value.ops.autodiff import eigenpair, eigenvalue

        with enable_x64():
            A, _, _, _ = self._setup(seed=5)
            A = jnp.asarray(A)
            _, vjp_fn = jax.vjp(lambda M: eigenpair(M, 1e-12, 100000), A)
            (dA,) = vjp_fn((jnp.asarray(1.0), jnp.zeros(A.shape[0])))
            g_closed = jax.grad(lambda M: eigenvalue(M, 1e-12, 100000))(A)
            np.testing.assert_allclose(
                np.asarray(dA), np.asarray(g_closed), rtol=1e-6, atol=1e-10
            )

    def test_normalization_max_is_one(self):
        import numpy as np

        from eigen_value import fixtures
        from eigen_value.ops.autodiff import eigenpair

        lam, v = eigenpair(fixtures.hilbert_matrix(128))
        assert float(np.asarray(v).max()) == pytest.approx(1.0)
        H = np.asarray(fixtures.hilbert_matrix(128))
        assert np.allclose(H @ np.asarray(v), float(lam) * np.asarray(v), atol=1e-3)

    def test_float32_default_dtype_gradient_is_finite_and_close(self):
        """Regression: the backward GMRES tolerance must be reachable in
        f32 — an unreachable tol spins to the iteration cap and returns
        non-finite garbage."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from eigen_value.ops.autodiff import eigenpair

        rng = np.random.default_rng(7)
        A = jnp.asarray(rng.random((256, 256), dtype=np.float32) + 0.1)
        cot_v = jnp.asarray(rng.standard_normal(256), jnp.float32)
        E = jnp.asarray(rng.standard_normal((256, 256)), jnp.float32)

        _, vjp_fn = jax.vjp(lambda M: eigenpair(M), A)
        (dA,) = vjp_fn((jnp.float32(1.0), cot_v))
        assert bool(jnp.isfinite(dA).all())

        def g(M):
            l, w = eigenpair(M)
            return float(l) + float(jnp.dot(cot_v, w))

        h = 3e-3
        fd = (g(A + h * E) - g(A - h * E)) / (2 * h)
        assert float(jnp.sum(dA * E)) == pytest.approx(fd, rel=2e-2)

    def test_hilbert_256_gradient(self):
        """The repo's own flagship family: Hilbert's spectrum is nearly
        defective (eigenvalues decay super-exponentially), the classic
        near-singular-K stress for the bordered solve.  The verified solve
        must return a finite gradient that matches finite differences."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from eigen_value import fixtures
        from eigen_value.ops.autodiff import eigenpair

        H = fixtures.hilbert_matrix(256)
        rng = np.random.default_rng(11)
        cot_v = jnp.asarray(rng.standard_normal(256), jnp.float32)
        E = jnp.asarray(rng.standard_normal((256, 256)), jnp.float32)

        _, vjp_fn = jax.vjp(lambda M: eigenpair(M), H)
        (dA,) = vjp_fn((jnp.float32(1.0), cot_v))
        assert bool(jnp.isfinite(dA).all())

        def g(M):
            l, w = eigenpair(M)
            return float(l) + float(jnp.dot(cot_v, w))

        h = 1e-3  # entries are O(1e-3..1); λ≈2.08 — keep the step tiny
        fd = (g(H + h * E) - g(H - h * E)) / (2 * h)
        assert float(jnp.sum(dA * E)) == pytest.approx(fd, rel=5e-2)

    def test_n1024_random_gradient(self):
        """Scale check (VERDICT r1 item 4): n=1024 f32 — well past the
        restart window, where unverified restarted GMRES can stagnate."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from eigen_value.ops.autodiff import eigenpair

        rng = np.random.default_rng(13)
        A = jnp.asarray(rng.random((1024, 1024), dtype=np.float32) + 0.1)
        cot_v = jnp.asarray(rng.standard_normal(1024), jnp.float32)
        E = jnp.asarray(rng.standard_normal((1024, 1024)), jnp.float32)

        _, vjp_fn = jax.vjp(lambda M: eigenpair(M), A)
        (dA,) = vjp_fn((jnp.float32(1.0), cot_v))
        assert bool(jnp.isfinite(dA).all())

        def g(M):
            l, w = eigenpair(M)
            return float(l) + float(jnp.dot(cot_v, w))

        h = 1e-2
        fd = (g(A + h * E) - g(A - h * E)) / (2 * h)
        assert float(jnp.sum(dA * E)) == pytest.approx(fd, rel=2e-2)

    def test_bordered_fallback_on_gmres_failure(self):
        """Force GMRES to fail (maxiter=0 returns the zero iterate, whose
        residual is ||rhs||) — the verified solve must detect it and the
        direct fallback must still produce the correct solution."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from eigen_value.ops.autodiff import _solve_bordered, eigenpair

        rng = np.random.default_rng(5)
        A = jnp.asarray(rng.random((64, 64), dtype=np.float32) + 0.1)
        lam, v = eigenpair(A)
        ej = jax.nn.one_hot(jnp.argmax(v), 64, dtype=A.dtype)
        rhs = jnp.asarray(rng.standard_normal(65), jnp.float32)

        sol_fb, resid_fb = _solve_bordered(A, lam, v, ej, rhs, tol=1e-4, maxiter=0)
        sol_ok, resid_ok = _solve_bordered(A, lam, v, ej, rhs, tol=1e-4)
        assert float(resid_fb) < 1e-3  # fallback actually solved it
        np.testing.assert_allclose(
            np.asarray(sol_fb), np.asarray(sol_ok), rtol=1e-2, atol=1e-3
        )

    def test_vmap_composition(self):
        """Both custom VJPs compose with vmap — batched spectral gradients
        (DP-style) work out of the box."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from eigen_value.ops.autodiff import eigenpair, eigenvalue

        rng = np.random.default_rng(0)
        As = jnp.asarray(rng.random((3, 32, 32), dtype=np.float32) + 0.1)
        g = jax.vmap(jax.grad(lambda A: eigenvalue(A)))(As)
        assert g.shape == (3, 32, 32) and bool(jnp.isfinite(g).all())
        lam, v = jax.vmap(lambda A: eigenpair(A))(As)
        assert lam.shape == (3,) and v.shape == (3, 32)
        # per-matrix gradient equals the vmapped one
        g0 = jax.grad(lambda A: eigenvalue(A))(As[0])
        np.testing.assert_allclose(np.asarray(g[0]), np.asarray(g0), rtol=1e-5)

    def test_vmap_eigenpair_grad(self):
        """Batched eigenPAIR gradients: under vmap lax.cond runs BOTH
        fallback branches, so this pins that the batched backward pass
        works and matches the unbatched gradient."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from eigen_value.ops.autodiff import eigenpair

        rng = np.random.default_rng(7)
        As = jnp.asarray(rng.random((3, 32, 32), dtype=np.float32) + 0.1)

        def loss(A):
            lam, v = eigenpair(A)
            return lam + jnp.sum(v**2)

        g = jax.vmap(jax.grad(loss))(As)
        assert g.shape == (3, 32, 32) and bool(jnp.isfinite(g).all())
        g0 = jax.grad(loss)(As[0])
        np.testing.assert_allclose(
            np.asarray(g[0]), np.asarray(g0), rtol=1e-4, atol=1e-5
        )

    def test_no_spurious_warning_on_converged_vmap(self, capfd):
        """The unconverged-residual warning must not fire for converged
        batched solves (a traced cond around debug.print would print for
        every element under vmap — both branches run)."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from eigen_value.ops.autodiff import eigenpair

        rng = np.random.default_rng(3)
        As = jnp.asarray(rng.random((3, 16, 16), dtype=np.float32) + 0.1)
        g = jax.vmap(jax.grad(lambda A: eigenpair(A)[0]))(As)
        jax.effects_barrier()
        assert bool(jnp.isfinite(g).all())
        captured = capfd.readouterr()
        assert "exceeds its bound" not in captured.err

    def test_large_n_fallback_is_matvec_only(self, monkeypatch):
        """Above _DENSE_FALLBACK_MAX_N the fallback must be the longer
        GMRES (vmap-affordable), and it must still rescue a forced GMRES
        failure.  Exercised by shrinking the gate rather than paying a
        real n>1024 dense solve in CI."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from eigen_value.ops import autodiff

        monkeypatch.setattr(autodiff, "_DENSE_FALLBACK_MAX_N", 4)
        rng = np.random.default_rng(11)
        A = jnp.asarray(rng.random((64, 64), dtype=np.float32) + 0.1)
        lam, v = autodiff.eigenpair(A)
        ej = jax.nn.one_hot(jnp.argmax(v), 64, dtype=A.dtype)
        rhs = jnp.asarray(rng.standard_normal(65), jnp.float32)
        sol, resid = autodiff._solve_bordered(
            A, lam, v, ej, rhs, tol=1e-4, maxiter=0
        )
        assert float(resid) < 3e-3  # the GMRES retry converged
        # and the batched backward pass still works through the retry path
        As = jnp.asarray(rng.random((2, 32, 32), dtype=np.float32) + 0.1)
        g = jax.vmap(jax.grad(lambda A: autodiff.eigenpair(A)[0]))(As)
        assert bool(jnp.isfinite(g).all())


class TestEigenvalueOperator:
    """Matrix-free differentiable λ: the Perron adjoint expressed through
    the operator's matvec only (left eigenvector via jax.linear_transpose,
    numerator as the VJP of θ ↦ uᵀ·matvec_θ(v))."""

    def test_hankel_grad_matches_dense_adjoint(self, rng):
        from eigen_value.ops.autodiff import eigenvalue_operator
        from eigen_value.ops.structured import hankel_matvec

        n = 48
        h = jnp.asarray(rng.random(2 * n - 1, dtype=np.float32) + 0.1)
        lam_op = eigenvalue_operator(lambda hh: hankel_matvec(hh, n), n)
        idx = np.add.outer(np.arange(n), np.arange(n))
        g_op = jax.grad(lam_op)(h)
        # dense chain: the same λ(h) through the explicit A[r][c] = h[r+c]
        g_dense = jax.grad(lambda hh: eigenvalue(hh[idx]))(h)
        assert float(lam_op(h)) == pytest.approx(
            float(eigenvalue(h[idx])), rel=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(g_op), np.asarray(g_dense), rtol=2e-2, atol=2e-3
        )

    def test_hankel_grad_matches_finite_differences(self, rng):
        from eigen_value.ops.autodiff import eigenvalue_operator
        from eigen_value.ops.structured import hankel_matvec

        n = 16
        h = jnp.asarray(rng.random(2 * n - 1, dtype=np.float32) + 0.5)
        lam_op = eigenvalue_operator(lambda hh: hankel_matvec(hh, n), n)
        g = jax.grad(lam_op)(h)
        step = 1e-2
        for k in (0, 5, 2 * n - 2):
            fd = (
                float(lam_op(h.at[k].add(step)))
                - float(lam_op(h.at[k].add(-step)))
            ) / (2 * step)
            assert abs(float(g[k]) - fd) < 5e-2, (k, float(g[k]), fd)

    def test_kron_factor_gradient_identity(self, rng):
        """λ(B ⊗ C) = λ(B)·λ(C) ⇒ ∂λ/∂B = λ(C)·∂λ(B)/∂B — the operator
        gradient (through the two-matmul matvec) must recover the dense
        factor adjoint scaled by the other factor's eigenvalue."""
        from eigen_value.ops.autodiff import eigenvalue_operator
        from eigen_value.ops.structured import kron_matvec

        B = jnp.asarray(rng.random((8, 8), dtype=np.float32) + 0.2)
        C = jnp.asarray(rng.random((6, 6), dtype=np.float32) + 0.2)
        lam_op = eigenvalue_operator(lambda BB: kron_matvec(BB, C), 48)
        g_op = jax.grad(lam_op)(B)
        lam_c = float(eigenvalue(C))
        g_factor = jax.grad(eigenvalue)(B)
        np.testing.assert_allclose(
            np.asarray(g_op), lam_c * np.asarray(g_factor), rtol=2e-2, atol=2e-3
        )

    def test_unconverged_solve_warns(self, rng, capfd):
        """A cap-hit forward/transpose solve must not return a silent
        best-effort gradient: the VJP warns host-side (review finding)."""
        import jax

        from eigen_value.ops.autodiff import eigenvalue_operator
        from eigen_value.ops.structured import hankel_matvec

        n = 16
        h = jnp.asarray(rng.random(2 * n - 1, dtype=np.float32) + 0.5)
        lam_op = eigenvalue_operator(
            lambda hh: hankel_matvec(hh, n), n, max_itr=1
        )
        g = jax.grad(lam_op)(h)
        jax.effects_barrier()
        assert np.isfinite(np.asarray(g)).all()
        assert "UNCONVERGED" in capfd.readouterr().err

    def test_converged_solve_does_not_warn(self, rng, capfd):
        import jax

        from eigen_value.ops.autodiff import eigenvalue_operator
        from eigen_value.ops.structured import hankel_matvec

        n = 16
        h = jnp.asarray(rng.random(2 * n - 1, dtype=np.float32) + 0.5)
        lam_op = eigenvalue_operator(lambda hh: hankel_matvec(hh, n), n)
        jax.grad(lam_op)(h)
        jax.effects_barrier()
        assert "UNCONVERGED" not in capfd.readouterr().err

    def test_pytree_theta(self, rng):
        """theta may be any pytree: a dict of Kronecker factors gets a
        matching dict of gradients."""
        from eigen_value.ops.autodiff import eigenvalue_operator
        from eigen_value.ops.structured import kron_matvec

        theta = {
            "B": jnp.asarray(rng.random((6, 6), dtype=np.float32) + 0.2),
            "C": jnp.asarray(rng.random((4, 4), dtype=np.float32) + 0.2),
        }
        lam_op = eigenvalue_operator(
            lambda th: kron_matvec(th["B"], th["C"]), 24
        )
        g = jax.grad(lam_op)(theta)
        assert set(g) == {"B", "C"}
        assert np.isfinite(np.asarray(g["B"])).all()
        assert np.isfinite(np.asarray(g["C"])).all()
        # scale identity: λ is linear in each factor, so ⟨B, ∂λ/∂B⟩ = λ
        lam = float(lam_op(theta))
        assert float(jnp.vdot(theta["B"], g["B"])) == pytest.approx(lam, rel=1e-3)


class TestEigenpairOperator:
    """Matrix-free differentiable (λ, v): the bordered adjoint expressed
    through matvecs only (Aᵀw via jax.linear_transpose, θ cotangent as
    −∂(wᵀ·matvec_θ(v))/∂θ)."""

    def test_value_matches_dense_pair(self, rng):
        from eigen_value.ops.autodiff import eigenpair, eigenpair_operator
        from eigen_value.ops.structured import hankel_matvec

        n = 32
        h = jnp.asarray(rng.random(2 * n - 1, dtype=np.float32) + 0.1)
        idx = np.add.outer(np.arange(n), np.arange(n))
        lam_d, v_d = eigenpair(h[idx])
        pair_op = eigenpair_operator(lambda hh: hankel_matvec(hh, n), n)
        lam_o, v_o = pair_op(h)
        assert float(lam_o) == pytest.approx(float(lam_d), rel=1e-4)
        np.testing.assert_allclose(np.asarray(v_o), np.asarray(v_d), atol=1e-4)

    def test_vjp_matches_dense_chain(self, rng):
        """Cotangents through the operator VJP must equal the dense
        eigenpair VJP chained through the explicit A(h) = h[r+c]."""
        from eigen_value.ops.autodiff import eigenpair, eigenpair_operator
        from eigen_value.ops.structured import hankel_matvec

        n = 24
        h = jnp.asarray(rng.random(2 * n - 1, dtype=np.float32) + 0.2)
        idx = np.add.outer(np.arange(n), np.arange(n))
        lam_bar = jnp.float32(0.7)
        v_bar = jnp.asarray(rng.standard_normal(n).astype(np.float32))

        _, vjp_d = jax.vjp(lambda hh: eigenpair(hh[idx]), h)
        (g_dense,) = vjp_d((lam_bar, v_bar))
        pair_op = eigenpair_operator(lambda hh: hankel_matvec(hh, n), n)
        _, vjp_o = jax.vjp(pair_op, h)
        (g_op,) = vjp_o((lam_bar, v_bar))
        np.testing.assert_allclose(
            np.asarray(g_op), np.asarray(g_dense), rtol=5e-2, atol=5e-3
        )

    def test_lambda_only_cotangent_matches_eigenvalue_operator(self, rng):
        """With v̄ = 0 the bordered adjoint reduces to the Perron adjoint:
        the pair VJP must agree with eigenvalue_operator's gradient."""
        from eigen_value.ops.autodiff import (
            eigenpair_operator,
            eigenvalue_operator,
        )
        from eigen_value.ops.structured import hankel_matvec

        n = 24
        h = jnp.asarray(rng.random(2 * n - 1, dtype=np.float32) + 0.2)
        pair_op = eigenpair_operator(lambda hh: hankel_matvec(hh, n), n)
        _, vjp_o = jax.vjp(pair_op, h)
        (g_pair,) = vjp_o((jnp.float32(1.0), jnp.zeros((n,), jnp.float32)))
        lam_op = eigenvalue_operator(lambda hh: hankel_matvec(hh, n), n)
        g_lam = jax.grad(lam_op)(h)
        np.testing.assert_allclose(
            np.asarray(g_pair), np.asarray(g_lam), rtol=5e-2, atol=5e-3
        )

    def test_operator_vjps_compose_with_jit_and_vmap(self, rng):
        """The API claim: both operator VJPs work under jit and vmap
        (vmapped GMRES + linear_transpose included)."""
        from eigen_value.ops.autodiff import (
            eigenpair_operator,
            eigenvalue_operator,
        )
        from eigen_value.ops.structured import hankel_matvec

        n = 16
        h = jnp.asarray(rng.random(2 * n - 1, dtype=np.float32) + 0.5)
        hs = jnp.stack([h, h * 1.1, h * 0.9])
        lam_op = eigenvalue_operator(lambda hh: hankel_matvec(hh, n), n)
        assert np.isfinite(np.asarray(jax.jit(jax.grad(lam_op))(h))).all()
        gs = jax.vmap(jax.grad(lam_op))(hs)
        assert gs.shape == hs.shape and np.isfinite(np.asarray(gs)).all()

        pair_op = eigenpair_operator(lambda hh: hankel_matvec(hh, n), n)

        def loss(hh):
            lam, v = pair_op(hh)
            return lam + v.sum()

        assert np.isfinite(np.asarray(jax.jit(jax.grad(loss))(h))).all()
        assert np.isfinite(np.asarray(jax.vmap(jax.grad(loss))(hs))).all()
