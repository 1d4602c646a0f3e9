"""Differentiable maximum eigenvalue (custom VJP).

The solver's `lax.while_loop` is not reverse-mode differentiable, but the
Perron eigenvalue has a closed-form adjoint: with right eigenvector v
(A v = λ v) and left eigenvector u (Aᵀ u = λ u),

    ∂λ/∂A = u vᵀ / (uᵀ v)

(normalization-invariant).  Forward runs the production matvec solver; the
backward pass solves once more on Aᵀ — which is positive iff A is, so the
same method applies.  This is a capability the reference does not have at
all; it falls out of the functional design.
"""

from __future__ import annotations

import sys
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..config import EPS, MAX_ITR
from .solver_matvec import solve_matvec


def _dot(a, b):
    """A device product at full f32 precision (a GPU may otherwise run it
    in TF32, ~3 decimal digits — far coarser than the adjoint tolerances)."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def eigenvalue(A: jax.Array, eps: float = EPS, max_itr: int = MAX_ITR) -> jax.Array:
    """Maximum eigenvalue of a positive square matrix, differentiable in A."""
    return solve_matvec(A, eps, max_itr).eigenvalue


def _fwd(A, eps, max_itr):
    res = solve_matvec(A, eps, max_itr)
    return res.eigenvalue, (A, res.eigenvector)


def _bwd(eps, max_itr, residuals, lam_bar):
    A, v = residuals
    u = solve_matvec(A.T, eps, max_itr).eigenvector  # left eigenvector of A
    denom = _dot(u, v)
    dA = lam_bar * (u[:, None] * v[None, :]) / denom
    return (dA,)


eigenvalue.defvjp(_fwd, _bwd)


@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def eigenpair(A: jax.Array, eps: float = EPS, max_itr: int = MAX_ITR):
    """``(λ, v)`` of a positive square matrix, differentiable in A — both
    the eigenvalue AND the eigenvector.

    The returned ``v`` is explicitly normalized to ``max component = 1``
    (the solver's nominal convention, SURVEY.md §0, here enforced exactly
    so differentiation has a well-defined constraint): ``e_jᵀ v = 1``
    with ``j = argmax(v)``, locally constant for a simple Perron
    eigenpair, so differentiable almost everywhere.

    Backward pass: the eigen-equation differential with the normalization
    gives the bordered linear system

        [[A − λI, −v], [e_jᵀ, 0]] [dv; dλ] = [−dA·v; 0]

    whose (n+1)×(n+1) matrix K is nonsingular for a simple eigenpair even
    though A − λI itself is singular.  The VJP solves the adjoint system
    Kᵀ[w; s] = [v̄; λ̄] (GMRES, matvec against the SAME resident A — no
    factorization, no transpose copy) and returns Ā = −w vᵀ.  For v̄ = 0
    this reduces analytically to the Perron adjoint λ̄·u vᵀ/(uᵀv) used by
    :func:`eigenvalue`.

    The GMRES solution is residual-VERIFIED: if restarted GMRES stagnates
    (near-singular K from a small spectral gap, or large n), the VJP falls
    back to a direct dense solve (n ≤ 1024) or a longer matvec-only GMRES
    (larger n — keeps `vmap`-ped backward passes affordable, since vmap
    executes both `lax.cond` branches) rather than returning an unverified
    gradient; a fallback that still misses its bound prints a runtime
    warning (see :func:`_solve_bordered`).
    """
    res = solve_matvec(A, eps, max_itr)
    v = res.eigenvector / jnp.max(res.eigenvector)
    return res.eigenvalue, v


def _pair_fwd(A, eps, max_itr):
    lam, v = eigenpair(A, eps, max_itr)
    return (lam, v), (A, lam, v)


#: Largest n for which the verified-GMRES fallback is a DENSE direct solve.
#: Under `jax.vmap` a `lax.cond` lowers to `select_n` and BOTH branches
#: execute for every batch element, so the fallback must stay affordable
#: even when it isn't taken: at n ≤ this bound the (n+1)² bordered matrix
#: is ≤ ~4 MB and the factorization cheap; above it the fallback is a
#: longer matvec-only GMRES instead (O(n²) per iteration, no (n+1)²
#: materialization).
_DENSE_FALLBACK_MAX_N = 1024


def _solve_bordered(A, lam, v, ej, rhs, tol, maxiter=10):
    """Solve Kᵀ x = rhs for the bordered adjoint system, VERIFIED.

    GMRES first (matvec-only, no factorization); its solution is accepted
    only if the residual actually meets the tolerance — restarted GMRES can
    stagnate on a near-singular K (small Perron spectral gap) or large n
    and silently return garbage.  On failure, falls back under `lax.cond`
    to a direct dense solve of the (n+1)² system for
    n ≤ ``_DENSE_FALLBACK_MAX_N`` (exact, one O(n³) factorization — skipped
    entirely when GMRES verified, except under vmap where both branches
    run, hence the size gate), or to a 4×-longer restarted GMRES for
    larger n (matvec-only, so batched backward passes stay O(n²)-per-step
    even though vmap executes the fallback unconditionally).  If even the
    fallback misses the tolerance, a runtime warning is printed rather
    than failing silently.  Returns ``(x, rel_residual)``.
    """
    n = A.shape[0]

    def KT_mv(ws):
        w, s = ws[:n], ws[n]
        top = _dot(w, A) - lam * w + ej * s  # (Aᵀ − λI)w + e_j·s
        bot = -_dot(v, w)
        return jnp.concatenate([top, bot[None]])

    def rel_resid(x):
        scale = jnp.linalg.norm(rhs) + jnp.finfo(A.dtype).tiny
        return jnp.linalg.norm(KT_mv(x) - rhs) / scale

    sol, _ = jax.scipy.sparse.linalg.gmres(
        KT_mv,
        rhs,
        tol=tol,
        atol=0.0,
        restart=min(n + 1, 100),
        maxiter=maxiter,
        solve_method="batched",
    )

    # accept with head-room (GMRES's internal criterion is approximate for
    # the batched solve method); anything worse goes to the direct solve
    ok = rel_resid(sol) <= 30.0 * tol

    def direct(_):
        KT = jnp.zeros((n + 1, n + 1), A.dtype)
        KT = KT.at[:n, :n].set(A.T - lam * jnp.eye(n, dtype=A.dtype))
        KT = KT.at[:n, n].set(ej)
        KT = KT.at[n, :n].set(-v)
        return jnp.linalg.solve(KT, rhs)

    def retry_gmres(_):
        sol2, _ = jax.scipy.sparse.linalg.gmres(
            KT_mv,
            rhs,
            tol=tol,
            atol=0.0,
            restart=min(n + 1, 150),
            maxiter=4 * max(maxiter, 10),
            solve_method="batched",
        )
        return sol2

    fallback = direct if n <= _DENSE_FALLBACK_MAX_N else retry_gmres
    sol = lax.cond(ok, lambda _: sol, fallback, None)
    resid = rel_resid(sol)
    _warn_if_unconverged(resid, 30.0 * tol)
    return sol, resid


def _warn_if_unconverged(resid, bound):
    """Runtime warning when even the fallback solve missed its residual
    bound — the gradient is then best-effort, never silent.  The
    comparison happens HOST-side inside a debug callback: a traced
    `lax.cond` around `debug.print` would execute the print for every
    batch element under vmap (both cond branches run), spamming spurious
    warnings on perfectly converged batched solves."""

    def _cb(r, b):
        if r > b:
            print(
                f"eigen_value: eigenpair VJP bordered solve residual "
                f"{float(r):.3e} exceeds its bound {float(b):.3e}; the "
                f"returned gradient may be inaccurate (near-defective "
                f"spectrum?)",
                file=sys.stderr,
            )

    jax.debug.callback(_cb, resid, bound)


def eigenvalue_operator(make_matvec, n: int, eps: float = EPS, max_itr: int = MAX_ITR):
    """MATRIX-FREE differentiable maximum eigenvalue.

    ``make_matvec(theta)`` builds a positive-operator matvec
    ``x ↦ A(θ)·x`` from parameters ``theta`` (any pytree); the returned
    function ``theta ↦ λ_max(A(θ))`` is reverse-differentiable without A
    ever being materialized:

      * forward — the power-form operator solve (solver_matvec.py);
      * left eigenvector — a solve against ``Aᵀ``, whose matvec is
        obtained for free via ``jax.linear_transpose`` (the matvec is
        linear in x by contract; A positive ⇒ Aᵀ positive, so the same
        method converges);
      * the Perron adjoint ``∂λ/∂θ = uᵀ(∂A/∂θ)v / (uᵀv)`` — with A
        implicit, the numerator is exactly the gradient of the SCALAR
        ``θ ↦ uᵀ·matvec_θ(v)`` at frozen u, v: one more reverse pass
        through the operator's O(n log n)-ish matvec, never its n² dense
        form.

    Dense analog: :func:`eigenvalue` (same adjoint with u vᵀ explicit).
    No reference analog — the reference is neither matrix-free nor
    differentiable (dense float32 buffers only,
    similarity_transform.hpp:8-9).
    """
    from .solver_matvec import solve_operator

    @jax.custom_vjp
    def lam_fn(theta):
        return solve_operator(make_matvec(theta), n, eps, max_itr).eigenvalue

    def fwd(theta):
        res = solve_operator(make_matvec(theta), n, eps, max_itr)
        return res.eigenvalue, (theta, res.eigenvector, res.converged)

    def bwd(residuals, lam_bar):
        theta, v, fwd_converged = residuals
        mv = make_matvec(theta)

        def rmv(y):
            (out,) = jax.linear_transpose(mv, jnp.zeros((n,), v.dtype))(y)
            return out

        ures = solve_operator(rmv, n, eps, max_itr)
        u = ures.eigenvector
        # The adjoint is only as good as its eigenvectors: an unconverged
        # forward or transpose solve (cap hit — tiny spectral gap or a
        # too-small max_itr) would silently feed pre-convergence iterates
        # into u·(∂A/∂θ)v/(uᵀv).  Warn host-side, like the eigenpair VJP.
        _warn_if_operator_unconverged(fwd_converged & ures.converged)
        denom = _dot(u, v)
        g = jax.grad(lambda th: jnp.dot(u, make_matvec(th)(v)))(theta)
        return (jax.tree.map(lambda x: x * (lam_bar / denom), g),)

    lam_fn.defvjp(fwd, bwd)
    return lam_fn


def eigenpair_operator(make_matvec, n: int, eps: float = EPS, max_itr: int = MAX_ITR):
    """MATRIX-FREE differentiable ``(λ, v)`` — the operator analog of
    :func:`eigenpair`.

    ``make_matvec(theta)`` builds the positive-operator matvec from any
    parameter pytree; the returned ``theta ↦ (λ, v)`` (v normalized to
    max component 1) is reverse-differentiable with A never materialized.
    The VJP solves the same bordered adjoint system Kᵀ[w; s] = [v̄; λ̄] as
    the dense :func:`eigenpair`, but strictly through matvecs: Kᵀ's
    action needs only ``Aᵀw`` (``jax.linear_transpose`` of the matvec)
    and the θ cotangent is ``−∂/∂θ (wᵀ·matvec_θ(v))`` — the matrix-free
    reading of the dense ``Ā = −w vᵀ``.  There is no dense fallback (no
    dense matrix exists): a stagnating GMRES retries with a 4× budget
    and warns if it still misses its residual bound, like the dense
    path's large-n branch.
    """
    from .solver_matvec import solve_operator

    @jax.custom_vjp
    def pair_fn(theta):
        res = solve_operator(make_matvec(theta), n, eps, max_itr)
        return res.eigenvalue, res.eigenvector / jnp.max(res.eigenvector)

    def fwd(theta):
        res = solve_operator(make_matvec(theta), n, eps, max_itr)
        v = res.eigenvector / jnp.max(res.eigenvector)
        return (res.eigenvalue, v), (theta, res.eigenvalue, v, res.converged)

    def bwd(residuals, cotangents):
        theta, lam, v, fwd_converged = residuals
        lam_bar, v_bar = cotangents
        _warn_if_operator_unconverged(fwd_converged, api_name="eigenpair_operator")
        mv = make_matvec(theta)

        def rmv(y):
            (out,) = jax.linear_transpose(mv, jnp.zeros((n,), v.dtype))(y)
            return out

        ej = jax.nn.one_hot(jnp.argmax(v), n, dtype=v.dtype)

        def KT_mv(ws):
            w, s = ws[:n], ws[n]
            top = rmv(w) - lam * w + ej * s
            bot = -_dot(v, w)
            return jnp.concatenate([top, bot[None]])

        rhs = jnp.concatenate([v_bar, lam_bar[None]])
        tol = max(50.0 * float(jnp.finfo(v.dtype).eps), 1e-9, 0.1 * float(eps))

        def rel_resid(x):
            scale = jnp.linalg.norm(rhs) + jnp.finfo(v.dtype).tiny
            return jnp.linalg.norm(KT_mv(x) - rhs) / scale

        def gmres(restart, maxiter):
            sol, _ = jax.scipy.sparse.linalg.gmres(
                KT_mv,
                rhs,
                tol=tol,
                atol=0.0,
                restart=restart,
                maxiter=maxiter,
                solve_method="batched",
            )
            return sol

        sol = gmres(min(n + 1, 100), 10)
        ok = rel_resid(sol) <= 30.0 * tol
        sol = lax.cond(
            ok, lambda _: sol, lambda _: gmres(min(n + 1, 150), 40), None
        )
        _warn_if_unconverged(rel_resid(sol), 30.0 * tol)
        w = sol[:n]
        g = jax.grad(lambda th: jnp.dot(w, make_matvec(th)(v)))(theta)
        return (jax.tree.map(lambda x: -x, g),)

    pair_fn.defvjp(fwd, bwd)
    return pair_fn


def _warn_if_operator_unconverged(converged, api_name="eigenvalue_operator"):
    """Host-side runtime warning when a matrix-free adjoint solve hit the
    iteration cap (same callback pattern as :func:`_warn_if_unconverged` —
    a traced cond would fire per batch element under vmap).  ``api_name``
    names the user-facing entry point so the warning greps to the call
    the user actually made."""

    def _cb(ok):
        if not bool(ok):
            print(
                f"eigen_value: {api_name} VJP ran on an "
                "UNCONVERGED solve (iteration cap hit); the returned "
                "gradient uses pre-convergence eigenvector iterates and "
                "may be inaccurate — raise max_itr or loosen eps",
                file=sys.stderr,
            )

    jax.debug.callback(_cb, converged)


def _pair_bwd(eps, max_itr, residuals, cotangents):
    A, lam, v = residuals
    lam_bar, v_bar = cotangents
    n = A.shape[0]
    ej = jax.nn.one_hot(jnp.argmax(v), n, dtype=A.dtype)
    rhs = jnp.concatenate([v_bar, lam_bar[None]])
    # The tolerance must be REACHABLE or GMRES spins to its iteration cap
    # and returns garbage: floor it at ~50·machine-eps of the compute dtype
    # (f32 → ~6e-6; the original 1e-9 is unreachable in f32) AND at a
    # tenth of the forward solve's eps — (λ, v) are only eps-accurate, so
    # the bordered system is inconsistent below that level anyway.
    tol = max(50.0 * float(jnp.finfo(A.dtype).eps), 1e-9, 0.1 * float(eps))
    sol, _ = _solve_bordered(A, lam, v, ej, rhs, tol)
    w = sol[:n]
    return (-(w[:, None] * v[None, :]),)


eigenpair.defvjp(_pair_fwd, _pair_bwd)
