"""Differentiable eigenpair: gradient-based spectral design.

Uses the framework's custom VJPs (ops/autodiff.py) to tune a matrix so its
Perron eigenvalue hits a target — a capability with no analog in the
reference, falling out of the functional design.

Run: python examples/autodiff.py
"""

import os as _os, sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from eigen_value.ops.autodiff import eigenpair, eigenvalue


def main() -> None:
    rng = np.random.default_rng(0)
    A0 = jnp.asarray(rng.random((64, 64), dtype=np.float32) + 0.1)
    target = 40.0

    # Gradient descent on log-entries (keeps A positive) toward target λ.
    def loss(logA):
        lam = eigenvalue(jnp.exp(logA))
        return (lam - target) ** 2

    logA = jnp.log(A0)
    grad = jax.jit(jax.grad(loss))
    lam0 = float(eigenvalue(A0))
    for step in range(60):
        logA = logA - 0.5 * grad(logA)
    lam1 = float(eigenvalue(jnp.exp(logA)))
    print(f"λ: {lam0:.3f} → {lam1:.3f} (target {target})")
    assert abs(lam1 - target) < 0.5

    # Eigenvector sensitivities via the full eigenpair VJP: how does each
    # matrix entry move component 0 of the Perron vector?
    (lam, v), vjp_fn = jax.vjp(lambda M: eigenpair(M), A0)
    cot = jnp.zeros_like(v).at[0].set(1.0)
    (dA,) = vjp_fn((jnp.zeros(()), cot))
    print(
        f"∂v[0]/∂A: max |sensitivity| {float(jnp.abs(dA).max()):.2e} "
        f"at entry {tuple(int(i) for i in jnp.unravel_index(jnp.argmax(jnp.abs(dA)), dA.shape))}"
    )

    # Matrix-free: differentiate λ of a Hankel OPERATOR w.r.t. its O(n)
    # profile — the n² matrix never exists, forward or backward.
    from eigen_value.ops.autodiff import eigenvalue_operator
    from eigen_value.ops.structured import hankel_matvec

    n = 256
    h0 = jnp.asarray(1.0 / np.arange(1, 2 * n, dtype=np.float32))  # Hilbert
    lam_of_profile = eigenvalue_operator(lambda h: hankel_matvec(h, n), n)
    g = jax.grad(lam_of_profile)(h0)
    print(
        f"matrix-free ∂λ/∂h (n={n}): λ = {float(lam_of_profile(h0)):.5f}, "
        f"most sensitive profile entry k = {int(jnp.argmax(jnp.abs(g)))} "
        f"(gradient {float(g[jnp.argmax(jnp.abs(g))]):.4f})"
    )


if __name__ == "__main__":
    main()
