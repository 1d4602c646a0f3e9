"""Matrix-free solves: the operator API on a structured (Hankel) matrix.

The framework's power-form loop observes A only through one matvec per
round (docs/DESIGN.md §2), so `max_eigenvalue_operator` solves any
positive linear operator WITHOUT materializing it.  The benchmark
family itself is the showcase: the Hilbert matrix `A[r][c] = 1/(r+c+1)`
is Hankel (constant anti-diagonals, A[r][c] = h[r+c]), whose matvec is a
correlation computable by FFT in O(n log n) — versus the O(n²) dense
pass.  At 8192² that is ~3 orders of magnitude less work per round;
more importantly, n far beyond any chip's HBM becomes solvable (the
operator needs O(n) memory).

The dense solver remains the general-matrix production path (and the
headline benchmark — no structure assumed); this example shows the
framework's reach past the reference's dense-buffer-only design
(similarity_transform.hpp:8-9).

Run: python examples/matrix_free.py [--dim 4096]
"""

import os as _os, sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time

import numpy as np

import jax
import jax.numpy as jnp

from eigen_value import fixtures, max_eigenvalue, max_eigenvalue_operator
from eigen_value.ops.structured import hilbert_matvec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=4096)
    n = ap.parse_args().dim

    # the Hilbert matrix as an O(n) object: its anti-diagonal profile
    # (the FFT of the profile is a trace-time constant — O(n) payload;
    # the solve itself never touches an n² object)
    mv = hilbert_matvec(n)
    solve = jax.jit(lambda: max_eigenvalue_operator(mv, n))
    res = jax.block_until_ready(solve())
    lam = float(res.eigenvalue)

    dense = max_eigenvalue(fixtures.hilbert_matrix(n))
    print(
        f"operator solve (FFT Hankel, n={n}): λ = {lam:.6f}, "
        f"rounds = {int(res.rounds)}"
    )
    print(
        f"dense solve:                        λ = {float(dense.eigenvalue):.6f}, "
        f"rounds = {int(dense.rounds)}"
    )
    assert abs(lam - float(dense.eigenvalue)) < 1e-3 * lam
    assert abs(int(res.rounds) - int(dense.rounds)) <= 1
    print("operator λ matches dense within 1e-3 relative")

    # the point: per-round cost is O(n log n), memory O(n)
    t0 = time.perf_counter()
    jax.block_until_ready(solve())
    print(f"full operator solve wall: {(time.perf_counter() - t0) * 1e3:.2f} ms")

    # Kronecker structure: B ⊗ C as two matmuls — compute-dense,
    # never materialized; λ_max factorizes as λ_max(B)·λ_max(C).
    from eigen_value.ops.structured import kron_matvec

    rng = np.random.default_rng(7)
    B = jnp.asarray(rng.random((32, 32), dtype=np.float32) + 0.1)
    C = jnp.asarray(rng.random((48, 48), dtype=np.float32) + 0.1)
    res_k = max_eigenvalue_operator(kron_matvec(B, C), 32 * 48)
    lam_prod = float(max_eigenvalue(B).eigenvalue) * float(
        max_eigenvalue(C).eigenvalue
    )
    print(
        f"kron operator (1536², never materialized): λ = "
        f"{float(res_k.eigenvalue):.5f} vs factor product {lam_prod:.5f}"
    )
    assert abs(float(res_k.eigenvalue) - lam_prod) < 1e-3 * lam_prod

    # Diagnostics: the traced solve records λ per round at zero extra
    # compute; convergence_report turns the history into the subdominant
    # ratio |λ₂/λ₁| (= digits gained per round), and refine_eigenpair
    # polishes the f32 result to float64 accuracy on the host.
    from eigen_value.ops.solver_matvec import solve_operator_traced
    from eigen_value.ops.spectral import convergence_report, refine_eigenpair

    res_t, hist = jax.jit(
        lambda: solve_operator_traced(mv, n, 1e-6, 200)
    )()
    rep = convergence_report(np.asarray(hist), int(res_t.rounds))
    print(
        f"convergence: rate |λ₂/λ₁| ≈ {rep.rate:.4f} "
        f"({rep.digits_per_round:.2f} digits/round), "
        f"remaining λ error ≈ {rep.lam_error_estimate:.2e}"
    )

    if n <= 4096:  # host f64 polish needs the dense matrix
        A64 = np.asarray(fixtures.hilbert_matrix(n), np.float64)
        ref = refine_eigenpair(A64, res)
        print(
            f"f64 polish: λ = {ref.eigenvalue:.12f} "
            f"(residual {ref.residual:.1e}, {ref.rounds} host rounds)"
        )

        # MEASURE the gap the report estimated: Hotelling deflation of the
        # refined dominant pair + device power iteration gives λ₂ itself.
        # Passing the RefinedPair reuses the polish paid above (the f64
        # host refinement is the expensive half at this n).
        from eigen_value.ops.spectral import subdominant_eigenpair

        sub = subdominant_eigenpair(A64, ref)
        print(
            f"spectral gap: λ₂ = {sub.eigenvalue:.6e}, measured |λ₂/λ₁| = "
            f"{sub.ratio:.4f} (report estimated {rep.rate:.4f}; "
            f"{sub.rounds} deflated rounds)"
        )


if __name__ == "__main__":
    main()
