"""Quickstart: the reference wrapper's workflow, in JAX.

Mirrors the reference's wrapper/python/test.py (4 rounds on a random
positive 1024² float32 matrix, asserting A·v ≈ λ·v) plus the functional
API and the bf16 fast mode.

Run: python examples/quickstart.py
"""

import os as _os, sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

import jax.numpy as jnp

from eigen_value import EigenValue, SolverConfig, max_eigenvalue


def main() -> None:
    rng = np.random.default_rng(0)

    # ── class API: same return tuple as the reference wrapper ──────────
    ev = EigenValue()
    ev.warmup([1024])  # AOT-compile (the reference's queue/.so setup analog)
    for i in range(4):
        mat = rng.random((1024, 1024), dtype=np.float32)
        lam, vec, ts_ms, rounds = ev.similarity_transform(mat)
        assert np.allclose(mat @ vec, lam * vec, atol=1e-3)
        print(f"[{i}] λ = {lam:.5f}   {ts_ms:7.2f} ms   {rounds} round(s)")

    # ── functional API: jittable pytree result ──────────────────────────
    mat = rng.random((512, 512), dtype=np.float32)
    res = max_eigenvalue(mat)
    print(
        f"functional: λ = {float(res.eigenvalue):.5f}, "
        f"rounds = {int(res.rounds)}, converged = {bool(res.converged)}"
    )

    # ── fast mode: bf16 matrix storage (≈2× per round, ~1e-3 accuracy) ──
    res16 = max_eigenvalue(mat, SolverConfig(storage_dtype=jnp.bfloat16))
    print(f"bf16 fast mode: λ = {float(res16.eigenvalue):.5f}")

    # ── symmetric fast path ─────────────────────────────────────────────
    # For a symmetric matrix, DECLARE it (BLAS-symv-style promise): on a
    # GPU the solver then reads only the upper triangle (the Pallas
    # kernel ops/pallas/kernels.symv); elsewhere the dense path keeps the
    # job with the same answer.  Or just pass validate=True: on a GPU a
    # matrix that checks bitwise symmetric on device is promoted to the
    # same path automatically.
    sym = jnp.asarray((mat + mat.T) / 2)
    res_sym = max_eigenvalue(sym, SolverConfig(symmetric=True))
    res_val = max_eigenvalue(sym, validate=True)  # checked + auto-promoted
    assert abs(float(res_sym.eigenvalue) - float(res_val.eigenvalue)) < 1e-3
    print(
        f"symmetric path: λ = {float(res_sym.eigenvalue):.5f} "
        f"({int(res_sym.rounds)} rounds; declared vs validated agree)"
    )


if __name__ == "__main__":
    main()
