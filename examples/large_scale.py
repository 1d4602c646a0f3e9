"""Large-dim single-device validation: dims the reference never reached.

The matvec (power) form never writes A, so the max solvable dim is set by
ONE resident copy of the matrix: 65536² float32 (16 GiB) and 65536²
bfloat16 (8 GiB) both fit an 80 GB H100.  The Hilbert matrix is generated
on device (fused iota — no host transfer).  The default path is dense
XLA (``backend="auto"``); on a GPU, ``--symmetric`` declares the matrix
symmetric and runs the upper-triangle kernel instead.

Run on a GPU (well under a second per solve once compiled):
    python examples/large_scale.py [--dim 65536] [--bf16-dim 65536] [--symmetric]
"""

import os as _os, sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time

import numpy as np

import jax
import jax.numpy as jnp

from eigen_value import SolverConfig, fixtures, max_eigenvalue


def solve_on_device(n: int, storage_dtype=None, symmetric: bool = False) -> None:
    cfg = SolverConfig(storage_dtype=storage_dtype, symmetric=symmetric)
    # Generate directly in the storage dtype: the bf16 matrix is the only
    # copy ever materialized (max_eigenvalue skips the f32 round-trip for
    # already-quantized inputs).
    H = jax.block_until_ready(
        fixtures.hilbert_matrix(n, dtype=storage_dtype or jnp.float32)
    )
    t0 = time.perf_counter()
    res = max_eigenvalue(H, cfg)
    lam = float(np.asarray(res.eigenvalue))
    wall = (time.perf_counter() - t0) * 1e3
    mode = f"bf16 storage" if storage_dtype is not None else "float32"
    print(
        f"{n}² Hilbert ({mode}): λ = {lam:.5f}, "
        f"rounds = {int(res.rounds)}, converged = {bool(res.converged)}, "
        f"wall = {wall:.0f} ms (includes compile on first call)"
    )
    # Row sums of the Hilbert matrix are ~ln(n)+γ-ish; λ must exceed the
    # mean row sum and the eigenvector must be positive.
    assert bool(res.converged)
    assert lam > 0
    assert float(jnp.min(res.eigenvector)) > 0


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dim", type=int, default=65536)
    p.add_argument("--bf16-dim", type=int, default=65536)
    p.add_argument("--skip-bf16", action="store_true")
    p.add_argument("--symmetric", action="store_true")
    args = p.parse_args()

    solve_on_device(args.dim, symmetric=args.symmetric)
    if not args.skip_bf16:
        solve_on_device(args.bf16_dim, storage_dtype=jnp.bfloat16)


if __name__ == "__main__":
    main()
