"""Serving workflow: build a shippable solver artifact, then load and
solve with zero tracing.

The reference's production story was an AOT-compiled binary plus a
ctypes-loaded .so (Makefile:44-69, wrapper/python/similarity_transform.py);
the analog here is a serialized StableHLO artifact
(utils/aot.export_solver) that a serving process loads and calls without
any solver code being traced or compiled.

Run: python examples/serving.py   (on the CPU; artifacts for a GPU are
built the same way with platforms=("cuda",) on any host)
"""

import os as _os, sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import tempfile

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

from eigen_value import fixtures
from eigen_value.utils import aot


def main() -> None:
    n = 1024

    # ── build side: export a versioned artifact (any host) ─────────────
    # platforms=("cuda", "cpu") would cross-lower for a card this build
    # machine does not have — exactly how the reference cross-compiles
    # its aot_gpu target on a CPU box.
    exported = aot.export_solver(n)
    with tempfile.TemporaryDirectory() as d:
        path = aot.save_exported(exported, f"{d}/solver_{n}.bin")
        size_kb = _os.path.getsize(path) / 1024
        print(f"artifact: solver_{n}.bin ({size_kb:.1f} KiB, platforms={exported.platforms})")

        # ── serving side: load and solve ───────────────────────────────
        loaded = aot.load_exported(path)
        H = np.asarray(fixtures.hilbert_matrix(n))
        res = loaded.call(H)
        lam, rounds = float(res.eigenvalue), int(res.rounds)
        print(f"served solve: λ = {lam:.5f}, rounds = {rounds} "
              f"(expect {fixtures.HILBERT_ROUNDS[n]})")
        assert rounds == fixtures.HILBERT_ROUNDS[n]
        v = np.asarray(res.eigenvector)
        assert np.allclose(H @ v, lam * v, atol=1e-3)
        print("eigen-pair residual check passed (A·v ≈ λ·v)")


if __name__ == "__main__":
    main()
