"""Distributed solves: sharded, ring-pipelined, batched, and checkpointed.

Runs on whatever devices are visible; to simulate an 8-chip mesh on CPU:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        JAX_PLATFORMS=cpu python examples/distributed.py

On a real multi-host slice, call eigen_value.parallel.multihost
.initialize() first and build per-host blocks with assemble_rowsharded
(see eigen_value/bench/mh_worker.py for the full multi-process flow).
"""

import os as _os, sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# This example demos the multi-device FLOW on a virtual CPU mesh.
import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

from eigen_value import checkpoint, fixtures
from eigen_value.parallel import (
    make_mesh2d,
    make_row_mesh,
    solve_batched_sharded,
    solve_sharded_2d,
    solve_sharded_matvec,
    solve_sharded_matvec_ring,
)


def main() -> None:
    n_dev = min(8, len(jax.devices("cpu")))
    mesh = make_row_mesh(n_dev)
    H = fixtures.hilbert_matrix(1024)

    # Row-sharded solve: per-round all_gather of the O(n) vector.
    res = solve_sharded_matvec(H, mesh)
    print(
        f"sharded ({n_dev} devices): λ = {float(res.eigenvalue):.5f}, "
        f"rounds = {int(res.rounds)} (expect {fixtures.HILBERT_ROUNDS[1024]})"
    )

    # Ring-pipelined: ppermute chunk rotation overlapped with chunk GEMVs.
    res_ring = solve_sharded_matvec_ring(H, mesh)
    print(f"ring:     λ = {float(res_ring.eigenvalue):.5f}, rounds = {int(res_ring.rounds)}")

    # 2D block sharding: per-chip memory n²/(pr·pc) — the layout for n
    # too large even for full-row shards.
    if n_dev % 2 == 0:
        pr, pc = 2, n_dev // 2
        res_2d = solve_sharded_2d(H, make_mesh2d(pr, pc))
        print(
            f"2D {pr}x{pc}:   λ = {float(res_2d.eigenvalue):.5f}, "
            f"rounds = {int(res_2d.rounds)}"
        )

    # Batched (DP): independent matrices, batch axis sharded.
    rng = np.random.default_rng(0)
    mats = rng.random((2 * n_dev, 256, 256), dtype=np.float32) + 1e-4
    mesh_b = make_row_mesh(n_dev, axis_name="batch")
    res_b = solve_batched_sharded(np.asarray(mats), mesh_b)
    print(
        f"batched:  {mats.shape[0]} × 256² solves, "
        f"rounds = {np.asarray(res_b.rounds).tolist()}"
    )

    # Checkpointed long solve: 4-round chunks, resumable snapshot on disk.
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        res_c = checkpoint.solve_checkpointed(
            H, chunk_rounds=4, checkpoint_path=f"{d}/eigen_solve.npz"
        )
    print(f"checkpointed: λ = {float(res_c.eigenvalue):.5f}, rounds = {int(res_c.rounds)}")


if __name__ == "__main__":
    main()
