"""Multi-process worker — one simulated "host" of the multi-host flow.

The single home of the multi-process bootstrap dance (env pinned before
jax import, host-local Hilbert row block, assemble_rowsharded): spawned
by ``bench_multihost`` (suite.py) for the scaling report AND by
tests/test_multihost.py for the 2-process parity test.  Standalone:

    python -m eigen_value.bench.mh_worker --process-id 0 \
        --num-processes 2 --coordinator 127.0.0.1:PORT --dim 2048

Each process owns ``--local-devices`` virtual CPU devices and ONLY its own
contiguous block of Hilbert rows (the host-local placement of the real
multi-host flow, parallel/multihost.py); emits one JSON line with the
solve result, the global eigen-pair residual, and min wall time over
``--reps`` timed solves.  With ``--num-processes 1`` no process group is
formed — the single-"host" baseline for scaling efficiency.
"""

import argparse
import json
import os
import sys
import time


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--dim", type=int, default=2048)
    p.add_argument("--local-devices", type=int, default=4)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument(
        "--solver",
        choices=["gather", "ring", "2d"],
        default="gather",
        help="per-round exchange: all_gather, ring-pipelined ppermute, or "
        "2D block sharding (psum along local devices + rows gather)",
    )
    args = p.parse_args()

    # Env must be pinned before jax import (same dance as tests/conftest.py).
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.local_devices}"
        ).strip()
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from eigen_value.parallel import multihost, solve_sharded_matvec_ring

    if args.num_processes > 1:
        multihost.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
    # The workers run on the CPU only: a card is driven by one process.
    if args.solver == "2d":
        mesh = multihost.make_global_mesh2d(platform="cpu")
    else:
        mesh = multihost.make_global_row_mesh(platform="cpu")

    # This process's row block of the Hilbert matrix, generated locally
    # with the fixture's exact arithmetic (int divisor, f32 reciprocal —
    # fixtures.hilbert_matrix / reference utils.cpp:137-154).
    n = args.dim
    n_local = n // args.num_processes
    row0 = args.process_id * n_local
    r = np.arange(row0, row0 + n_local, dtype=np.int32)[:, None]
    c = np.arange(n, dtype=np.int32)[None, :]
    local_rows = np.float32(1.0) / (r + c + 1).astype(np.float32)
    if args.solver == "2d":
        from eigen_value.parallel import solve_sharded_2d

        A = multihost.assemble_blocksharded(local_rows, mesh)
    else:
        A = multihost.assemble_rowsharded(local_rows, mesh)

    def solve():
        if args.solver == "2d":
            return jax.block_until_ready(solve_sharded_2d(A, mesh))
        if args.solver == "ring":
            return jax.block_until_ready(solve_sharded_matvec_ring(A, mesh))
        return jax.block_until_ready(multihost.solve_multihost(A, mesh=mesh))

    res = solve()  # warm / compile
    ts = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        res = solve()
        ts.append((time.perf_counter() - t0) * 1e3)
    ms = min(ts) if ts else float("nan")
    lam, rounds = float(np.asarray(res.eigenvalue)), int(res.rounds)

    # Global eigen-pair residual max|A·v − λ·v| computed on the mesh
    # (A stays row-sharded; GSPMD inserts the ev all-gather).
    residual = jax.jit(
        lambda A, ev, lam: jnp.max(
            jnp.abs(
                jnp.dot(A, ev, precision=jax.lax.Precision.HIGHEST) - lam * ev
            )
        ),
        out_shardings=NamedSharding(mesh, P()),
    )(A, res.eigenvector, res.eigenvalue)

    print(
        json.dumps(
            {
                "process_id": args.process_id,
                "num_processes": len({d.process_index for d in mesh.devices.flat}),
                "global_devices": len(mesh.devices.flat),
                "dim": n,
                "rounds": rounds,
                "eigenvalue": lam,
                "converged": bool(res.converged),
                "residual": float(residual),
                "ms": ms,
                "elems_per_s": multihost.elems_per_second(n, rounds, ms * 1e-3),
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
