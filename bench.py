"""Headline benchmark: the default solve of the reference's flagship workload.

Solves the 8192² float32 Hilbert matrix (the reference's own benchmark,
BASELINE.md) through the auto route on one GPU and prints one JSON line:
per-solve wall time (host clock around ``block_until_ready``, compile
excluded), rounds, λ, the eigen-pair residual, and the device.  A machine
without a GPU is an error, never a CPU number under a device name.

    python bench.py            # BENCH_DIM=… overrides the dimension
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

BASELINE_MS = 126.0  # reference best-CPU 8192² e2e (BASELINE.md)
DIM = int(os.environ.get("BENCH_DIM", "8192"))
REPEATS = 20


def make_record(
    times_ms, rounds, eigenvalue, residual, dim, backend, device, peak_gbps
) -> dict:
    """The benchmark's JSON record from its measurements.  Bytes per solve
    are the (rounds + 1) dense products of the matvec form, each reading
    A once."""
    from eigen_value import fixtures

    med = statistics.median(times_ms)
    nbytes = (rounds + 1) * dim * dim * 4
    gbps = nbytes / (med * 1e-3) / 1e9
    return {
        "metric": f"hilbert_{dim}_f32_solve_ms",
        "value": med,
        "ms_min": min(times_ms),
        "ms_all": list(times_ms),
        "vs_baseline": BASELINE_MS / med,
        "rounds": rounds,
        "rounds_ok": rounds == fixtures.HILBERT_ROUNDS.get(dim, rounds),
        "eigenvalue": eigenvalue,
        "residual": residual,
        "backend": backend,
        "achieved_gbps": gbps,
        "pct_of_peak_bandwidth": 100.0 * gbps / peak_gbps,
        "device": device,
    }


def main() -> int:
    import jax
    import jax.numpy as jnp

    from eigen_value import fixtures
    from eigen_value.api import _solve_fn, resolve_backend
    from eigen_value.config import DEFAULT_CONFIG
    from eigen_value.ops.solver_matvec import dot_f32
    from eigen_value.utils.aot import enable_persistent_cache
    from eigen_value.utils.timing import device_peak

    enable_persistent_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(
            json.dumps({"error": f"no GPU found (default platform {dev.platform!r})"}),
            file=sys.stderr,
        )
        return 2
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    peak = device_peak(dev)  # an unknown card raises here, before measuring

    backend = resolve_backend(DEFAULT_CONFIG)
    solve = jax.jit(_solve_fn(DEFAULT_CONFIG, backend))
    H = jax.block_until_ready(fixtures.hilbert_matrix(DIM))
    res = jax.block_until_ready(solve(H))  # compile + warm
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(solve(H))
        times.append((time.perf_counter() - t0) * 1e3)
    v = res.eigenvector
    residual = float(jnp.max(jnp.abs(dot_f32(H, v) - res.eigenvalue * v)))
    rec = make_record(
        times, int(res.rounds), float(res.eigenvalue), residual, DIM, backend,
        device, peak.hbm_gbps,
    )
    print(json.dumps(rec))
    return 0 if rec["rounds_ok"] and bool(res.converged) else 1


if __name__ == "__main__":
    sys.exit(main())
