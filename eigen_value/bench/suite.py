"""Benchmark suite — the equivalent of the reference's benchmark layer.

Mirrors the reference's surface (benchmarks/benchmark_similarity_transform.cpp:
11 ``benchmark_*`` functions; driver main.cpp:7-162): an end-to-end sweep
over 128²..8192² plus per-kernel sweeps, with the same optimization-ladder
idea — the reference benchmarked 3 variants of its reductions (naive
atomics → subgroup reduce → hierarchical), we benchmark the backend ladder
(iterated XLA → matvec form → reduced-precision storage → symmetric
kernel).

Additions over the reference: achieved-bandwidth / %-of-peak columns on a
GPU (peaks from utils/timing.device_peak, keyed by ``device_kind``), and
per-solve device time by chained differencing (utils/timing.py), which
cancels the fixed per-call dispatch cost.  Every row is taken on the
platform the process runs on; CPU rows carry no roofline column.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import jax
import jax.numpy as jnp

from .. import fixtures
from ..config import EPS, MAX_ITR
from ..device import platform
from ..ops.solver import solve_xla, stop_check
from ..ops.solver_matvec import (
    dot_f32,
    solve_matvec,
    solve_matvec_storage,
    solve_matvec_symmetric,
    solve_multiround,
)
from ..utils.timing import device_peak, roofline_pct, time_call, time_marginal

MATRIX_DIMS = [1 << p for p in range(7, 14)]  # 128 .. 8192 (main.cpp:23)
VECTOR_SIZES = [1 << p for p in range(16, 26, 3)]  # 2^16..2^25 (main.cpp:78)

E2E_BACKENDS: Dict[str, Callable] = {
    "xla": lambda A, ev0=None: solve_xla(A, EPS, MAX_ITR, ev0=ev0),
    "matvec": lambda A, ev0=None: solve_matvec(A, EPS, MAX_ITR, ev0=ev0),
    "matvec_bf16": lambda A, ev0=None: solve_matvec_storage(A, EPS, MAX_ITR, ev0=ev0),
    # chunk tuned to the family's known round count + 1 (hardware-
    # independent, reference README tables) — a shape-style tuning
    # constant, not a stopping rule
    "multiround": lambda A, ev0=None: solve_multiround(
        A,
        EPS,
        MAX_ITR,
        chunk=fixtures.HILBERT_ROUNDS.get(A.shape[0], 17) + 1,
        ev0=ev0,
    ),
    # the upper-triangle kernel on the (symmetric by construction)
    # Hilbert workload; it compiles for a GPU only (GPU_ONLY below)
    "symmetric": lambda A, ev0=None: solve_matvec_symmetric(
        A, EPS, MAX_ITR, ev0=ev0
    ),
}

#: Rungs that run a Pallas kernel, which compiles for a GPU only: on other
#: platforms bench_e2e records an explicit skip row.
GPU_ONLY = {"symmetric"}


def _peak_gbps():
    """Published peak memory bandwidth of the device the suite runs on, or
    None on the CPU (no roofline there).  An unknown GPU raises."""
    if platform() != "gpu":
        return None
    return device_peak().hbm_gbps


def _e2e_chain_step(fn):
    """Chain step for marginal e2e timing: solve k+1 depends on solve k
    through the ev0 start vector (1 + λ·1e-38 is exactly 1.0f at runtime —
    the iteration is also scale-invariant in ev — but the data dependence
    defeats hoisting/CSE of the chained solves).  A travels in the chain
    STATE so it is a jit argument, never a closure capture (a captured
    8192² matrix would be embedded in the program as a constant).

    The carried scalar must mix in ``eigenvector[0]``, not just λ: in the
    ITERATED solver (xla) λ = v[0] comes from the mutated A
    and never reads ev, so a λ-only carry lets XLA's while-loop
    simplifier DCE the ev carry, making the whole solve fori-invariant —
    it gets hoisted out of the timing chain and the marginal reads ~0
    (an 8192² iterated row once read "device_ms: 0.0").  ev[0] multiplies
    ev0 through every round in both solver forms, so carrying it keeps a
    loop-varying use of ev0 alive.  The 1e-38 scale keeps the carry
    numerically equal to λ."""

    def step(i, state):
        A, acc = state
        s = jnp.float32(1.0) + acc * jnp.float32(1e-38)
        ev0 = jnp.ones((A.shape[0],), jnp.float32) * s
        r = fn(A, ev0)
        acc2 = r.eigenvalue.astype(jnp.float32) + r.eigenvector[0].astype(
            jnp.float32
        ) * jnp.float32(1e-38)
        return (A, acc2)

    return step


def _operator_chain_step(fn, n: int):
    """Chain step for marginal matrix-free timing — the operator analog of
    :func:`_e2e_chain_step`.  Operators capture their structure (FFT
    profile, Kron factors, ELL tables are small), so only the ev0 start
    vector travels in the chain; the carry mixes in ``eigenvector[0]``
    alongside λ for the same anti-hoist reason documented there."""

    def step(i, acc):
        sc = jnp.float32(1.0) + acc * jnp.float32(1e-38)
        r = fn(jnp.ones((n,), jnp.float32) * sc)
        return r.eigenvalue.astype(jnp.float32) + r.eigenvector[0].astype(
            jnp.float32
        ) * jnp.float32(1e-38)

    return step


def _marginal_resolved(
    step, init, k: int, reps: int = 5, min_signal_ms: float = 4.0,
    max_k: int = 4096,
):
    """``time_marginal`` with RESOLUTION escalation: the chain length
    quadruples until the measured long-vs-short wall difference
    (``dev_ms · k``) clears ``min_signal_ms`` — comfortably above the
    host clock's jitter — so a committed timing is always a real number,
    never the clamped-to-zero artifact of a solve faster than the chain
    can resolve.  Returns
    ``(device_ms | None, k_used, resolved)``: when even ``max_k`` chained
    solves stay under the signal floor the timing is reported as None
    with ``resolved=False`` rather than a fabricated number."""
    while True:
        ms = time_marginal(step, init, k=k, reps=reps)
        if ms * k >= min_signal_ms:
            return ms, k, True
        if k >= max_k:
            return None, k, False
        k = min(k * 4, max_k)


def _e2e_chain_len(n: int) -> int:
    """Longer chains at smaller dims so per-call jitter divided by k stays
    well under the per-solve device time."""
    if n <= 256:
        return 32
    if n <= 1024:
        return 16
    if n <= 2048:
        return 8
    return 4


def bench_e2e(
    dims: List[int] = MATRIX_DIMS,
    backends: List[str] | None = None,
    reps: int = 5,
) -> List[dict]:
    """End-to-end Hilbert solves (reference benchmark_similarity_transform,
    benchmarks/...cpp:3-22; table format of README.md:70-76).

    ``device_ms`` is measured by CHAINED differencing (time_marginal over
    a k-solve data-dependent chain), so the fixed per-call dispatch cost
    cancels.  The raw single-call wall (``ms``, host clock around
    ``block_until_ready``) is kept beside it."""
    rows = []
    plat = platform()
    for name in backends or list(E2E_BACKENDS):
        fn = E2E_BACKENDS[name]
        for n in dims:
            if name in GPU_ONLY and plat != "gpu":
                rows.append(
                    {
                        "bench": "e2e",
                        "backend": name,
                        "dim": n,
                        "skipped": (
                            f"the Pallas kernel compiles for a GPU only; "
                            f"this run is on {plat!r}"
                        ),
                    }
                )
                continue
            A = fixtures.hilbert_matrix(n)
            res = fn(A)  # compile + warm
            rounds = int(res.rounds)
            ms = time_call(lambda: fn(A), reps=reps)
            dev_ms, chain_k, resolved = _marginal_resolved(
                _e2e_chain_step(fn),
                (A, jnp.float32(0.0)),
                k=_e2e_chain_len(n),
                reps=reps,
            )
            row = {
                "bench": "e2e",
                "backend": name,
                "dim": n,
                "ms": ms,
                "device_ms": dev_ms,
                "ms_per_round": dev_ms / max(rounds, 1) if resolved else None,
                # north-star metric: elements touched per second per chip
                # (matvec form touches n² once per round)
                "elems_per_s": (
                    rounds * n * n / (dev_ms * 1e-3) if resolved else None
                ),
                "rounds": rounds,
                "eigenvalue": float(res.eigenvalue),
                # bf16 STORAGE backends carry the documented ±1 round
                # accumulation-order tolerance (solve_matvec_storage)
                "rounds_ok": (
                    abs(rounds - fixtures.HILBERT_ROUNDS.get(n, rounds))
                    <= (1 if "bf16" in name else 0)
                ),
                "chain_k": chain_k,
            }
            if not resolved:
                row["below_resolution"] = True
            rows.append(row)
    return rows


def bench_native(dims: List[int] = MATRIX_DIMS) -> List[dict]:
    """End-to-end sweep through the native C++ runtime (the reference-
    architecture CPU datapoint from this repo; ABI parity with the
    reference's libsimilarity_transform.so)."""
    import numpy as np

    from .. import native

    if not native.available():
        return []
    solver = native.NativeEigenValue()
    rows = []
    for n in dims:
        H = np.asarray(fixtures.hilbert_matrix(n))
        for form, matvec in (("cpu_native", False), ("cpu_native_matvec", True)):
            lam, vec, ms, rounds = solver.similarity_transform(H, matvec_form=matvec)
            rows.append(
                {
                    "bench": "native",
                    "backend": form,
                    "dim": n,
                    "ms": float(ms),
                    "rounds": rounds,
                    "eigenvalue": float(lam),
                    "rounds_ok": rounds == fixtures.HILBERT_ROUNDS.get(n, rounds),
                }
            )
    for name in ("row_sums", "next_matrix", "matvec"):
        for n in dims:
            rows.append(
                {
                    "bench": "native_kernel",
                    "kernel": f"native_{name}",
                    "dim": n,
                    "ms": solver.bench_kernel_us(name, n) / 1e3,
                }
            )
    return rows


def bench_sharded(
    dim: int = 4096,
    shard_counts: List[int] | None = None,
    reps: int = 5,
) -> List[dict]:
    """Row-sharded strong-scaling sweep: same dim solved on meshes of
    increasing size; reports elems/s and scaling efficiency vs the first
    measured shard count (1 with the default counts; north-star: ≥80%
    weak-scaling at ≥2 hosts — this is the single-host/strong-scaling
    analog runnable on any device set)."""
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ..config import DEFAULT_CONFIG
    from ..parallel.sharded import solve_sharded_matvec, solve_sharded_matvec_ring

    d = jax.config.jax_default_device
    devs = jax.devices(d.platform) if d is not None else jax.devices()
    counts = shard_counts or [p for p in (1, 2, 4, 8) if p <= len(devs)]
    A = fixtures.hilbert_matrix(dim)
    rows = []
    for solver_name, solver in (
        ("matvec_gather", solve_sharded_matvec),
        ("matvec_ring", solve_sharded_matvec_ring),
    ):
        base_eps = None
        for p in counts:
            mesh = Mesh(np.array(devs[:p]), ("rows",))
            fn = lambda: solver(A, mesh, config=DEFAULT_CONFIG)
            res = fn()
            rounds = int(res.rounds)
            ms = time_call(fn, reps=reps)

            # chained differencing (launch latency cancels): solve k+1
            # depends on solve k through ev0_scale = 1 + λ·1e-38, exactly
            # 1.0f at runtime; A rides the chain state as a jit argument.
            def step(i, state, _solver=solver, _mesh=mesh):
                A_, acc = state
                scale = jnp.float32(1.0) + acc * jnp.float32(1e-38)
                r = _solver(A_, _mesh, config=DEFAULT_CONFIG, ev0_scale=scale)
                return (A_, r.eigenvalue.astype(jnp.float32))

            A_sh = jax.device_put(A, NamedSharding(mesh, P("rows", None)))
            dev_ms = time_marginal(
                step, (A_sh, jnp.float32(0.0)), k=4, reps=reps
            )
            eps_chip = rounds * dim * dim / max(dev_ms * 1e-3, 1e-9) / p
            if base_eps is None:
                # baseline = FIRST measured shard count (1 with the default
                # counts; when a caller passes counts without 1, efficiency
                # is relative to the smallest measured mesh, and the
                # "shards" column says which)
                base_eps = eps_chip
            rows.append(
                {
                    "bench": "sharded",
                    "solver": solver_name,
                    "dim": dim,
                    "shards": p,
                    "ms": ms,
                    "device_ms": dev_ms,
                    "rounds": rounds,
                    "elems_per_s_per_chip": eps_chip,
                    # ideal scaling keeps per-chip throughput flat
                    "scaling_efficiency": eps_chip / base_eps,
                }
            )

    # 2D block sharding (rows × cols): the same balanced factorization the
    # scaling model predicts (scaling_model.balanced_factorization — one
    # definition, so --suite sharded measures exactly the mesh shape
    # --suite model's matvec_2d rows describe).
    from ..parallel.sharded import solve_sharded_2d
    from ..utils.scaling_model import balanced_factorization

    base_eps = None
    for p in counts:
        pr, pc = balanced_factorization(p)
        if dim % pr or dim % pc:
            continue
        mesh = Mesh(np.array(devs[:p]).reshape(pr, pc), ("rows", "cols"))
        fn = lambda: solve_sharded_2d(A, mesh, config=DEFAULT_CONFIG)
        res = fn()
        rounds = int(res.rounds)
        ms = time_call(fn, reps=reps)

        def step(i, state, _mesh=mesh):
            A_, acc = state
            scale = jnp.float32(1.0) + acc * jnp.float32(1e-38)
            r = solve_sharded_2d(A_, _mesh, config=DEFAULT_CONFIG, ev0_scale=scale)
            return (A_, r.eigenvalue.astype(jnp.float32))

        A_sh = jax.device_put(A, NamedSharding(mesh, P("rows", "cols")))
        dev_ms = time_marginal(step, (A_sh, jnp.float32(0.0)), k=4, reps=reps)
        eps_chip = rounds * dim * dim / max(dev_ms * 1e-3, 1e-9) / p
        if base_eps is None:
            base_eps = eps_chip
        rows.append(
            {
                "bench": "sharded",
                "solver": "matvec_2d",
                "dim": dim,
                "shards": p,
                "mesh": f"{pr}x{pc}",
                "ms": ms,
                "device_ms": dev_ms,
                "rounds": rounds,
                "elems_per_s_per_chip": eps_chip,
                "scaling_efficiency": eps_chip / base_eps,
            }
        )
    return rows


def _run_mh_workers(
    num_processes: int,
    local_devices: int,
    dim: int,
    reps: int,
    extra_args: List[str] | None = None,
    timeout_s: float = 600.0,
) -> List[dict]:
    """Spawn ``num_processes`` CPU/gloo mh_worker processes and return
    each worker's JSON record (gloo writes its own diagnostics to stdout,
    so the parser keeps the last JSON line)."""
    import json as _json
    import os
    import socket
    import subprocess
    import sys

    def _free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    # Workers are CPU/gloo processes, never on a card: one process per
    # card is the rule, and these measure the multi-process FLOW.
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    repo_parent = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [repo_parent, env.get("PYTHONPATH")])
    )
    port = _free_port()
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                "-m",
                "eigen_value.bench.mh_worker",
                *(extra_args or []),
                "--process-id",
                str(pid),
                "--num-processes",
                str(num_processes),
                "--coordinator",
                f"127.0.0.1:{port}",
                "--dim",
                str(dim),
                "--local-devices",
                str(local_devices),
                "--reps",
                str(reps),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for pid in range(num_processes)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout_s)
            if p.returncode != 0:
                raise RuntimeError(f"mh_worker failed:\n{err[-2000:]}")
            json_lines = [
                l for l in out.strip().splitlines() if l.startswith("{")
            ]
            if not json_lines:
                raise RuntimeError(
                    f"mh_worker produced no JSON line:\n{out[-2000:]}"
                )
            outs.append(_json.loads(json_lines[-1]))
    finally:
        # a failed/timed-out worker must not leave siblings blocked
        # forever in jax.distributed.initialize
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def bench_multihost(dim: int = 2048, reps: int = 3) -> List[dict]:
    """Multi-process scaling report (BASELINE north star: elems/s at 1 host
    and N≥2 hosts).  Spawns the same total device count as 1 process × 8
    devices and as 2 processes × 4 devices (a simulated 2-host slice with
    a real jax.distributed process group + gloo cross-process collectives);
    efficiency = multi-process throughput / single-process throughput,
    isolating the cross-"host" exchange overhead of the per-round gather.

    NOTE: the workers run on the CPU and their cross-process collective
    backend is gloo over loopback (~ms per round) — the efficiency column
    validates the multi-host FLOW and exposes the exchange count; it is
    not a measurement of NVLink or a network between hosts.
    """
    single = _run_mh_workers(1, 8, dim, reps)[0]
    multi = _run_mh_workers(2, 4, dim, reps)[0]
    multi_2d = _run_mh_workers(2, 4, dim, reps, extra_args=["--solver", "2d"])[0]
    rows = []
    for r, solver in ((single, "gather"), (multi, "gather"), (multi_2d, "2d")):
        rows.append(
            {
                "bench": "multihost",
                "solver": solver,
                "processes": r["num_processes"],
                "global_devices": r["global_devices"],
                "dim": r["dim"],
                "ms": r["ms"],
                "rounds": r["rounds"],
                "elems_per_s": r["elems_per_s"],
                "scaling_efficiency": r["elems_per_s"] / single["elems_per_s"],
                # in-row so the artifact can never be read as a device
                # scaling result without its caveat (the reference's
                # tables always name the hardware, README.md:70-158)
                "transport": "gloo-loopback-emulation",
                "efficiency_note": (
                    "flow validation on CPU workers over loopback gloo "
                    "(~ms per exchange); NOT a device scaling "
                    "measurement — see the suite docstring"
                ),
            }
        )
    return rows


def bench_kernels(dims: List[int] = MATRIX_DIMS, k: int = 64) -> List[dict]:
    """Per-pass marginal timings of the O(n²) passes.

    Ladder (reference analog: row-sum v0/v1/v2, benchmarks/...cpp:24-159):
      rowsum_xla → scale_xla → scale_rowsum_xla (the iterated round) →
      matvec_xla (dense ``dot_f32``) → symv (the upper-triangle kernel,
      GPU only; its bytes are the tiles it reads).

    Read-only passes carry a fused ~1e-38 scalar bias through the chain so
    XLA cannot hoist them; large arrays travel in the chain STATE, never
    as closure captures (which would be embedded as constants).
    """
    from ..ops.pallas import kernels

    peak = _peak_gbps()
    itemsize = 4
    rows = []
    eps32 = jnp.asarray(1e-38, jnp.float32)
    for n in dims:
        A = fixtures.hilbert_matrix(n)
        v = jnp.sum(A, axis=1)
        ones = jnp.ones((n,), jnp.float32)

        def rowsum_xla_step(i, s):
            Ai, vi = s
            return (Ai, jnp.sum(Ai + vi[0] * eps32, axis=1))

        def scale_xla_step(i, s):
            Ai, vi = s
            return (Ai * ((1 / vi)[:, None] * vi[None, :]), vi)

        def scale_rowsum_xla_step(i, s):
            Ai, vi = s
            A2 = Ai * ((1 / vi)[:, None] * vi[None, :])
            return (A2, jnp.sum(A2, axis=1))

        def matvec_xla_step(i, s):
            Ai, xi = s
            return (Ai, dot_f32(Ai, xi) / xi)

        def symv_step(i, s):
            Ai, xi = s
            return (Ai, kernels.symv(Ai, xi) / xi)

        g = -(-n // kernels.SYM_TILE)
        cases = {
            "rowsum_xla": (rowsum_xla_step, (A, v), n * n * itemsize),
            "scale_xla": (
                scale_xla_step,
                (A, fixtures.stop_success_vector(n)),
                2 * n * n * itemsize,
            ),
            "scale_rowsum_xla": (scale_rowsum_xla_step, (A, v), 2 * n * n * itemsize),
            "matvec_xla": (matvec_xla_step, (A, ones), n * n * itemsize),
            "symv": (
                symv_step,
                (A, ones),
                g * (g + 1) // 2 * kernels.SYM_TILE**2 * itemsize,
            ),
        }
        for name, (step, init, nbytes) in cases.items():
            if name == "symv" and platform() != "gpu":
                continue
            ms = time_marginal(step, init, k=k)
            # ms == 0 means the marginal vanished into clock jitter —
            # emit nulls (RFC-safe JSON), not Infinity/NaN
            pct = roofline_pct(ms, nbytes, peak) if ms > 0 and peak else None
            rows.append(
                {
                    "bench": "kernel",
                    "kernel": name,
                    "dim": n,
                    "ms": ms,
                    "gbps": nbytes / (ms * 1e-3) / 1e9 if ms > 0 else None,
                    "roofline_pct": pct,
                }
            )
    return rows


def bench_operator(dims: List[int] = MATRIX_DIMS, reps: int = 5) -> List[dict]:
    """Matrix-free FFT operator vs the dense production path on the
    benchmark family (the Hilbert matrix is Hankel — ops/structured.py).

    Chained per-solve device times (dispatch cost cancels); the point of
    the row pair is the asymptotic gap: O(n log n)/round + O(n) memory vs
    O(n²)/round.  Parity column: operator rounds are allowed ±1 of the
    dense table (FFT rounding differs from the dense reduction order)."""
    from ..ops.solver_matvec import solve_operator
    from ..ops.structured import hilbert_matvec

    rows = []
    for n in dims:
        mv = hilbert_matvec(n)
        fn = jax.jit(
            lambda ev0, _mv=mv, _n=n: solve_operator(
                _mv, _n, EPS, MAX_ITR, ev0=ev0
            )
        )
        res = fn(jnp.ones((n,), jnp.float32))
        rounds = int(res.rounds)

        dev_ms, chain_k, resolved = _marginal_resolved(
            _operator_chain_step(fn, n), jnp.float32(0.0), k=32, reps=reps
        )
        want = fixtures.HILBERT_ROUNDS.get(n, rounds)
        row = {
            "bench": "operator",
            "backend": "hankel_fft",
            "dim": n,
            "device_ms": dev_ms,
            "ms_per_round": dev_ms / max(rounds, 1) if resolved else None,
            "rounds": rounds,
            "eigenvalue": float(res.eigenvalue),
            "rounds_ok": abs(rounds - want) <= 1,
            "chain_k": chain_k,
        }
        if not resolved:
            row["below_resolution"] = True
        rows.append(row)
    # Kronecker operator: B ⊗ C at n = dim via two matmuls — the
    # compute-dense operator rung (O(n·(p+q)) per round vs the FFT rows'
    # O(n log n) and the dense rows' O(n²)); factors are random-positive,
    # λ sanity-pinned to the factor product.
    from ..ops.structured import kron_matvec

    for n in dims:
        p = 1 << ((n - 1).bit_length() // 2)  # p·q = n, p ≤ q, powers of 2
        q = n // p
        if p * q != n:
            continue
        key = jax.random.key(n)
        kb, kc = jax.random.split(key)
        B = jax.random.uniform(kb, (p, p), jnp.float32, minval=0.1, maxval=1.0)
        C = jax.random.uniform(kc, (q, q), jnp.float32, minval=0.1, maxval=1.0)
        from ..ops.solver_matvec import solve_matvec

        lam_prod = float(solve_matvec(B, EPS, MAX_ITR).eigenvalue) * float(
            solve_matvec(C, EPS, MAX_ITR).eigenvalue
        )
        # λ(B⊗C) = λ_B·λ_C reaches 10²–10³ for these random factors; past
        # λ ~ 500 the f32 matvec noise floor (~λ·(p+q)·2⁻²⁴) crowds the
        # ABSOLUTE eps=1e-3 stop — those rows run the scale-invariant
        # relative stop, recorded in the eps_mode column.
        eps_mode = "relative" if lam_prod > 500.0 else "absolute"
        fnk = jax.jit(
            lambda ev0, _B=B, _C=C, _n=n, _m=eps_mode: solve_operator(
                kron_matvec(_B, _C), _n, EPS, MAX_ITR, ev0=ev0, eps_mode=_m
            )
        )
        res = fnk(jnp.ones((n,), jnp.float32))
        rounds = int(res.rounds)

        # a 2-round large-λ kron solve is short enough for a k=32 chain to
        # clamp to 0.0 — _marginal_resolved escalates until it resolves
        dev_ms, chain_k, resolved = _marginal_resolved(
            _operator_chain_step(fnk, n), jnp.float32(0.0), k=32, reps=reps
        )
        row = {
            "bench": "operator",
            "backend": f"kron_{p}x{q}",
            "dim": n,
            "device_ms": dev_ms,
            "ms_per_round": dev_ms / max(rounds, 1) if resolved else None,
            "rounds": rounds,
            "eigenvalue": float(res.eigenvalue),
            "eps_mode": eps_mode,
            # λ(B⊗C) = λ(B)·λ(C) within the method's eps
            "rounds_ok": bool(res.converged)
            and abs(float(res.eigenvalue) - lam_prod) <= 2e-3 * lam_prod,
            "chain_k": chain_k,
        }
        if not resolved:
            row["below_resolution"] = True
        rows.append(row)
    # Sparse ELL operator: random nonnegative matrix with positive diagonal
    # (primitive ⇒ converges) and DEG off-diagonal entries per row, solved
    # through the padded-ELL gather matvec — O(n·DEG)/round, the sparse
    # rung.  Sanity: the returned pair must satisfy the
    # eigen-pair property through the same operator (reference wrapper
    # test's acceptance check, wrapper/python/test.py:15-16).
    import numpy as np

    from ..ops.structured import ell_from_coo, ell_matvec

    DEG = 8
    for n in dims:
        rng = np.random.default_rng(n)
        src = np.repeat(np.arange(n), DEG)
        dst = (src + 1 + rng.integers(0, n - 1, size=src.shape)) % n
        vals = (rng.random(src.shape[0]) + 0.1).astype(np.float32)
        rows_coo = np.concatenate([src, np.arange(n)])
        cols_coo = np.concatenate([dst, np.arange(n)])
        vals_coo = np.concatenate([vals, np.ones(n, np.float32)])
        mv = ell_matvec(*ell_from_coo(rows_coo, cols_coo, vals_coo, n))
        fns = jax.jit(
            lambda ev0, _mv=mv, _n=n: solve_operator(
                _mv, _n, EPS, MAX_ITR, ev0=ev0
            )
        )
        res = fns(jnp.ones((n,), jnp.float32))
        rounds = int(res.rounds)

        dev_ms, chain_k, resolved = _marginal_resolved(
            _operator_chain_step(fns, n), jnp.float32(0.0), k=32, reps=reps
        )
        lam = float(res.eigenvalue)
        resid = float(
            jnp.max(jnp.abs(mv(res.eigenvector) - res.eigenvalue * res.eigenvector))
        )
        row = {
            "bench": "operator",
            "backend": f"sparse_ell_deg{DEG + 1}",
            "dim": n,
            "device_ms": dev_ms,
            "ms_per_round": dev_ms / max(rounds, 1) if resolved else None,
            "rounds": rounds,
            "eigenvalue": lam,
            "rounds_ok": bool(res.converged) and resid <= 1e-2 * max(lam, 1.0),
            "chain_k": chain_k,
        }
        if not resolved:
            row["below_resolution"] = True
        rows.append(row)
    # the dense production rows for the same dims, for the side-by-side
    rows += [
        dict(r, bench="operator")
        for r in bench_e2e(dims, backends=["matvec"], reps=reps)
    ]
    return rows


def bench_batched(
    batch: int = 256, dim: int = 512, reps: int = 5, chain: int = 4
) -> List[dict]:
    """Batched-throughput rung — BASELINE config 4: ``batch`` independent
    random-positive ``dim``² float32 solves as ONE vmapped device program
    (parallel/batched.solve_batched; reference analog: the wrapper test's
    Python loop over independent matrices, wrapper/python/test.py:13).

    Chained differencing over whole-batch solves; reports solves/s and the
    per-matrix round histogram (per-matrix convergence differs — the
    masked while_loop freezes finished matrices).  ``rounds_ok`` pins the
    batched eigen-pair property: max over the batch of
    |A·v − λ·v|/λ ≤ 2e-3 (reference acceptance: atol 1e-3 at λ≈2.6,
    wrapper/python/test.py:15-16 — scaled to these λ ≈ dim/2 workloads).
    """
    import numpy as np

    from ..api import eigen_residual
    from ..parallel.batched import solve_batched

    key = jax.random.key(4)  # config-4 workload, deterministic
    As = jax.random.uniform(
        key, (batch, dim, dim), jnp.float32, minval=0.05, maxval=1.0
    )
    As = jax.block_until_ready(As)

    res = solve_batched(As, EPS, MAX_ITR)  # compile + warm
    rounds = np.asarray(res.rounds)
    lam = np.asarray(res.eigenvalue)
    resid = np.asarray(
        jax.vmap(lambda A, r: eigen_residual(A, r) / r.eigenvalue)(As, res)
    )

    def step(i, state):
        As_, acc = state
        s = jnp.float32(1.0) + acc * jnp.float32(1e-38)
        r = solve_batched(As_, EPS, MAX_ITR, ev0=jnp.ones((dim,), jnp.float32) * s)
        acc2 = r.eigenvalue[0].astype(jnp.float32) + r.eigenvector[
            0, 0
        ].astype(jnp.float32) * jnp.float32(1e-38)
        return (As_, acc2)

    dev_ms = time_marginal(step, (As, jnp.float32(0.0)), k=chain, reps=reps)
    hist = {int(k_): int(v) for k_, v in zip(*np.unique(rounds, return_counts=True))}
    return [
        {
            "bench": "batched",
            "batch": batch,
            "dim": dim,
            "device_ms_per_batch": dev_ms,
            "solves_per_s": batch / max(dev_ms * 1e-3, 1e-9),
            "rounds_hist": hist,
            "all_converged": bool(np.asarray(res.converged).all()),
            "max_rel_residual": float(resid.max()),
            "lambda_range": [float(lam.min()), float(lam.max())],
            "rounds_ok": bool(np.asarray(res.converged).all())
            and float(resid.max()) <= 2e-3,
        }
    ]


def bench_large(reps: int = 3) -> List[dict]:
    """Max-size single-device rungs: 32768² float32 (4 GiB) dense and
    through the symmetric kernel (GPU only), and 65536² bfloat16 (8 GiB,
    generated on the device directly in bf16).  Hilbert is generated on
    device (fused iota — fixtures.hilbert_matrix); λ is checked against
    the family's values (λ_n grows ~ln n).  Short chains: each solve
    reads tens of GB, so dispatch jitter is negligible but wall time is
    not."""
    import gc
    import time as _time

    rows = []
    configs = [
        ("f32_32768", 32768, jnp.float32, 20, 2.67650, False),
        ("sym_f32_32768", 32768, jnp.float32, 20, 2.67650, True),
        ("bf16_65536", 65536, jnp.bfloat16, 21, 2.70946, False),
    ]
    for name, n, dt, want_rounds, want_lam, sym in configs:
        if sym and platform() != "gpu":
            continue
        A = res = fn = None
        try:
            A = jax.block_until_ready(fixtures.hilbert_matrix(n, dtype=dt))
            if sym:
                fn = jax.jit(
                    lambda A, ev0: solve_matvec_symmetric(A, EPS, MAX_ITR, ev0=ev0)
                )
            elif dt == jnp.float32:
                fn = jax.jit(lambda A, ev0: solve_matvec(A, EPS, MAX_ITR, ev0=ev0))
            else:
                fn = jax.jit(
                    lambda A, ev0: solve_matvec_storage(
                        A, EPS, MAX_ITR, storage_dtype=jnp.bfloat16, ev0=ev0
                    )
                )
            res = fn(A, None)
            rounds = int(res.rounds)
            lam = float(res.eigenvalue)

            # Bespoke chain: A is a jit ARGUMENT and only the scalar carry
            # crosses the fori state — time_marginal's shape-preserving
            # state would return a full-size copy of A per invocation.
            def chain(m, _fn=fn, _n=n):
                @jax.jit
                def run(A_, acc):
                    def step(i, a):
                        sc = jnp.float32(1.0) + a * jnp.float32(1e-38)
                        r = _fn(A_, jnp.ones((_n,), jnp.float32) * sc)
                        return r.eigenvalue.astype(jnp.float32) + r.eigenvector[
                            0
                        ].astype(jnp.float32) * jnp.float32(1e-38)

                    return jax.lax.fori_loop(0, m, step, acc)

                return run

            run1, run3 = chain(1), chain(3)
            z = jnp.float32(0.0)
            jax.block_until_ready(run1(A, z))
            jax.block_until_ready(run3(A, z))
            t1 = t3 = float("inf")
            for _ in range(reps):
                s0 = _time.perf_counter()
                jax.block_until_ready(run1(A, z))
                t1 = min(t1, (_time.perf_counter() - s0) * 1e3)
                s0 = _time.perf_counter()
                jax.block_until_ready(run3(A, z))
                t3 = min(t3, (_time.perf_counter() - s0) * 1e3)
            dev_ms = max(t3 - t1, 0.0) / 2
            rows.append(
                {
                    "bench": "large",
                    "backend": name,
                    "dim": n,
                    "device_ms": dev_ms,
                    "ms_per_round": dev_ms / max(rounds, 1),
                    "rounds": rounds,
                    "eigenvalue": lam,
                    "converged": bool(res.converged),
                    # the family's round counts ±1 (f32 summation order;
                    # bf16 storage tolerance, solver_matvec.py)
                    "rounds_ok": abs(rounds - want_rounds) <= 1
                    and abs(lam - want_lam) <= 2e-3 * want_lam,
                }
            )
        except Exception as e:  # pragma: no cover - OOM/platform guard
            rows.append(
                {"bench": "large", "backend": name, "dim": n, "error": str(e)}
            )
        finally:
            # free THIS config's matrix before the next one is generated
            if A is not None:
                A.delete()
            A = res = fn = None  # noqa: F841
            gc.collect()
    return rows


def bench_vector_kernels(sizes: List[int] = VECTOR_SIZES, k: int = 256) -> List[dict]:
    """The O(n) kernels (find_max, eigvec update, stop) at vector sizes
    2^16..2^25 (reference main.cpp:78).  Marginal chained timings; each
    chain includes the data-dependence glue, so treat as upper bounds —
    inside a solve these fuse into the n² passes and cost ~nothing
    (SURVEY.md §7).
    """
    peak = _peak_gbps()
    rows = []
    eps32 = jnp.asarray(1e-38, jnp.float32)
    for n in sizes:
        v = jax.random.uniform(jax.random.key(0), (n,), jnp.float32) + 0.5
        ev = jnp.ones((n,), jnp.float32)

        # chains stay data-dependent via a fused scalar bias (~1e-38), which
        # XLA folds into the same pass — no extra traffic, no hoisting
        def find_max_step(i, s):
            vi, acc = s
            return (vi, jnp.max(vi + acc * eps32))

        def eigvec_step(i, s):
            vi, evi = s
            vdep = vi + evi[0] * eps32
            return (vi, evi * (vdep / jnp.max(vdep)))

        def stop_step(i, s):
            vi, acc = s
            return (vi, stop_check(vi + acc * eps32, EPS).astype(jnp.float32))

        cases = {
            # find_max (cpp:154-227): read v
            "find_max": (find_max_step, (v, jnp.float32(0.0)), n * 4),
            # eigvec update (cpp:229-265): read v+ev, write ev
            "eigen_vector": (eigvec_step, (v, ev), 3 * n * 4),
            # stop criterion (cpp:332-460): read v
            "stop": (stop_step, (v, jnp.float32(0.0)), n * 4),
        }
        for name, (step, init, nbytes) in cases.items():
            ms = time_marginal(step, init, k=k)
            rows.append(
                {
                    "bench": "vector_kernel",
                    "kernel": name,
                    "size": n,
                    "ms": ms,
                    # None off the GPU or for a sub-jitter marginal (JSON null)
                    "roofline_pct": (
                        roofline_pct(ms, nbytes, peak) if ms > 0 and peak else None
                    ),
                }
            )
    return rows
