"""Smoke test of the solver on one NVIDIA GPU: the main path, at full size,
through the entry points a user calls.

    python chip_smoke.py           # one card: phases 1-5
    python chip_smoke.py --four    # four cards: the sharded path only

Phases (one card): 1 device and card, 2 the 8192² Hilbert solve through
``max_eigenvalue`` and ``EigenValue`` against the float64 host oracle,
3 a 65536² (16 GiB) solve generated on the device, 4 each hand-written
kernel compiled at those widths, checked against the plain product and
timed against XLA's, 5 bf16 storage.  ``--four``: a 131072² (64 GiB)
row-sharded solve, and the gather, ring and 2D bodies at 32768² against
the one-card solve of the same matrix.

Any failure exits non-zero before the last line; the last line is
``{"ok": true, "device": {...}}``.  Without a GPU it exits 2 and prints
no result.  One process drives every card; ``nvidia-smi`` runs in a
child that never touches JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

#: Tolerances, each with its reason.
#: λ of the f32 solve vs the float64 oracle: both stop at the same round
#: with eps = 1e-3 on row-sum differences, so λ agrees to f32 rounding of
#: an 8192-term sum (~1e-6); 1e-4 leaves room and still catches a
#: wrong round (λ moves ~1e-4 per round at 17 rounds).
LAM_REL_F64 = 1e-4
#: max |Hv − λv|: the reference wrapper test's acceptance bound
#: (wrapper/python/test.py:15-16), computed at Precision.HIGHEST.
RESIDUAL_MAX = 1e-3
#: bf16 storage: entries keep 8 bits of mantissa, λ moves ~1e-3 relative.
LAM_REL_BF16 = 2e-3
#: A kernel's product vs XLA's dense f32 product: different f32 summation
#: order over ≤65536 terms (~n·2⁻²⁴ relative in the worst case).
PRODUCT_REL = 1e-5
#: Sharded vs one-card λ: the same iteration, with row sums grouped
#: differently across cards (ring, 2D) — f32 reordering only.
LAM_REL_SHARDED = 1e-5


def card_info() -> list[str]:
    """Name and power limit of every card, as nvidia-smi reports them,
    from a child process that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def final_line(devices) -> str:
    """The last line of a passing run: the device as JAX reports it."""
    d = devices[0]
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": d.platform,
                "kind": d.device_kind,
                "count": len(devices),
            },
        }
    )


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn, *args, reps: int = 5) -> float:
    """Median host wall time of ``fn(*args)``, ended by block_until_ready."""
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def in_turns(plain, kernel, *args, reps: int = 5):
    """Time plain, kernel, kernel, plain; returns both pairs."""
    p1 = median_ms(plain, *args, reps=reps)
    k1 = median_ms(kernel, *args, reps=reps)
    k2 = median_ms(kernel, *args, reps=reps)
    p2 = median_ms(plain, *args, reps=reps)
    return (p1, p2), (k1, k2)


def residual(A, lam, v) -> float:
    import jax.numpy as jnp

    from eigen_value.ops.solver_matvec import dot_f32

    return float(jnp.max(jnp.abs(dot_f32(A, v) - lam * v)))


def phase_flagship(n: int = 8192):
    """Hilbert n² f32 through both public entries with default config."""
    import jax
    import numpy as np

    from eigen_value import DEFAULT_CONFIG, EigenValue, fixtures, max_eigenvalue
    from eigen_value.api import _solve_fn, resolve_backend, uses_symmetric_kernel
    from eigen_value.reference_impl import parallel_oracle

    want_rounds = fixtures.HILBERT_ROUNDS[n]
    backend = resolve_backend(DEFAULT_CONFIG)
    print(
        f"[2] backend {backend!r}, symmetric kernel "
        f"{uses_symmetric_kernel(DEFAULT_CONFIG)}",
        flush=True,
    )
    H = jax.block_until_ready(fixtures.hilbert_matrix(n))
    compiled = jax.jit(_solve_fn(DEFAULT_CONFIG, backend)).lower(H).compile()
    print(f"[2] memory_analysis: {compiled.memory_analysis()}", flush=True)

    r = np.arange(n, dtype=np.float64)
    t0 = time.perf_counter()
    ref = parallel_oracle(1.0 / (r[:, None] + r[None, :] + 1.0), dtype=np.float64)
    print(
        f"[2] float64 host oracle: lambda {ref.eigenvalue:.10f}, "
        f"{ref.rounds} rounds ({time.perf_counter() - t0:.1f} s)",
        flush=True,
    )

    res = jax.block_until_ready(max_eigenvalue(H))
    lam, rounds = float(res.eigenvalue), int(res.rounds)
    res_err = residual(H, res.eigenvalue, res.eigenvector)
    rel = abs(lam - ref.eigenvalue) / ref.eigenvalue
    print(
        f"[2] max_eigenvalue: lambda {lam:.7f} rounds {rounds} rel_to_f64 "
        f"{rel:.2e} residual {res_err:.2e}",
        flush=True,
    )
    check(rounds == want_rounds, f"max_eigenvalue rounds {rounds} != {want_rounds}")
    check(bool(res.converged), "max_eigenvalue did not converge")
    check(rel <= LAM_REL_F64, f"lambda {rel:.2e} from the f64 oracle")
    check(res_err <= RESIDUAL_MAX, f"residual {res_err:.2e}")

    ev = EigenValue()
    ev.warmup([n])
    lam2, vec2, ts_ms, rounds2 = ev.similarity_transform(H)
    res2 = residual(H, float(lam2), jax.numpy.asarray(vec2))
    rel2 = abs(float(lam2) - ref.eigenvalue) / ref.eigenvalue
    print(
        f"[2] EigenValue.similarity_transform: lambda {float(lam2):.7f} rounds "
        f"{rounds2} ts_ms {ts_ms:.4f} rel_to_f64 {rel2:.2e} residual {res2:.2e}",
        flush=True,
    )
    check(rounds2 == want_rounds, f"EigenValue rounds {rounds2} != {want_rounds}")
    check(rel2 <= LAM_REL_F64, f"EigenValue lambda {rel2:.2e} from the f64 oracle")
    check(res2 <= RESIDUAL_MAX, f"EigenValue residual {res2:.2e}")
    return H, lam


def phase_card_scale(n: int = 65536):
    """A 16 GiB f32 Hilbert matrix made on the device and solved."""
    import jax

    from eigen_value import fixtures, max_eigenvalue

    H = jax.block_until_ready(fixtures.hilbert_matrix(n))
    t0 = time.perf_counter()
    res = jax.block_until_ready(max_eigenvalue(H))
    wall = time.perf_counter() - t0
    err = residual(H, res.eigenvalue, res.eigenvector)
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    print(
        f"[3] {n}^2 f32: lambda {float(res.eigenvalue):.7f} rounds "
        f"{int(res.rounds)} converged {bool(res.converged)} residual {err:.2e} "
        f"first call {wall:.2f} s peak_bytes_in_use {peak}",
        flush=True,
    )
    check(bool(res.converged), f"{n}^2 solve did not converge")
    check(err <= RESIDUAL_MAX, f"{n}^2 residual {err:.2e}")
    return H


def copy_gbps(A, reps: int = 5) -> float:
    """Read + write bandwidth of an elementwise pass over ``A``."""
    import jax

    f = jax.jit(lambda a: a * 1.0000001)
    jax.block_until_ready(f(A))
    ms = median_ms(f, A, reps=reps)
    return 2 * A.size * A.dtype.itemsize / (ms * 1e-3) / 1e9


def kernel_checks(H, passes: int = 20, reps: int = 5) -> dict:
    """The symmetric kernel at H's width: one comparison with the plain
    product, then per-pass and end-to-end times against XLA's, in turns."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    from eigen_value.config import EPS, MAX_ITR
    from eigen_value.ops.pallas import kernels
    from eigen_value.ops.solver_matvec import (
        dot_f32,
        solve_matvec,
        solve_matvec_symmetric,
    )

    n = H.shape[0]
    x = jnp.ones((n,), jnp.float32)
    want = np.asarray(dot_f32(H, x), np.float64)
    got = np.asarray(jax.jit(kernels.symv)(H, x), np.float64)
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    check(rel <= PRODUCT_REL, f"symv at {n}: {rel:.2e} from the dense product")

    def chain(product):
        @jax.jit
        def run(A, x):
            def body(i, x):
                y = product(A, x)
                return y / jnp.max(y)

            return lax.fori_loop(0, passes, body, x)

        return run

    plain_pass, kern_pass = chain(dot_f32), chain(kernels.symv)
    plain_e2e = jax.jit(lambda A: solve_matvec(A, EPS, MAX_ITR))
    kern_e2e = jax.jit(lambda A: solve_matvec_symmetric(A, EPS, MAX_ITR))
    for f, a in ((plain_pass, (H, x)), (kern_pass, (H, x)),
                 (plain_e2e, (H,)), (kern_e2e, (H,))):
        jax.block_until_ready(f(*a))
    rp, rk = plain_e2e(H), kern_e2e(H)
    check(
        abs(int(rk.rounds) - int(rp.rounds)) <= 1,
        f"symv solve rounds {int(rk.rounds)} vs dense {int(rp.rounds)}",
    )
    (p1, p2), (k1, k2) = in_turns(plain_pass, kern_pass, H, x, reps=reps)
    (e1, e2), (f1, f2) = in_turns(plain_e2e, kern_e2e, H, reps=reps)
    gbps = copy_gbps(H, reps=reps)
    row = {
        "kernel": "symv",
        "n": n,
        "product_rel_err": rel,
        "pass_ms_plain": [p1 / passes, p2 / passes],
        "pass_ms_kernel": [k1 / passes, k2 / passes],
        "e2e_ms_plain": [e1, e2],
        "e2e_ms_kernel": [f1, f2],
        "rounds_plain": int(rp.rounds),
        "rounds_kernel": int(rk.rounds),
        "copy_gbps": gbps,
    }
    print(f"[4] {json.dumps(row)}", flush=True)
    return row


def phase_storage(lam_f32: float, n: int = 8192):
    import jax
    import jax.numpy as jnp

    from eigen_value import SolverConfig, fixtures, max_eigenvalue

    H = fixtures.hilbert_matrix(n)
    res = jax.block_until_ready(
        max_eigenvalue(H, SolverConfig(storage_dtype=jnp.bfloat16))
    )
    rounds, lam = int(res.rounds), float(res.eigenvalue)
    rel = abs(lam - lam_f32) / lam_f32
    print(
        f"[5] bf16 storage {n}^2: lambda {lam:.7f} rounds {rounds} converged "
        f"{bool(res.converged)} rel_to_f32 {rel:.2e}",
        flush=True,
    )
    check(bool(res.converged), "bf16 storage solve did not converge")
    want = fixtures.HILBERT_ROUNDS[n]
    check(abs(rounds - want) <= 1, f"bf16 rounds {rounds} vs {want}")
    check(rel <= LAM_REL_BF16, f"bf16 lambda {rel:.2e} from f32")


def phase_four(n_big: int = 131072, n_cmp: int = 32768):
    """The row-sharded solve of a matrix no single card holds, and every
    sharded body against the one-card solve of the same matrix."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from eigen_value import fixtures, max_eigenvalue
    from eigen_value.ops.solver_matvec import solve_matvec
    from eigen_value.config import EPS, MAX_ITR
    from eigen_value.parallel.sharded import (
        make_mesh2d,
        make_row_mesh,
        solve_sharded_2d,
        solve_sharded_matvec,
        solve_sharded_matvec_ring,
    )

    mesh = make_row_mesh(4)
    rows = NamedSharding(mesh, P("rows", None))
    make = jax.jit(lambda: fixtures.hilbert_matrix(n_big), out_shardings=rows)
    A = jax.block_until_ready(make())
    t0 = time.perf_counter()
    res = jax.block_until_ready(max_eigenvalue(A, mesh=mesh))
    wall = time.perf_counter() - t0
    err = residual(A, res.eigenvalue, res.eigenvector)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in jax.devices()[:4]]
    print(
        f"[four] {n_big}^2 f32 row-sharded over 4: lambda "
        f"{float(res.eigenvalue):.7f} rounds {int(res.rounds)} converged "
        f"{bool(res.converged)} residual {err:.2e} first call {wall:.2f} s "
        f"peak_bytes_in_use {peaks}",
        flush=True,
    )
    check(bool(res.converged), f"{n_big}^2 sharded solve did not converge")
    check(err <= RESIDUAL_MAX, f"{n_big}^2 sharded residual {err:.2e}")
    A.delete()
    del A, res

    H1 = jax.device_put(fixtures.hilbert_matrix(n_cmp), jax.devices()[0])
    one = jax.block_until_ready(solve_matvec(H1, EPS, MAX_ITR))
    lam1, r1 = float(one.eigenvalue), int(one.rounds)
    one_ms = median_ms(jax.jit(lambda A: solve_matvec(A, EPS, MAX_ITR)), H1, reps=3)
    print(f"[four] {n_cmp}^2 one card: lambda {lam1:.7f} rounds {r1} {one_ms:.3f} ms",
          flush=True)
    H1.delete()
    bodies = {
        "gather": (make_row_mesh(4), solve_sharded_matvec),
        "ring": (make_row_mesh(4), solve_sharded_matvec_ring),
        "2d": (make_mesh2d(2, 2), solve_sharded_2d),
    }
    for name, (m, solve) in bodies.items():
        spec = P("rows", "cols") if "cols" in m.shape else P("rows", None)
        # the same matrix, generated in place on each mesh's cards
        Hs = jax.block_until_ready(
            jax.jit(
                lambda: fixtures.hilbert_matrix(n_cmp),
                out_shardings=NamedSharding(m, spec),
            )()
        )
        got = jax.block_until_ready(solve(Hs, m))
        ms = median_ms(lambda a: solve(a, m), Hs, reps=3)
        rel = abs(float(got.eigenvalue) - lam1) / lam1
        print(
            f"[four] {n_cmp}^2 {name}: lambda {float(got.eigenvalue):.7f} "
            f"rounds {int(got.rounds)} rel_to_one_card {rel:.2e} {ms:.3f} ms",
            flush=True,
        )
        check(int(got.rounds) == r1, f"{name} rounds {int(got.rounds)} != {r1}")
        check(rel <= LAM_REL_SHARDED, f"{name} lambda {rel:.2e} from one card")
        Hs.delete()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded path")
    args = p.parse_args(argv)

    import jax

    from eigen_value.utils.aot import enable_persistent_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: the default platform is {devices[0].platform!r}",
              file=sys.stderr)
        return 2
    enable_persistent_cache()
    print(f"[1] devices {devices}", flush=True)
    for d in devices:
        print(f"[1] {d}: device_kind {d.device_kind!r}", flush=True)
    cards = card_info()
    for line in cards:
        print(f"[1] nvidia-smi: {line}", flush=True)
    want = 4 if args.four else 1
    check(len(devices) >= want, f"need {want} GPUs, JAX sees {len(devices)}")

    if args.four:
        phase_four()
        devices = devices[:4]
    else:
        H8, lam = phase_flagship()
        H64 = phase_card_scale()
        kernel_checks(H8)
        kernel_checks(H64, passes=5, reps=3)
        H64.delete()
        phase_storage(lam)
        devices = devices[:1]
    for line in cards[: len(devices)]:
        print(line, flush=True)
    print(final_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
