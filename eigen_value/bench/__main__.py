"""Benchmark CLI — `python -m eigen_value.bench`.

Reproduces the reference driver's report shape (main.cpp:7-162: e2e sweep
table then per-kernel sweeps, fixed-width `dim x dim   ms   rounds` rows —
README.md:64-76) so side-by-side diffing against the reference README is
trivial, plus bandwidth/roofline columns.
"""

from __future__ import annotations

import argparse
import json
import sys


def _fmt_e2e(rows) -> str:
    out = []
    backend = None
    for r in rows:
        if r["backend"] != backend:
            backend = r["backend"]
            out.append(f"\nSimilarity Transform (backend: {backend})\n")
        if "skipped" in r:  # e.g. sym rung at an unalignable dim
            out.append(
                f"{r['dim']:<5} x {r['dim']:>5}\t\tskipped: {r['skipped']}"
            )
            continue
        parity = "" if r["rounds_ok"] else "   [PARITY BREAK]"
        dev = (
            f"{r['device_ms']:.3f} ms"
            if r["device_ms"] is not None
            else "below chain resolution"
        )
        out.append(
            f"{r['dim']:<5} x {r['dim']:>5}\t\t{r['ms']:>10.3f} ms"
            f"\t\t{r['rounds']:>6} round(s)"
            f"\t\t(device {dev}, chained){parity}"
        )
    return "\n".join(out)


def _fmt_kernels(rows, size_key="dim") -> str:
    out = []
    kernel = None
    rows = sorted(rows, key=lambda r: (r["kernel"], r[size_key]))
    for r in rows:
        if r["kernel"] != kernel:
            kernel = r["kernel"]
            out.append(f"\n{kernel}\n")
        gbps = r.get("gbps")
        gb = f"{gbps:>8.0f} GB/s" if gbps is not None and "gbps" in r else " " * 13
        roof = r.get("roofline_pct")
        roof_s = f"{roof:>6.1f}% roofline" if roof is not None else ""
        out.append(
            f"{r[size_key]:<10}\t\t{r['ms'] * 1e3:>10.1f} us\t{gb}\t{roof_s}"
        )
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="eigen_value.bench")
    p.add_argument(
        "--suite",
        choices=[
            "e2e",
            "kernels",
            "vector",
            "sharded",
            "multihost",
            "native",
            "model",
            "operator",
            "batched",
            "large",
            "all",
        ],
        default="all",
    )
    p.add_argument("--dims", type=int, nargs="*", help="matrix dims to sweep")
    p.add_argument(
        "--sizes",
        type=int,
        nargs="*",
        help="vector sizes for --suite vector (default 2^16..2^25)",
    )
    p.add_argument("--backends", nargs="*", help="e2e backends to run")
    p.add_argument(
        "--batch",
        type=int,
        help="batch size for --suite batched (default 256, config 4)",
    )
    p.add_argument("--json", action="store_true", help="emit JSON lines")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument(
        "--device",
        choices=["cpu", "gpu"],
        help="pin the default device (default: platform default)",
    )
    p.add_argument(
        "--cpu-devices",
        type=int,
        default=8,
        help="virtual CPU device count (applies with --device cpu, before jax init)",
    )
    args = p.parse_args(argv)

    if args.device == "cpu":
        import os

        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={args.cpu_devices}"
            ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.device:
        import jax

        jax.config.update("jax_default_device", jax.devices(args.device)[0])
    from ..utils.aot import enable_persistent_cache

    enable_persistent_cache()

    from . import suite

    dims = args.dims or suite.MATRIX_DIMS
    all_rows = []
    if args.suite in ("e2e", "all"):
        rows = suite.bench_e2e(dims, backends=args.backends, reps=args.reps)
        all_rows += rows
        if not args.json:
            print(_fmt_e2e(rows))
    if args.suite in ("kernels", "all"):
        rows = suite.bench_kernels(dims)
        all_rows += rows
        if not args.json:
            print(_fmt_kernels(rows))
    if args.suite == "native":
        rows = suite.bench_native(dims)
        all_rows += rows
        if not args.json:
            for r in rows:
                if r["bench"] == "native_kernel":
                    print(
                        f"{r['kernel']:<24} {r['dim']:<6}"
                        f"{r['ms'] * 1e3:>12.1f} us   [native C++]"
                    )
                else:
                    print(
                        f"[{r['backend']}] {r['dim']:<5} x {r['dim']:>5}"
                        f"\t{r['ms']:>10.3f} ms"
                        f"\t\t{r['rounds']:>6} round(s)   [native C++]"
                    )
    if args.suite == "operator":
        rows = suite.bench_operator(dims, reps=args.reps)
        all_rows += rows
        if not args.json:
            for r in rows:
                parity = "" if r.get("rounds_ok", True) else "   [PARITY BREAK]"
                dev = (
                    f"{r['device_ms']:>10.4f} ms dev (chained)"
                    if r["device_ms"] is not None
                    else "  below chain resolution  "
                )
                print(
                    f"[{r['backend']}] {r['dim']:<5} x {r['dim']:>5}"
                    f"\t{dev}"
                    f"\t{r['rounds']:>4} round(s){parity}"
                )
    if args.suite == "batched":
        kw = {}
        if args.dims:
            kw["dim"] = args.dims[0]
        if args.batch:
            kw["batch"] = args.batch
        rows = suite.bench_batched(reps=args.reps, **kw)
        all_rows += rows
        if not args.json:
            for r in rows:
                print(
                    f"[batched] {r['batch']} x {r['dim']}^2: "
                    f"{r['device_ms_per_batch']:.2f} ms/batch dev, "
                    f"{r['solves_per_s']:.0f} solves/s, rounds {r['rounds_hist']}, "
                    f"max resid {r['max_rel_residual']:.1e}"
                    + ("" if r["rounds_ok"] else "   [CHECK FAILED]")
                )
    if args.suite == "large":
        rows = suite.bench_large(reps=args.reps)
        all_rows += rows
        if not args.json:
            for r in rows:
                if "error" in r:
                    print(f"[large:{r['backend']}] ERROR: {r['error']}")
                else:
                    print(
                        f"[large:{r['backend']}] {r['dim']} x {r['dim']}: "
                        f"{r['device_ms']:.1f} ms dev, {r['rounds']} round(s), "
                        f"lam {r['eigenvalue']:.5f}"
                        + ("" if r["rounds_ok"] else "   [CHECK FAILED]")
                    )
    if args.suite == "sharded":
        rows = suite.bench_sharded(dim=(args.dims or [4096])[0], reps=args.reps)
        all_rows += rows
        if not args.json:
            for r in rows:
                print(
                    f"[{r['solver']}] {r['dim']} x {r['dim']} on "
                    f"{r['shards']} shard(s): "
                    f"{r['device_ms']:.2f} ms dev, {r['rounds']} round(s), "
                    f"{r['elems_per_s_per_chip']:.2e} elems/s/chip, "
                    f"eff {r['scaling_efficiency'] * 100:.0f}%"
                )
    if args.suite == "multihost":
        rows = suite.bench_multihost(dim=(args.dims or [2048])[0], reps=args.reps)
        all_rows += rows
        if not args.json:
            for r in rows:
                print(
                    f"[{r.get('solver', 'gather')}] "
                    f"{r['processes']} process(es) x "
                    f"{r['global_devices'] // r['processes']} device(s): "
                    f"{r['dim']} x {r['dim']}  {r['ms']:.2f} ms, "
                    f"{r['rounds']} round(s), {r['elems_per_s']:.2e} elems/s, "
                    f"eff {r['scaling_efficiency'] * 100:.0f}%"
                )
    if args.suite == "model":
        from ..utils.scaling_model import prediction_table, sensitivity_table

        rows = prediction_table(dims=args.dims or [8192, 32768, 65536])
        sens = sensitivity_table()
        all_rows += rows + sens
        if not args.json:
            print(
                "Predicted multi-card scaling (ANALYTICAL MODEL on published"
                " H100 figures — not a measurement)\n"
            )
            for r in rows:
                print(
                    f"[{r['solver']}] {r['dim']}² on {r['chips']:>3} chip(s) / "
                    f"{r['hosts']:>2} host(s): {r['round_us']:>9.1f} us/round, "
                    f"eff {r['efficiency'] * 100:5.1f}%"
                )
            print(
                "\nSensitivity of predicted efficiency to the UNVALIDATED"
                " link parameters (bandwidth 100-900 GB/s, latency 0.5-25 us):"
            )
            for r in sens:
                print(
                    f"[{r['solver']}] {r['dim']}² on {r['chips']:>3} chips: "
                    f"link {r['link_gbps']:>5.0f} GB/s, {r['link_latency_us']:>4.1f} us"
                    f" -> eff {r['efficiency'] * 100:5.1f}%"
                )
    if args.suite in ("vector", "all"):
        rows = suite.bench_vector_kernels(sizes=args.sizes or suite.VECTOR_SIZES)
        all_rows += rows
        if not args.json:
            print(_fmt_kernels(rows, size_key="size"))
    if args.json:
        for r in all_rows:
            print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
