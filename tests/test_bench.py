"""Bench harness tests (CPU-runnable subset: xla/matvec backends, CLI)."""

import json
import subprocess
import sys

import pytest

from eigen_value.bench import suite


def test_bench_e2e_rows():
    rows = suite.bench_e2e([128], backends=["xla", "matvec"], reps=1)
    assert len(rows) == 2
    for r in rows:
        assert r["rounds"] == 9 and r["rounds_ok"]
        assert r["ms"] > 0


def test_bench_e2e_sym_skips_unalignable_dim():
    """The symmetric rung runs a Pallas kernel that compiles for a GPU
    only: off the GPU it must emit an explicit skip row, not crash the
    sweep or fall back to the interpreter."""
    rows = suite.bench_e2e([96, 128], backends=["symmetric"], reps=1)
    assert len(rows) == 2
    for r in rows:
        assert "skipped" in r and "GPU" in r["skipped"]
    assert [r["dim"] for r in rows] == [96, 128]


def test_vector_kernel_rows():
    rows = suite.bench_vector_kernels(sizes=[1 << 16], k=5)
    names = {r["kernel"] for r in rows}
    assert names == {"find_max", "eigen_vector", "stop"}
    assert all(r["ms"] >= 0 for r in rows)
    # no published peak off the GPU: the roofline column is null, never
    # a number divided by a guessed peak
    assert all(r["roofline_pct"] is None for r in rows)


def test_kernel_ladder_rows():
    """The per-pass ladder on the CPU: the XLA passes only (the symmetric
    kernel row needs a GPU), RFC-valid JSON, no roofline off the GPU."""
    rows = suite.bench_kernels([128], k=3)
    assert {r["kernel"] for r in rows} == {
        "rowsum_xla", "scale_xla", "scale_rowsum_xla", "matvec_xla",
    }
    for r in rows:
        assert r["roofline_pct"] is None
        json.loads(json.dumps(r, allow_nan=False))


def test_cli_json(tmp_path):
    from conftest import subprocess_env

    out = subprocess.run(
        [
            sys.executable,
            "-m",
            "eigen_value.bench",
            "--suite",
            "e2e",
            "--dims",
            "128",
            "--backends",
            "xla",
            "--reps",
            "1",
            "--json",
            "--device",
            "cpu",
        ],
        capture_output=True,
        text=True,
        check=True,
        env=subprocess_env(),
    )
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["dim"] == 128 and row["rounds"] == 9


@pytest.mark.slow
def test_package_main_entry():
    """`python -m eigen_value` is the reference ./run analog."""
    import subprocess
    import sys

    from conftest import subprocess_env

    out = subprocess.run(
        [
            sys.executable,
            "-m",
            "eigen_value",
            "--device",
            "cpu",
            "--suite",
            "e2e",
            "--dims",
            "128",
            "--backends",
            "xla",
            "--reps",
            "1",
        ],
        capture_output=True,
        text=True,
        env=subprocess_env(),
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "9 round(s)" in out.stdout


def test_marginal_resolved_escalates_then_nulls():
    """A step too fast for even the max chain to resolve must come back
    as (None, max_k, False) — never a fabricated number; a resolvable
    step must return a positive marginal (VERDICT r3 item 5)."""
    import jax.numpy as jnp

    # scalar add: ~ns per step, 4096 chained ≪ the 4 ms signal floor
    fast = lambda i, s: s + jnp.float32(1.0)  # noqa: E731
    ms, k, resolved = suite._marginal_resolved(
        fast, jnp.float32(0.0), k=32, reps=1
    )
    assert ms is None and not resolved and k == 4096

    # a 512³ matmul chain (~ms/step on CPU) resolves at the initial k
    import jax

    A = jax.random.uniform(jax.random.key(0), (512, 512), jnp.float32)

    def step(i, s):
        return (s @ A) * jnp.float32(1e-3) + jnp.float32(1.0)

    ms, k, resolved = suite._marginal_resolved(
        step, jnp.ones((512, 512), jnp.float32), k=32, reps=1
    )
    assert resolved and ms > 0


def test_bench_operator_rows():
    rows = suite.bench_operator([256], reps=1)
    kinds = {r["backend"] for r in rows}
    assert kinds == {"hankel_fft", "kron_16x16", "sparse_ell_deg9", "matvec"}
    for r in rows:
        assert r["rounds_ok"], r
        # honored-or-null timing contract (VERDICT r3 item 5): a chained
        # marginal beneath chain resolution — even after _marginal_resolved
        # escalates the chain length — is reported as None with a
        # below_resolution flag, NEVER committed as a fabricated 0.0.
        if r["device_ms"] is None:
            assert r.get("below_resolution") is True, r
            assert r["ms_per_round"] is None, r
        else:
            assert r["device_ms"] > 0, r
        assert r["bench"] == "operator"
    # ALL rows unresolved would mean the chain dependence is broken
    # (the hoist bug class fixed in _e2e_chain_step) — keep that canary.
    assert any(r["device_ms"] for r in rows), rows
