"""bench.py, the headline benchmark: its record and its refusal to run
without a GPU (the number itself comes only from a run on the card)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402

DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def _record(rounds=17, dim=8192, times=(2.0, 2.2, 2.1)):
    return bench.make_record(
        list(times), rounds, 2.6, 1e-5, dim, "matvec", DEVICE, 3350.0
    )


def test_make_record_json_contract():
    rec = _record()
    json.loads(json.dumps(rec, allow_nan=False))
    for key in (
        "metric", "value", "ms_min", "vs_baseline", "rounds", "rounds_ok",
        "eigenvalue", "residual", "backend", "achieved_gbps",
        "pct_of_peak_bandwidth", "device",
    ):
        assert key in rec, key
    assert rec["device"] == DEVICE
    assert rec["value"] == pytest.approx(2.1)  # the median
    assert rec["ms_min"] == pytest.approx(2.0)
    assert rec["vs_baseline"] == pytest.approx(bench.BASELINE_MS / 2.1)


def test_make_record_bandwidth_counts_every_product():
    """rounds + 1 dense products (the initial row sums included), each
    reading the n×n f32 matrix once."""
    rec = _record(rounds=17, times=(2.0,))
    nbytes = 18 * 8192 * 8192 * 4
    assert rec["achieved_gbps"] == pytest.approx(nbytes / 2e-3 / 1e9)
    assert rec["pct_of_peak_bandwidth"] == pytest.approx(
        100 * rec["achieved_gbps"] / 3350.0
    )


@pytest.mark.parametrize(
    "dim,rounds,ok",
    [(8192, 17, True), (8192, 18, False), (4096, 15, True), (1000, 7, True)],
)
def test_make_record_rounds_ok(dim, rounds, ok):
    """rounds_ok is parity against the reference's table; a dim outside
    the table has nothing to break."""
    assert _record(rounds=rounds, dim=dim)["rounds_ok"] is ok


def test_baseline_is_the_reference_cpu_number():
    # BASELINE.md: the reference's best machine, 8192² end to end
    assert bench.BASELINE_MS == 126.0


def test_bench_py_fails_without_gpu():
    """No GPU: a non-zero exit and no result line — never a CPU number."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_DIM="128")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert out.returncode != 0
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]
    assert "no GPU" in out.stderr
