"""Oracle CLI smoke test — `python -m eigen_value.oracle` reproduces
the reference's sequential-harness report (main.py:62-70 timing sweep with
the np.linalg.eigvals cross-check and the 3×3 handwritten assert)."""

import os
import subprocess
import sys

import pytest


@pytest.mark.parametrize("semantics", ["sequential", "parallel"])
def test_oracle_cli_runs_and_reports(semantics):
    from conftest import subprocess_env

    env = subprocess_env()
    out = subprocess.run(
        [
            sys.executable,
            "-m",
            "eigen_value.oracle",
            "--semantics",
            semantics,
            "--min-pow",
            "5",
            "--max-pow",
            "6",
        ],
        capture_output=True,
        text=True,
        env=env,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Similarity Transform" in out.stdout
    assert "round(s)" in out.stdout
    assert "32" in out.stdout and "64" in out.stdout
