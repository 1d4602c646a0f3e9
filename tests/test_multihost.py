"""Real multi-process multi-host test.

The reference is single-device; multi-host row-partitioned solving is a
capability this build adds (SURVEY.md §2/§5).  This test exercises the
FULL multi-host path — ``jax.distributed.initialize`` process-group
bootstrap, host-local data placement (each process materializes only its
own row block), global-array assembly, and the shard_map solve — with two
actual OS processes of 4 virtual CPU devices each, the CI stand-in for two
hosts (network boundary = process boundary).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from eigen_value import fixtures
from eigen_value.reference_impl import parallel_oracle

DIM = 256


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(nprocs: int, solver: str, dim: int = DIM):
    """Launch an nprocs-process group and return each worker's result."""
    port = _free_port()
    from conftest import subprocess_env

    env = subprocess_env()
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                "-m",
                "eigen_value.bench.mh_worker",
                "--reps",
                "1",
                "--process-id",
                str(pid),
                "--num-processes",
                str(nprocs),
                "--coordinator",
                f"127.0.0.1:{port}",
                "--dim",
                str(dim),
                "--solver",
                solver,
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for pid in range(nprocs)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        # a failed/timed-out worker must not leave its siblings blocked
        # forever in jax.distributed.initialize
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    return outs


@pytest.mark.slow
@pytest.mark.parametrize("solver", ["gather", "ring", "2d"])
def test_two_process_solve_parity(solver):
    outs = _run_group(2, solver)
    oracle = parallel_oracle(np.asarray(fixtures.hilbert_matrix(DIM)))
    for res in outs:
        assert res["num_processes"] == 2
        assert res["global_devices"] == 8
        assert res["converged"]
        assert res["rounds"] == fixtures.HILBERT_ROUNDS[DIM]
        assert res["eigenvalue"] == pytest.approx(oracle.eigenvalue, abs=1e-3)
        assert res["residual"] < 1e-3
    # λ must be bit-identical across processes (replicated readout).
    assert outs[0]["eigenvalue"] == outs[1]["eigenvalue"]


@pytest.mark.slow
@pytest.mark.parametrize("solver", ["gather", "2d"])
def test_four_process_solve_parity(solver):
    """4 OS processes (the 2D case = a 4×4 global mesh: rows = the
    process/DCN axis, cols = the intra-host axis) — the config-5
    weak-scaling topology one step past the 2-process flow test."""
    outs = _run_group(4, solver)
    oracle = parallel_oracle(np.asarray(fixtures.hilbert_matrix(DIM)))
    for res in outs:
        assert res["num_processes"] == 4
        assert res["global_devices"] == 16
        assert res["converged"]
        assert res["rounds"] == fixtures.HILBERT_ROUNDS[DIM]
        assert res["eigenvalue"] == pytest.approx(oracle.eigenvalue, abs=1e-3)
        assert res["residual"] < 1e-3
    assert len({r["eigenvalue"] for r in outs}) == 1
