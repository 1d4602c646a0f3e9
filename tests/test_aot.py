"""Persistent compilation cache and exported artifacts (the reference's
AOT-target analog)."""

import os

import jax
import jax.numpy as jnp

from eigen_value.utils import aot


class TestExportArtifact:
    """Shippable StableHLO artifacts — the reference's AOT-binary analog
    (Makefile aot_cpu/aot_gpu)."""

    def test_roundtrip_matches_direct_solve(self, tmp_path):
        import numpy as np

        from eigen_value import fixtures, max_eigenvalue

        exp = aot.export_solver(128)
        path = aot.save_exported(exp, str(tmp_path / "solver_128.bin"))
        loaded = aot.load_exported(path)
        H = fixtures.hilbert_matrix(128)
        got = loaded.call(H)
        want = max_eigenvalue(H)
        assert int(got.rounds) == int(want.rounds) == fixtures.HILBERT_ROUNDS[128]
        np.testing.assert_allclose(
            float(got.eigenvalue), float(want.eigenvalue), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(got.eigenvector), np.asarray(want.eigenvector), rtol=1e-5
        )

    def test_cross_platform_artifact_from_cpu_host(self, tmp_path):
        """A CUDA+CPU artifact can be produced on a CPU-only build machine
        (the reference cross-compiles AOT targets the same way) and still
        executes on the CPU platform."""
        from eigen_value import fixtures

        exp = aot.export_solver(128, platforms=("cuda", "cpu"))
        assert tuple(exp.platforms) == ("cuda", "cpu")
        loaded = aot.load_exported(
            aot.save_exported(exp, str(tmp_path / "solver_cuda_cpu.bin"))
        )
        got = loaded.call(fixtures.hilbert_matrix(128))
        assert int(got.rounds) == fixtures.HILBERT_ROUNDS[128]

    def test_symmetric_kernel_cross_lowers_to_cuda(self):
        """The compiled symmetric kernel (Triton, interpret=False) exports
        as a CUDA artifact from this CPU-only host — serving artifacts for
        the card can be built anywhere — while asking for it in a CPU
        artifact is an error."""
        import pytest

        from eigen_value.config import SolverConfig

        cfg = SolverConfig(symmetric=True, backend="matvec")
        exp = aot.export_solver(1024, cfg, platforms=("cuda",))
        assert tuple(exp.platforms) == ("cuda",)
        assert len(exp.serialize()) > 0
        # the Triton kernel is embedded as a custom call; the artifact
        # runs only on a GPU, so execution is covered by test_gpu_hw.py.
        with pytest.raises(ValueError, match="GPU"):
            aot.export_solver(1024, cfg, platforms=("cpu",))

    def test_sharded_artifact_roundtrip(self, tmp_path):
        """Multi-chip serving: an 8-device row-sharded solver artifact
        round-trips and solves with round parity on the virtual mesh."""
        import numpy as np

        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        from eigen_value import fixtures

        from eigen_value import max_eigenvalue

        devs = jax.devices("cpu")[:8]
        mesh = Mesh(np.array(devs), ("rows",))
        exp = aot.export_sharded_solver(1024, mesh)
        assert exp.nr_devices == 8
        loaded = aot.load_exported(
            aot.save_exported(exp, str(tmp_path / "solver_sharded.bin"))
        )
        H = fixtures.hilbert_matrix(1024)
        got = loaded.call(
            jax.device_put(H, NamedSharding(mesh, P("rows", None)))
        )
        want = max_eigenvalue(H)
        assert int(got.rounds) == int(want.rounds) == fixtures.HILBERT_ROUNDS[1024]
        np.testing.assert_allclose(
            float(got.eigenvalue), float(want.eigenvalue), rtol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(got.eigenvector), np.asarray(want.eigenvector), rtol=1e-4
        )

    def test_sharded_cross_platform_artifact(self):
        """A CUDA+CPU sharded artifact from the CPU-only host (the sharded
        bodies run no kernel, so one artifact serves both)."""
        import numpy as np

        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("rows",))
        exp = aot.export_sharded_solver(1024, mesh, platforms=("cuda", "cpu"))
        assert tuple(exp.platforms) == ("cuda", "cpu")
        assert exp.nr_devices == 8

    def test_artifact_pins_shape(self):
        import pytest

        from eigen_value import fixtures

        exp = aot.export_solver(128)
        with pytest.raises(ValueError):
            exp.call(fixtures.hilbert_matrix(256))

    def test_loads_in_fresh_interpreter(self, tmp_path):
        """The serving contract: a fresh process needs only jax + the
        artifact bytes + load_exported (no solver code is traced)."""
        import subprocess
        import sys

        from conftest import subprocess_env

        path = aot.save_exported(
            aot.export_solver(128), str(tmp_path / "solver.bin")
        )
        code = f"""
import numpy as np
from eigen_value.utils import aot
from eigen_value import fixtures
r = aot.load_exported({path!r}).call(np.asarray(fixtures.hilbert_matrix(128)))
print(int(r.rounds))
"""
        out = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True,
            text=True,
            env=subprocess_env(),
            timeout=240,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip().splitlines()[-1] == "9"


def test_persistent_cache_writes_entries(tmp_path):
    path = str(tmp_path / "xla-cache")
    try:
        assert aot.enable_persistent_cache(path) == path
        from eigen_value.ops.solver_matvec import solve_matvec

        res = jax.jit(lambda A: solve_matvec(A, eps=1e-3, max_itr=1000))(
            jnp.full((64, 64), 0.5, jnp.float32)
        )
        jax.block_until_ready(res)
        entries = os.listdir(path)
        assert entries, "no cache entries written"
    finally:
        aot.disable_persistent_cache()


def test_cache_dir_choice(tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    .jax_cache/ in the checkout — never a path made from a temp name, a
    pid or the time."""
    assert aot.cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(
        tmp_path
    )
    default = aot.cache_dir({})
    assert default == aot.CHECKOUT_CACHE_DIR
    assert os.path.basename(default) == ".jax_cache"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(default) == repo
    assert aot.cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == default


def test_enable_cache_honors_env_dir(tmp_path, monkeypatch):
    """With the variable set, no directory is set in code: JAX's own
    config keeps the one it read from the environment."""
    env_dir = str(tmp_path / "from-env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert aot.enable_persistent_cache() == env_dir
        assert jax.config.jax_compilation_cache_dir == before
        assert os.path.isdir(env_dir)
    finally:
        aot.disable_persistent_cache()
