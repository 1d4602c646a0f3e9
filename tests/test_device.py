"""device.py platform rules + EigenValue device pinning + profiling utils."""

import types

import jax
import numpy as np
import pytest

from eigen_value import EigenValue
from eigen_value.device import platform, require_gpu
from eigen_value.utils import profiling


def test_platform_respects_default_device_pin():
    # conftest pins the default device to CPU
    assert platform() == "cpu"
    assert platform(jax.devices("cpu")[0]) == "cpu"
    assert platform(types.SimpleNamespace(platform="gpu")) == "gpu"


@pytest.mark.parametrize(
    "interpret,plat,raises",
    [
        (False, "cpu", True),
        (True, "cpu", False),
        (False, "gpu", False),
        (True, "gpu", False),
    ],
)
def test_require_gpu(interpret, plat, raises):
    """A kernel runs compiled on a GPU or interpreted when asked; any
    other combination is an error, never a silent interpreter."""
    dev = types.SimpleNamespace(platform=plat)
    if raises:
        with pytest.raises(ValueError, match="interpret=True"):
            require_gpu(interpret, dev)
    else:
        require_gpu(interpret, dev)


def test_eigenvalue_device_pinning(rng):
    dev = jax.devices("cpu")[0]
    ev = EigenValue(device=dev)
    mat = rng.random((128, 128), dtype=np.float32)
    lam, vec, _, rounds = ev.similarity_transform(mat)
    assert np.allclose(mat @ vec, lam * vec, atol=1e-3)
    assert 0 < rounds <= 1000


def test_profiling_trace_and_annotate(tmp_path, rng):
    from eigen_value import max_eigenvalue

    mat = rng.random((64, 64), dtype=np.float32)
    with profiling.trace(str(tmp_path / "trace")) as d:
        with profiling.annotate("solve"):
            res = max_eigenvalue(mat)
            jax.block_until_ready(res)
    assert d == str(tmp_path / "trace")
    assert bool(res.converged)


def test_profiling_trace_failure_raises(tmp_path):
    """A trace that cannot start raises instead of yielding a directory
    with no profile in it (a second trace cannot start inside the first)."""
    with profiling.trace(str(tmp_path / "outer")):
        with pytest.raises(RuntimeError):
            with profiling.trace(str(tmp_path / "inner")):
                pass


def test_device_memory_stats_shape():
    stats = profiling.device_memory_stats()
    assert stats is None or isinstance(stats, dict)
