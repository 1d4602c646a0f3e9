"""Test harness config: an 8-virtual-device CPU JAX platform by default.

Multi-device tests run on a virtual 8-device CPU mesh (XLA host-platform
device-count override — the fake-backend equivalent noted in SURVEY.md §4);
the Pallas kernel runs in interpret mode there.  This must run before jax
is imported anywhere.

Tests marked ``gpu`` need a card: they take the ``gpu`` fixture, which
skips when no GPU backend is present.  On a machine with a card, run them
with the GPU platform enabled next to the CPU one:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu_hw.py
"""

import os
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402

# CPU is the default device even when a GPU platform is also enabled: the
# CPU tests and their virtual meshes must not land on the card.  GPU
# tests place their work explicitly (the ``gpu`` fixture).
jax.config.update("jax_default_device", jax.devices("cpu")[0])


@pytest.fixture
def rng():
    return np.random.default_rng(0xE16E7)


@pytest.fixture
def gpu():
    """The first GPU, made the default device for the test; skips when the
    process has no GPU backend (decided here, never at import)."""
    try:
        dev = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip(
            "needs a GPU: run with JAX_PLATFORMS=cuda,cpu on a machine with "
            "a card"
        )
    from eigen_value.utils.aot import enable_persistent_cache

    enable_persistent_cache()
    with jax.default_device(dev):
        yield dev


def subprocess_env(**overrides) -> dict:
    """Environment for worker subprocesses: repo on PYTHONPATH (the package
    is not installed), CPU platform, caller's overrides applied last."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [REPO_ROOT, env.get("PYTHONPATH")])
    )
    env.update(overrides)
    return env
