"""Ahead-of-time compilation utilities.

The reference ships AOT build targets (``make aot_cpu`` / ``aot_gpu``,
reference Makefile:44-64) so kernels are compiled once, not per run.  The
XLA analog has two halves:

  * per-process AOT: ``EigenValue.warmup`` / ``jax.jit(...).lower().compile()``
    (api.py) compiles for given shapes before the first timed call;
  * cross-process AOT: the persistent compilation cache below — compiled
    executables are written to disk and reloaded by later processes, so a
    production service pays each (shape, backend) compile exactly once per
    machine, like the reference's AOT'd binary.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

#: The checkout's own cache directory (listed in .gitignore).  A fixed
#: path: the path is part of the cache key, so a directory that moves
#: between runs never hits.
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir(environ=None) -> str:
    """Where the persistent cache lives: ``JAX_COMPILATION_CACHE_DIR`` when
    set (JAX reads that variable itself), else the checkout's
    ``.jax_cache/``."""
    env = os.environ if environ is None else environ
    return env.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_persistent_cache(path: Optional[str] = None) -> str:
    """Turn on XLA's on-disk compilation cache (idempotent).

    Returns the cache directory: ``path`` if given, else :func:`cache_dir`.
    When ``JAX_COMPILATION_CACHE_DIR`` is set and no ``path`` is given, no
    directory is set in code — JAX already uses the variable's.
    Thresholds are zeroed so even the small solver executables are cached
    (defaults skip sub-second compiles).
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    path = path or cache_dir()
    os.makedirs(path, exist_ok=True)
    if path != env_dir:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


def disable_persistent_cache() -> None:
    """Turn the on-disk compilation cache back off."""
    jax.config.update("jax_compilation_cache_dir", None)


# ---------------------------------------------------------------------------
# Shippable AOT artifacts (jax.export / StableHLO)
#
# The closest analog of the reference's AOT *binaries*
# (``make aot_cpu`` builds a spir64_x86_64 executable you can ship,
# reference Makefile:44-58): a serialized, versioned StableHLO program a
# serving process loads and calls with ZERO Python-side tracing or
# compile-time solver code — only jax + the artifact bytes.  Artifacts can
# be cross-lowered (e.g. a CUDA+CPU artifact produced on a CPU-only build
# machine), mirroring how the reference cross-compiles AOT targets for
# devices the build host lacks.
# ---------------------------------------------------------------------------

_SERIALIZATION_REGISTERED = False


def _register_solve_result() -> None:
    """Register SolveResult for jax.export serialization (idempotent)."""
    global _SERIALIZATION_REGISTERED
    if _SERIALIZATION_REGISTERED:
        return
    from jax import export as jexport

    from ..ops.solver import SolveResult

    jexport.register_namedtuple_serialization(
        SolveResult, serialized_name="eigen_value.SolveResult"
    )
    _SERIALIZATION_REGISTERED = True


def export_solver(n: int, config=None, platforms=None):
    """AOT-export the dim-``n`` solver as a ``jax.export.Exported``.

    ``platforms`` (e.g. ``("cuda", "cpu")``) cross-lowers for devices the
    exporting host need not have; default is the host's platform.  The
    artifact pins shape (n, n), dtype, eps/max_itr, and the backend —
    the same things the reference bakes into its AOT binary.  Serialize
    with :func:`save_exported`; a server calls
    ``load_exported(path).call(A)`` and gets the usual ``SolveResult``.

    The default path runs no Pallas kernel and exports for any platform;
    a config that runs the symmetric kernel exports for ``("cuda",)``
    only (the kernel has no CPU form outside the interpreter), and its
    Triton custom call carries no compatibility guarantee across JAX
    versions: load such an artifact with the JAX that exported it.
    """
    import types

    from jax import export as jexport

    from ..api import _solve_fn, resolve_backend, uses_symmetric_kernel
    from ..config import DEFAULT_CONFIG

    config = config or DEFAULT_CONFIG
    _register_solve_result()
    # what can run is decided for the artifact's target, not this host
    target = None
    if platforms is not None:
        kinds = {"gpu" if p in ("cuda", "rocm") else p for p in platforms}
        if len(kinds) == 1:
            target = types.SimpleNamespace(platform=kinds.pop())
    fn = _solve_fn(config, resolve_backend(config), target)
    checks = []
    if uses_symmetric_kernel(config, target):
        checks.append(jexport.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton"))
    jf = jax.jit(lambda A: fn(A))
    args = jax.ShapeDtypeStruct((n, n), config.dtype)
    plats = list(platforms) if platforms is not None else None
    return jexport.export(jf, platforms=plats, disabled_checks=checks)(args)


def export_sharded_solver(
    n: int,
    mesh,
    config=None,
    axis_name: str = "rows",
    platforms=None,
):
    """AOT-export the row-partitioned multi-chip solve for ``mesh``.

    The artifact embeds the sharding layout (``exported.nr_devices`` =
    mesh size); a serving process with an identically-shaped mesh loads
    it and calls with an A sharded ``P(axis_name, None)`` — the
    multi-chip serving analog of :func:`export_solver`.

    ``platforms`` cross-lowers like :func:`export_solver`.
    """
    from jax import export as jexport
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..config import DEFAULT_CONFIG
    from ..parallel.sharded import solve_sharded_matvec

    config = config or DEFAULT_CONFIG
    _register_solve_result()
    jf = jax.jit(
        lambda A: solve_sharded_matvec(
            A, mesh, axis_name=axis_name, config=config
        )
    )
    sharding = NamedSharding(mesh, P(axis_name, None))
    arg = jax.ShapeDtypeStruct((n, n), config.dtype, sharding=sharding)
    plats = list(platforms) if platforms is not None else None
    return jexport.export(jf, platforms=plats)(arg)


def save_exported(exported, path: str) -> str:
    """Write a serialized export artifact; returns ``path``."""
    with open(path, "wb") as f:
        f.write(exported.serialize())
    return path


def load_exported(path: str):
    """Load an artifact written by :func:`save_exported`.  Call it with
    ``.call(A)`` — runs the embedded program for the current platform.

    ``call`` lowers for the platform the call EXECUTES on (the committed
    device of ``A``, else the process default device) and raises if that
    platform is not among ``exported.platforms``.  When the default
    device differs from the artifact's target (e.g. a CPU-defaulted
    process serving a cuda-only artifact), ``jax.device_put`` the input
    onto the target device first — or export with both platforms."""
    from jax import export as jexport

    _register_solve_result()
    with open(path, "rb") as f:
        return jexport.deserialize(f.read())
