"""Public Python API.

Mirrors the shape of the reference's Python wrapper
(``wrapper/python/similarity_transform.py:18-78``): an ``EigenValue`` class
whose ``similarity_transform(mat)`` returns ``(λ, v, ts_ms, rounds)``.  The
reference's constructor loads a shared object and builds a SYCL queue; the
equivalent one-time setup here is JIT compilation, which this class caches
per (shape, dtype, backend), so a timed call runs the device loop only —
the same thing the reference times (its clock starts after buffer setup,
``similarity_transform.cpp:36``).

Also exposes the functional entry :func:`max_eigenvalue` returning the
:class:`SolveResult` pytree, which is the idiomatic JAX surface (composable
with jit/vmap/shard_map).
"""

from __future__ import annotations

import time
from dataclasses import replace
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import DEFAULT_CONFIG, SolverConfig
from .device import platform, require_gpu
from .ops.solver import SolveResult, solve_xla


def resolve_backend(config: SolverConfig) -> str:
    """Resolve "auto" to a concrete backend: the dense XLA matvec-form
    solve (``solve_matvec``) at every n and on every platform."""
    return "matvec" if config.backend == "auto" else config.backend


def uses_symmetric_kernel(
    config: SolverConfig, device: Optional[jax.Device] = None
) -> bool:
    """Whether a single-device solve under ``config`` runs the
    upper-triangle kernel (ops/pallas/kernels.symv).

    ``symmetric=True`` is a property DECLARATION.  An explicit matvec or
    multiround backend honors it with the kernel.  Under "auto" the kernel
    is taken where it was measured to win — f32 storage on a GPU — or
    where the caller asked for the interpreter; elsewhere the dense
    product keeps the job (the same answer, reading all of A)."""
    if not config.symmetric:
        return False
    if config.backend != "auto":
        return True
    if config.interpret is not None:
        return bool(config.interpret)
    return config.storage_dtype is None and platform(device) == "gpu"


def _solve_fn(
    config: SolverConfig,
    backend: str,
    device: Optional[jax.Device] = None,
):
    """Build the solve callable for ``backend``; ``device`` (when pinned)
    is where the solve runs, which decides whether a kernel can.

    CONFIG CONSISTENCY CONTRACT: every SolverConfig knob is either honored
    by the resolved backend or rejected with a ValueError — never silently
    dropped.
    """
    if config.storage_dtype is not None and backend == "xla":
        raise ValueError(
            f"storage_dtype={config.storage_dtype} requires a matvec-family "
            f"backend (the reduced-precision storage contract lives in "
            f"solver_matvec.py); got backend='xla'. Use backend='auto', "
            f"'matvec' or 'multiround'."
        )
    if config.chunk is not None and backend != "multiround":
        raise ValueError(
            f"chunk={config.chunk} is a multiround-backend knob (rounds per "
            f"host check) but the "
            f"{'resolved' if config.backend == 'auto' else 'requested'} "
            f"backend is {backend!r} — it would be silently dropped. Use "
            f"backend='multiround' (or drop chunk)."
        )
    if config.symmetric and backend == "xla":
        raise ValueError(
            "symmetric=True has no form in the iterated 'xla' backend (it "
            "rewrites A every round); it would be silently dropped. Use "
            "backend='auto', 'matvec' or 'multiround'."
        )
    sym = uses_symmetric_kernel(config, device)
    if config.interpret is not None and not sym:
        raise ValueError(
            "interpret is a Pallas-kernel knob and this solve runs no kernel "
            "(only symmetric=True runs one, ops/pallas/kernels.symv); it "
            "would be silently dropped"
        )
    interpret = bool(config.interpret)
    if sym:
        require_gpu(interpret, device)
    common = dict(eps=config.eps, max_itr=config.max_itr, eps_mode=config.eps_mode)
    if backend == "multiround":
        from .ops.solver_matvec import solve_multiround

        return partial(
            solve_multiround,
            chunk=config.chunk or 18,
            storage_dtype=config.storage_dtype,
            symmetric=sym,
            interpret=interpret,
            **common,
        )
    if backend == "matvec":
        from .ops import solver_matvec as sm

        if sym:
            return partial(
                sm.solve_matvec_symmetric,
                storage_dtype=config.storage_dtype,
                interpret=interpret,
                **common,
            )
        if config.storage_dtype is not None:
            return partial(
                sm.solve_matvec_storage,
                storage_dtype=config.storage_dtype,
                **common,
            )
        return partial(sm.solve_matvec, **common)
    return partial(solve_xla, **common)


def max_eigenvalue(
    mat: jax.Array,
    config: SolverConfig = DEFAULT_CONFIG,
    validate: bool = False,
    mesh=None,
) -> SolveResult:
    """Maximum eigenvalue + eigenvector of a positive square matrix.

    Functional entry point; jittable (with ``validate=False``).  ``mat``
    must be square with all entries > 0 (the method's correctness
    precondition — SURVEY.md §0: the reference's reductions seed their
    accumulators with 0 and silently return garbage on non-positive input;
    pass ``validate=True`` to check on device and raise instead).

    ``validate=True`` also PROMOTES to the symmetric kernel when it
    applies: under ``backend="auto"`` on a GPU with f32 storage, a matrix
    that checks bitwise symmetric on device is solved by the
    upper-triangle kernel (identical semantics, ≈ half the bytes per
    round), without an explicit ``SolverConfig(symmetric=True)``.

    ``mesh`` (a ``jax.sharding.Mesh`` with a ``"rows"`` axis) runs the
    row-partitioned multi-device solve instead of the single-device one —
    the one-argument door to `parallel/` (solve_sharded_matvec; use the
    parallel module directly for the ring/batched variants).  A mesh with
    BOTH ``"rows"`` and ``"cols"`` axes dispatches to the 2D block-sharded
    solve (per-device memory n²/(pr·pc), parallel/sharded.py).  On the
    mesh path ``backend`` maps to the sharded body with the same
    structure — "auto"/"matvec" pick the matvec-form solve, "xla" the
    iterated (mutate-A) solve — and the single-device-only "multiround"
    raises; ``eps_mode`` is honored by every sharded body.
    """
    mat = jnp.asarray(mat)
    if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
        raise ValueError(f"must be a square matrix, got shape {mat.shape}")
    if mesh is not None:
        from .parallel.sharded import (
            solve_sharded,
            solve_sharded_2d,
            solve_sharded_matvec,
        )

        _reject_unsupported(
            config,
            "the mesh path",
            (
                ("chunk", config.chunk is None,
                 "the multiround loop is single-device only"),
                ("interpret", config.interpret is None,
                 "the sharded bodies run no Pallas kernel"),
                ("symmetric", not config.symmetric,
                 "the upper-triangle kernel is single-device; the sharded "
                 "solvers stream full row blocks"),
            ),
        )
        is_2d = "cols" in mesh.shape
        if config.backend == "multiround":
            raise ValueError(
                "backend='multiround' is single-device only; the mesh path "
                "would silently ignore it. Use backend='auto' for the "
                "sharded solvers, or solve on one device."
            )
        if is_2d and config.backend not in ("auto", "matvec"):
            raise ValueError(
                f"backend={config.backend!r} has no 2D block-sharded "
                "form (solve_sharded_2d runs the matvec-form XLA body); "
                "use backend='auto' or 'matvec'"
            )

        # honor storage_dtype exactly like the single-device path: a
        # matrix already in storage_dtype is solved as-is (no f32 copy)
        if not (
            config.storage_dtype is not None
            and mat.dtype == jnp.dtype(config.storage_dtype)
        ):
            mat = mat.astype(config.dtype)
        if validate and not bool(jnp.all(mat > 0)):
            raise ValueError("similarity-transform method requires all entries > 0")
        if is_2d:
            if "rows" not in mesh.shape:
                raise ValueError(
                    "a mesh with a 'cols' axis needs a 'rows' axis too "
                    "(size 1 for pure column sharding) — got axes "
                    f"{tuple(mesh.shape)}; build it with "
                    "parallel.make_mesh2d(1, pc)"
                )
            return solve_sharded_2d(mat, mesh, config=config)
        if config.backend == "xla":
            # the iterated (mutate-A) sharded body — the sharded analog of
            # the single-device "xla" rung
            if config.storage_dtype is not None:
                raise ValueError(
                    "storage_dtype requires a matvec-family backend on the "
                    "mesh path too (the iterated sharded body mutates A "
                    "and cannot honor the storage contract)"
                )
            return solve_sharded(mat, mesh, config=config)
        return solve_sharded_matvec(mat, mesh, config=config)
    # The solve runs where a COMMITTED single-device input lives
    # (jax.device_put), whatever the default platform, so decide what can
    # run there from its device; uncommitted inputs use the default.
    dev = None
    if getattr(mat, "committed", False):
        devs = list(mat.devices())
        if len(devs) == 1:
            dev = devs[0]
    backend = resolve_backend(config)
    if not _prequantized(config, mat, backend):
        mat = mat.astype(config.dtype)
    if validate:
        # Once validate=True pays for an on-device check anyway, a bitwise
        # symmetric matrix is routed to the upper-triangle kernel — but
        # only where "auto" would take it for a declared-symmetric input,
        # so the O(n²) symmetry check runs only where it can pay off.
        cand = None
        if not config.symmetric and config.backend == "auto":
            c = replace(config, symmetric=True)
            if uses_symmetric_kernel(c, dev):
                cand = c
        check_sym = config.symmetric or cand is not None
        pos, sym_ok = _validate_on_device(mat, check_sym)
        if not bool(pos):
            raise ValueError(
                "similarity-transform method requires all entries > 0"
            )
        if config.symmetric and not bool(sym_ok):
            # the declaration is a promise (BLAS-symv semantics); checked
            # on device only when asked — bitwise, because the kernel
            # substitutes A[i,j] for A[j,i] exactly
            raise ValueError(
                "symmetric=True declared but the matrix is not bitwise "
                "symmetric (mat != mat.T); the upper-triangle kernel would "
                "compute a wrong answer"
            )
        if cand is not None and bool(sym_ok):
            config = cand
    return _solve_fn(config, backend, dev)(mat)


def _prequantized(config: SolverConfig, mat: jax.Array, backend: str) -> bool:
    """A matrix already in ``storage_dtype`` is solved as-is by the
    storage-capable backends — no transient f32 copy, which would double
    memory at exactly the scale reduced-precision storage exists for."""
    return (
        config.storage_dtype is not None
        and mat.dtype == jnp.dtype(config.storage_dtype)
        and backend in ("matvec", "multiround")
    )


@partial(jax.jit, static_argnames=("check_sym",))
def _validate_on_device(mat: jax.Array, check_sym: bool):
    """``validate=True``'s O(n²) structure checks — positivity and
    (when routing wants it) bitwise symmetry — in one dispatch."""
    pos = jnp.all(mat > 0)
    sym = jnp.all(mat == mat.T) if check_sym else jnp.asarray(False)
    return pos, sym


def eigen_residual(mat: jax.Array, result: SolveResult) -> jax.Array:
    """``max |A·v − λ·v|`` — the eigen-pair acceptance check of the
    reference's wrapper test (``wrapper/python/test.py:15-16``, atol 1e-3)
    as a jittable one-liner.

    Works on sharded inputs unchanged: with a row-sharded ``mat`` and the
    sharded result's eigenvector, GSPMD partitions the matvec and inserts
    the gather (this is how the multi-host worker validates its global
    solve, bench/mh_worker.py)."""
    v = result.eigenvector
    # HIGHEST: a TF32 product would add ~λ·1e-3 of its own error to the
    # residual it is meant to measure (solver_matvec.dot_f32)
    Av = jnp.dot(mat, v, precision=jax.lax.Precision.HIGHEST)
    return jnp.max(jnp.abs(Av - result.eigenvalue * v))


def _reject_unsupported(config: SolverConfig, entry: str, checks) -> None:
    """Raise on config knobs ``entry`` cannot honor (the honored-or-
    rejected contract, VERDICT r3 item 3).  ``checks`` is an iterable of
    ``(knob, is_default, why)``."""
    for knob, is_default, why in checks:
        if not is_default:
            raise ValueError(
                f"{knob}={getattr(config, knob)!r} is not supported by "
                f"{entry} — {why}; it would be silently dropped"
            )


def max_eigenvalue_batch(
    mats: jax.Array, config: SolverConfig = DEFAULT_CONFIG, mesh=None
) -> SolveResult:
    """Batched solves over ``mats`` of shape (B, n, n); result leaves carry
    a leading batch axis with per-matrix round counts (see
    parallel/batched.py for the masked-loop semantics).

    ``mesh`` mirrors :func:`max_eigenvalue`'s one-argument door to
    `parallel/`: a mesh with a ``"batch"`` axis shards the batch (DP-like,
    solve_batched_sharded); a mesh with BOTH ``"batch"`` and ``"rows"``
    axes also shards each matrix's rows (DP×TP composition,
    solve_batched_rowsharded — BASELINE config 4's layout).

    Honors eps / max_itr / dtype / eps_mode / storage_dtype; the batched
    bodies are the vmapped matvec-form solver, so any other backend
    choice (and the kernel knobs) is rejected rather than silently
    dropped.
    """
    from .parallel.batched import solve_batched

    _reject_unsupported(
        config,
        "max_eigenvalue_batch",
        (
            ("backend", config.backend in ("auto", "matvec"),
             "the batched body is the vmapped matvec-form solver "
             "(parallel/batched.py); under vmap the hot op is a batched "
             "gemv"),
            ("chunk", config.chunk is None,
             "the multiround loop has no batched form"),
            ("interpret", config.interpret is None,
             "the batched body runs no Pallas kernel"),
            ("symmetric", not config.symmetric,
             "the upper-triangle kernel has no batched form; the batched "
             "gemv streams full matrices"),
        ),
    )
    mats = jnp.asarray(mats)
    # honor storage_dtype exactly like the single-device and mesh paths: a
    # batch already in storage_dtype is solved as-is — materializing a
    # transient f32 copy would double memory at exactly the scale the
    # reduced-precision mode exists for
    if not (
        config.storage_dtype is not None
        and mats.dtype == jnp.dtype(config.storage_dtype)
    ):
        mats = mats.astype(config.dtype)
    if mesh is not None:
        if "batch" not in mesh.shape:
            raise ValueError(
                f"a batched mesh needs a 'batch' axis — got axes "
                f"{tuple(mesh.shape)}; build it with "
                "Mesh(devs, ('batch',)) or make_mesh2d(pb, pr, 'batch', 'rows')"
            )
        if "rows" in mesh.shape:
            from .parallel.sharded import solve_batched_rowsharded

            return solve_batched_rowsharded(mats, mesh, config=config)
        from .parallel.batched import solve_batched_sharded

        return solve_batched_sharded(mats, mesh, config=config)
    return solve_batched(
        mats,
        config.eps,
        config.max_itr,
        storage_dtype=config.storage_dtype,
        eps_mode=config.eps_mode,
    )


def max_eigenvalue_operator(
    matvec, n: int, config: SolverConfig = DEFAULT_CONFIG
) -> SolveResult:
    """Matrix-free solve: ``matvec(x) -> A @ x`` for an implicit positive
    operator that is never materialized (structured matrices with fast
    matvecs, operator sums/products, matrices too large to store).  See
    :func:`eigen_value.ops.solver_matvec.solve_operator` for the
    semantics and the round-count caveat.  Traced — jittable as-is.

    λ-SCALE LIMIT of the default stop: the reference-exact ``eps_mode=
    "absolute"`` compares adjacent row sums against a RAW eps=1e-3 while
    the row sums converge to λ — f32 matvec rounding noise scales with
    λ·n, so for operators with λ ≳ 10³ (e.g. Kronecker products of
    unnormalized factors: λ = λ_B·λ_C) the check may never fire and the
    solve exhausts ``max_itr`` (``converged=False``).  For such operators
    pass ``config=SolverConfig(eps_mode="relative")`` (tol = eps·max|v|,
    scale-invariant) or pre-scale with
    :func:`~eigen_value.ops.structured.scale_matvec` (λ scales by
    exactly α).  The reference never hits this: its only workload has
    λ ≈ 2.6 (similarity_transform.hpp:4 semantics preserved as default).

    Honors eps / max_itr / dtype / eps_mode; a matrix-free solve observes
    A only through ``matvec``, so the dense-backend knobs (backend,
    chunk, interpret, storage_dtype, symmetric) are rejected rather than
    silently dropped — precision/storage of the operator's internals
    belongs to the caller's ``matvec``.
    """
    from .ops.solver_matvec import solve_operator

    _reject_unsupported(
        config,
        "max_eigenvalue_operator",
        (
            ("backend", config.backend in ("auto", "matvec"),
             "a matrix-free solve IS the matvec-form loop; dense backends "
             "don't apply"),
            ("storage_dtype", config.storage_dtype is None,
             "the operator is never materialized — reduced-precision "
             "storage belongs inside the caller's matvec"),
            ("chunk", config.chunk is None,
             "the multiround loop needs a materialized matrix"),
            ("interpret", config.interpret is None,
             "no Pallas kernel runs on the operator path"),
            ("symmetric", not config.symmetric,
             "a matrix-free solve observes A only through matvec — "
             "exploiting symmetry belongs inside the caller's matvec"),
        ),
    )
    return solve_operator(
        matvec,
        n,
        config.eps,
        config.max_itr,
        dtype=config.dtype,
        eps_mode=config.eps_mode,
    )


class EigenValue:
    """Class-shaped API with the reference wrapper's return convention.

    ``similarity_transform(mat) -> (eigenvalue, eigenvector, ts_ms, rounds)``
    exactly as ``wrapper/python/similarity_transform.py:42-78`` — except
    ``ts_ms`` is a float (the reference truncates to whole ms) and inputs of
    any float dtype are accepted (cast to ``config.dtype``; the reference
    hard-asserts float32).

    ``ts_ms`` is the host wall time of the solve call, ended by
    ``block_until_ready``: compilation happens before the clock starts
    (once per (shape, dtype, backend), or ahead of time with
    :meth:`warmup`), so it brackets the device loop, like the reference's
    clock (similarity_transform.cpp:36-58).

    THREAD SAFETY: the compilation cache is guarded, so concurrent
    ``similarity_transform`` calls on one instance compute correctly and
    compile each (shape, dtype, backend) once; solves themselves
    serialize on a single device.
    """

    def __init__(
        self,
        config: SolverConfig = DEFAULT_CONFIG,
        device: Optional[jax.Device] = None,
    ) -> None:
        """``device`` pins all solves to one device — the analog of the
        reference's SYCL device selection at queue construction
        (wrapper/similarity_transform.cpp:4-12, default_selector in
        main.cpp:10).  None = the platform default."""
        import threading

        self.config = config
        self.device = device
        self._compiled = {}
        self._compile_lock = threading.Lock()

    def _get_compiled(self, n: int, dtype):
        backend = resolve_backend(self.config)
        key = (n, jnp.dtype(dtype).name, backend)
        fn = self._compiled.get(key)
        if fn is None:
            # lock so concurrent servers compile each key once (the race
            # would be correct but wastes a multi-second compile per racer)
            with self._compile_lock:
                fn = self._compiled.get(key)
                if fn is None:
                    solve = _solve_fn(self.config, backend, self.device)
                    aval = jax.ShapeDtypeStruct(
                        (n, n),
                        dtype,
                        sharding=(
                            jax.sharding.SingleDeviceSharding(self.device)
                            if self.device is not None
                            else None
                        ),
                    )
                    fn = jax.jit(solve).lower(aval).compile()
                    self._compiled[key] = fn
        return fn

    def warmup(self, dims, dtype=None) -> None:
        """Pre-compile the solver for the given dims (the AOT analog of the
        reference's aot_cpu/aot_gpu build targets, Makefile:44-64)."""
        dtype = dtype or self.config.dtype
        for n in dims:
            self._get_compiled(n, dtype)

    def similarity_transform(
        self, mat
    ) -> Tuple[np.float32, np.ndarray, float, int]:
        if self.device is not None and not isinstance(mat, jax.Array):
            # place host data directly on the pinned device — going through
            # jnp.asarray first would bounce the O(n²) payload off the
            # default device
            mat = jax.device_put(np.asarray(mat), self.device)
        mat = jnp.asarray(mat)
        if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
            raise ValueError(
                f"must be a square matrix of floating points, got shape "
                f"{mat.shape}"
            )
        n = mat.shape[0]
        if not _prequantized(self.config, mat, resolve_backend(self.config)):
            mat = mat.astype(self.config.dtype)
        if self.device is not None:
            mat = jax.device_put(mat, self.device)  # no-op if already there
        fn = self._get_compiled(n, mat.dtype)

        start = time.perf_counter()
        res = jax.block_until_ready(fn(mat))
        ts_ms = (time.perf_counter() - start) * 1e3

        return (
            np.asarray(res.eigenvalue)[()],
            np.asarray(res.eigenvector),
            ts_ms,
            int(res.rounds),
        )
