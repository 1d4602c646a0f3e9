"""Public API tests: EigenValue class shape + functional entry."""

import numpy as np
import pytest

from eigen_value import (
    EigenValue,
    SolverConfig,
    max_eigenvalue,
    max_eigenvalue_batch,
)
from eigen_value.api import resolve_backend, uses_symmetric_kernel


def test_eigenvalue_class_return_shape(rng):
    ev = EigenValue()
    mat = rng.random((256, 256), dtype=np.float32)
    lam, vec, ts_ms, rounds = ev.similarity_transform(mat)
    assert np.isscalar(lam) or lam.shape == ()
    assert vec.shape == (256,)
    assert ts_ms > 0
    assert isinstance(rounds, int) and 0 <= rounds <= 1000
    assert np.allclose(mat @ vec, lam * vec, atol=1e-3)


def test_compile_cache_reused(rng):
    ev = EigenValue()
    mat = rng.random((128, 128), dtype=np.float32)
    ev.similarity_transform(mat)
    n_compiled = len(ev._compiled)
    ev.similarity_transform(mat)
    assert len(ev._compiled) == n_compiled


def test_rejects_non_square(rng):
    """Both entries raise a descriptive ValueError (review r5c: the
    class API used a bare assert — gone under python -O — and crashed
    with a context-free unpack error on non-2D input)."""
    with pytest.raises(ValueError, match="square matrix"):
        EigenValue().similarity_transform(rng.random((4, 8), dtype=np.float32))
    with pytest.raises(ValueError, match="square matrix"):
        EigenValue().similarity_transform(np.ones((4, 4, 4), np.float32))
    with pytest.raises(ValueError, match="square matrix"):
        max_eigenvalue(rng.random((4, 8), dtype=np.float32))


def test_max_eigenvalue_functional(rng):
    mat = rng.random((128, 128), dtype=np.float32)
    res = max_eigenvalue(mat)
    assert bool(res.converged)
    assert np.allclose(
        mat @ np.asarray(res.eigenvector),
        float(res.eigenvalue) * np.asarray(res.eigenvector),
        atol=1e-3,
    )


def test_validate_rejects_nonpositive(rng):
    m = rng.random((16, 16), dtype=np.float32)
    m[3, 5] = -1.0
    with pytest.raises(ValueError, match="entries > 0"):
        max_eigenvalue(m, validate=True)
    # without validate the check is skipped (jittable path): the same
    # nonpositive matrix must NOT raise (result is unchecked garbage —
    # that's the documented contract)
    max_eigenvalue(m)
    # and a positive matrix passes validation
    max_eigenvalue(np.abs(m) + 1e-3, validate=True)


def test_max_eigenvalue_batch(rng):
    mats = rng.random((3, 64, 64), dtype=np.float32) + 1e-4
    res = max_eigenvalue_batch(mats)
    assert res.eigenvalue.shape == (3,)
    for b in range(3):
        v = np.asarray(res.eigenvector[b])
        assert np.allclose(mats[b] @ v, float(res.eigenvalue[b]) * v, atol=1e-3)


def test_warmup_precompiles(rng):
    ev = EigenValue()
    ev.warmup([64, 128])
    assert len(ev._compiled) == 2
    ev.similarity_transform(rng.random((64, 64), dtype=np.float32))
    assert len(ev._compiled) == 2  # cache hit, no new compile


def test_bf16_storage_config(rng):
    cfg = SolverConfig(backend="matvec", storage_dtype="bfloat16")
    mat = rng.random((128, 128), dtype=np.float32) + 1e-3
    res = max_eigenvalue(mat, cfg)
    v = np.asarray(res.eigenvector)
    lam = float(res.eigenvalue)
    # bf16 storage: ~1e-3 RELATIVE accuracy (λ ≈ 64 here, so scale atol)
    assert np.allclose(mat @ v, lam * v, atol=2e-3 * lam)
    want = max_eigenvalue(mat)  # f32 reference
    assert abs(lam - float(want.eigenvalue)) < 2e-3 * lam


def test_symmetric_kernel_routing():
    """symmetric=True is honored with the kernel by explicit matvec /
    multiround backends; under auto the kernel is taken on a GPU with f32
    storage, or when the caller asks for the interpreter — never chosen
    for a caller on another platform."""
    import types

    import jax.numpy as jnp

    gpu = types.SimpleNamespace(platform="gpu")
    cpu = types.SimpleNamespace(platform="cpu")
    assert not uses_symmetric_kernel(SolverConfig(), gpu)
    assert uses_symmetric_kernel(SolverConfig(symmetric=True), gpu)
    assert not uses_symmetric_kernel(SolverConfig(symmetric=True), cpu)
    assert uses_symmetric_kernel(
        SolverConfig(symmetric=True, interpret=True), cpu
    )
    # bf16 storage: the dense storage product measured faster than the
    # kernel, so auto keeps the job dense even on a GPU
    assert not uses_symmetric_kernel(
        SolverConfig(symmetric=True, storage_dtype=jnp.bfloat16), gpu
    )
    # an explicit backend honors the declaration wherever it runs
    assert uses_symmetric_kernel(
        SolverConfig(symmetric=True, backend="multiround"), cpu
    )


def test_backend_resolution():
    # auto is the dense XLA matvec-form solve, whatever the platform
    assert resolve_backend(SolverConfig(backend="auto")) == "matvec"
    assert resolve_backend(SolverConfig(backend="xla")) == "xla"
    assert resolve_backend(SolverConfig(backend="multiround")) == "multiround"


def test_auto_backend_nonpow2_aligned_dims(rng):
    """Dims that are not multiples of the kernel's power-of-two tile (384,
    1000) run the symmetric kernel with masked edge tiles and agree with
    the dense solve."""
    for n in (384, 1000):
        m = rng.random((n, n), dtype=np.float32) + 1e-4
        mat = (m + m.T) / 2
        res = max_eigenvalue(mat, SolverConfig(symmetric=True, interpret=True))
        ref = max_eigenvalue(mat, SolverConfig(backend="matvec"))
        assert abs(int(res.rounds) - int(ref.rounds)) <= 1
        assert float(res.eigenvalue) == pytest.approx(
            float(ref.eigenvalue), rel=1e-5
        )
        v = np.asarray(res.eigenvector)
        assert np.allclose(mat @ v, float(res.eigenvalue) * v, atol=1e-3 * n)


def test_resolve_backend_honors_pinned_device_platform():
    """A pinned device's platform, not the default one, decides whether the
    kernel can run: a GPU-pinned solve takes it, a CPU-pinned one keeps
    the dense product (and an explicit kernel request there raises)."""
    import types

    from eigen_value import api as api_mod

    cfg = SolverConfig(symmetric=True)
    assert uses_symmetric_kernel(cfg, types.SimpleNamespace(platform="gpu"))
    assert not uses_symmetric_kernel(cfg, types.SimpleNamespace(platform="cpu"))
    with pytest.raises(ValueError, match="GPU"):
        api_mod._solve_fn(
            SolverConfig(symmetric=True, backend="matvec"),
            "matvec",
            types.SimpleNamespace(platform="cpu"),
        )


def test_auto_picks_dense_matvec_at_every_dim():
    """auto resolves to the dense XLA matvec-form solve at every n: on the
    card XLA's product streams A near copy bandwidth, and no hand-written
    dense kernel beat it end to end."""
    from eigen_value.api import _solve_fn
    from eigen_value.ops import solver_matvec

    assert resolve_backend(SolverConfig()) == "matvec"
    fn = _solve_fn(SolverConfig(), "matvec")
    assert fn.func is solver_matvec.solve_matvec


def test_validate_promotes_symmetric_to_sym_kernel(monkeypatch, rng):
    """Once validate=True has paid for the on-device check, a bitwise-
    symmetric matrix routes to the upper-triangle kernel where auto would
    take it for a declared-symmetric input (a GPU with f32 storage).  The
    platform is faked as a GPU and the kernel interpreted so the
    promotion runs on the CPU suite."""
    from dataclasses import replace

    import jax.numpy as jnp

    import eigen_value.api as api_mod
    from eigen_value import fixtures

    seen = {}
    orig = api_mod._solve_fn

    def spy(config, backend, device=None):
        seen["symmetric"] = config.symmetric
        seen["backend"] = backend
        if config.symmetric:
            config = replace(config, interpret=True)
        return orig(config, backend, device)

    monkeypatch.setattr(api_mod, "_solve_fn", spy)
    monkeypatch.setattr(api_mod, "platform", lambda device=None: "gpu")

    H = fixtures.hilbert_matrix(256)  # symmetric by construction
    res = api_mod.max_eigenvalue(H, validate=True)
    assert seen["backend"] == "matvec"
    assert seen["symmetric"] is True
    assert int(res.rounds) == fixtures.HILBERT_ROUNDS[256]
    assert bool(res.converged)

    # a positive but NON-symmetric matrix at the same dim is not promoted
    A = np.asarray(H).copy()
    A[0, 1] *= 2.0
    res_ns = api_mod.max_eigenvalue(jnp.asarray(A), validate=True)
    assert seen["symmetric"] is False
    assert bool(res_ns.converged)

    # without validate there is no device check, hence no promotion (a
    # wrong silent guess would compute a wrong answer)
    api_mod.max_eigenvalue(H)
    assert seen["symmetric"] is False

    # an explicit backend choice is authoritative — no promotion
    api_mod.max_eigenvalue(
        H, config=SolverConfig(backend="matvec"), validate=True
    )
    assert seen["backend"] == "matvec"
    assert seen["symmetric"] is False


def test_storage_dtype_with_non_storage_backend_raises():
    """storage_dtype + an iterated backend (xla/pallas) is a contradictory
    config: those solvers mutate A and cannot honor the reduced-precision
    storage contract (an all-bf16 iteration can't represent the 1e-3 stop
    tolerance).  Silently running full-f32 misled memory budgeting — the
    API now refuses instead."""
    import jax.numpy as jnp
    import pytest

    from eigen_value import fixtures, max_eigenvalue

    Hq = fixtures.hilbert_matrix(128, dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="matvec-family"):
        max_eigenvalue(Hq, SolverConfig(backend="xla", storage_dtype=jnp.bfloat16))
    # the default auto backend resolves to a matvec family and honors it
    res = max_eigenvalue(Hq, SolverConfig(storage_dtype=jnp.bfloat16))
    assert bool(res.converged)
    assert res.eigenvalue.dtype == jnp.float32
    assert int(res.rounds) <= fixtures.HILBERT_ROUNDS[128] + 1


def test_max_eigenvalue_batch_prequantized_no_f32_copy():
    """A batch already in storage_dtype must be solved as-is (the f32
    round-trip would double memory at exactly the scale the fast mode
    exists for)."""
    import jax.numpy as jnp

    from eigen_value import fixtures, max_eigenvalue_batch

    Hq = fixtures.hilbert_matrix(128, dtype=jnp.bfloat16)
    mats = jnp.stack([Hq, Hq * jnp.bfloat16(2.0)])
    res = max_eigenvalue_batch(mats, SolverConfig(storage_dtype=jnp.bfloat16))
    assert res.eigenvalue.shape == (2,)
    assert bool(jnp.all(res.converged))
    # λ(2A) = 2λ(A): the scaled copy really was solved independently
    ratio = float(res.eigenvalue[1] / res.eigenvalue[0])
    assert abs(ratio - 2.0) < 0.05


def test_float64_without_x64_raises():
    import jax
    import numpy as np_

    if jax.config.jax_enable_x64:
        pytest.skip("x64 enabled in this environment")
    with pytest.raises(ValueError, match="x64"):
        SolverConfig(dtype=np_.float64)


def test_max_eigenvalue_with_mesh():
    """The functional API routes to the sharded solver when given a mesh."""
    import jax
    from jax.sharding import Mesh

    from eigen_value import fixtures

    mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("rows",))
    H = fixtures.hilbert_matrix(256)
    got = max_eigenvalue(H, mesh=mesh)
    assert bool(got.converged)
    assert int(got.rounds) == fixtures.HILBERT_ROUNDS[256]
    want = max_eigenvalue(H)
    assert abs(float(got.eigenvalue) - float(want.eigenvalue)) < 1e-4


def test_ts_ms_is_wall_time(rng):
    """ts_ms is the host wall time of the solve call ended by
    block_until_ready: positive, and inside the caller's own clock around
    the whole similarity_transform (compilation happens before it)."""
    import time

    from eigen_value.api import EigenValue

    ev = EigenValue()
    mat = rng.random((256, 256), dtype=np.float32) + 0.5
    ev.warmup([256])
    t0 = time.perf_counter()
    lam, vec, ts_ms, rounds = ev.similarity_transform(mat)
    outer_ms = (time.perf_counter() - t0) * 1e3
    assert 0.0 < ts_ms <= outer_ms
    assert not hasattr(ev, "_rtt_ms")


def test_eigen_residual_helper(rng):
    """eigen_residual = the reference wrapper test's acceptance check
    (wrapper/python/test.py:15-16) as a public jittable helper."""
    import jax

    from eigen_value import eigen_residual, max_eigenvalue

    import jax.numpy as jnp

    mat = jnp.asarray(rng.random((128, 128), dtype=np.float32) + 1e-2)
    res = max_eigenvalue(mat)
    r = float(eigen_residual(mat, res))
    assert r < 1e-3
    # jittable (fusion may round the last ulps differently)
    r2 = float(jax.jit(eigen_residual)(mat, res))
    assert r2 == pytest.approx(r, abs=1e-5)
    # sharded inputs compose via GSPMD
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("rows",))
    ms = jax.device_put(mat, NamedSharding(mesh, P("rows", None)))
    from eigen_value.parallel import solve_sharded_matvec

    res_s = solve_sharded_matvec(ms, mesh)
    assert float(eigen_residual(ms, res_s)) < 1e-3


def test_concurrent_similarity_transform_threads(rng, monkeypatch):
    """Serving contract: concurrent calls on one instance are correct and
    compile each (shape, dtype, backend) exactly once (guarded cache —
    counted via a wrapped _solve_fn, since the dict would show one entry
    even if every thread had compiled and overwritten it)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from eigen_value import api

    calls = []
    real = api._solve_fn

    def counting_solve_fn(*a, **kw):
        calls.append(threading.get_ident())
        return real(*a, **kw)

    monkeypatch.setattr(api, "_solve_fn", counting_solve_fn)
    ev = EigenValue()
    mats = [rng.random((96, 96), dtype=np.float32) + 1e-3 for _ in range(8)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(ev.similarity_transform, mats))
    assert len(calls) == 1  # exactly one build+compile across 8 racers
    assert len(ev._compiled) == 1
    for mat, (lam, vec, ts, rounds) in zip(mats, results):
        assert np.allclose(mat @ vec, lam * vec, atol=1e-3)


def test_public_export_surface():
    """Every name in __all__ resolves, and the two passively-used
    exports hold their contracts: DEFAULT_CONFIG is the reference-
    constant SolverConfig (EPS/MAX_ITR exactly the reference's
    similarity_transform.hpp:4-5 values) and SolveResult is the
    4-field namedtuple every solver returns."""
    import eigen_value as evt

    for name in evt.__all__:
        assert getattr(evt, name) is not None, name
    assert evt.DEFAULT_CONFIG == evt.SolverConfig()
    assert evt.DEFAULT_CONFIG.eps == evt.EPS == 1e-3
    assert evt.DEFAULT_CONFIG.max_itr == evt.MAX_ITR == 1000
    assert evt.SolveResult._fields == (
        "eigenvalue", "eigenvector", "rounds", "converged",
    )


def test_removed_backends_rejected():
    """The iterated-kernel and dense-kernel backends are gone; asking for
    them is an error, never a silent fallback."""
    for name in ("pallas", "matvec_pallas"):
        with pytest.raises(ValueError, match="unknown backend"):
            SolverConfig(backend=name)


def test_class_api_prequantized_no_upcast(rng):
    """The class API honors the storage_dtype no-f32-copy contract like
    the functional path (review r5c: it used to cast a prequantized
    matrix to f32 first — 2× peak memory at storage scale)."""
    import jax.numpy as jnp

    cfg = SolverConfig(backend="matvec", storage_dtype="bfloat16")
    mat = rng.random((128, 128), dtype=np.float32) + 1e-3
    pre = jnp.asarray(mat).astype(jnp.bfloat16)
    ev = EigenValue(cfg)
    lam, v, _, itr = ev.similarity_transform(pre)
    want = max_eigenvalue(pre, cfg)  # the functional prequantized path
    assert float(lam) == float(want.eigenvalue)
    assert itr == int(want.rounds)
    # the compile cache must have been keyed on the STORAGE dtype (proof
    # the f32 cast never happened)
    assert any(k[1] == "bfloat16" for k in ev._compiled)
