"""Row-partitioned multi-chip solver via `shard_map` over a device mesh.

The reference is single-device (SURVEY.md §2: no MPI/NCCL, one sycl::queue);
scaling beyond one card is the capability this build adds per the north
star (BASELINE.json).  Design (SURVEY.md §7):

  * A is sharded along rows: shard p holds rows ``[p·n/P, (p+1)·n/P)`` —
    every row is complete locally, so per-shard row sums need no collective.
  * The scaling vector v is the one exchanged object: each round does a
    single ``all_gather`` of the per-shard row-sum slices (O(n) over
    NVLink, negligible next to the O(n²/P) matrix pass).
  * max, stop check, and λ readout are computed redundantly on every shard
    from the replicated v — cheaper than a second collective, and it keeps
    the `lax.while_loop` predicate identical on all shards so the loop exits
    in lockstep.
  * The similarity update needs v[r] for local rows (a dynamic slice of the
    gathered v) and v[c] for ALL columns (the gathered v itself) — exactly
    the data dependence noted at reference similarity_transform.cpp:318-325.

The whole while-loop runs inside shard_map: zero host round-trips, one
collective per round.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_CONFIG, SolverConfig
from ..ops.solver import SolveResult, stop_check
from ..ops.solver_matvec import (
    _finish,
    _init_carry,
    _make_cond_body,
    dot_f32,
    storage_matvec,
)

try:  # jax >= 0.6 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _exp_shard_map

    def shard_map(f, *, mesh, in_specs, out_specs, check_vma=True):
        # the experimental API spells the kwarg ``check_rep`` — without
        # this translation the fallback could never be called (every
        # call site passes check_vma; review r5c)
        return _exp_shard_map(
            f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_rep=check_vma,
        )


def require_axis(mesh: Mesh, axis_name: str) -> int:
    """The size of ``axis_name`` in ``mesh``, with a descriptive error when
    the axis is absent (a bare KeyError from ``mesh.shape[...]`` hides
    WHICH mesh/axis to fix — the 2D path already raised helpfully; the 1D
    entries route through here for the same courtesy)."""
    if axis_name not in mesh.shape:
        raise ValueError(
            f"mesh has no '{axis_name}' axis (axes: {tuple(mesh.shape)}) — "
            "build it with make_row_mesh/make_global_row_mesh or pass the "
            "axis_name your mesh actually uses"
        )
    return mesh.shape[axis_name]


def _validate_and_place(A: jax.Array, mesh: Mesh, axis_name: str):
    """Shared entry prologue of the 1D row-sharded solvers: shape
    validation (square 2-D — review r5c: the checks lived in only one of
    the four entries, so a non-square A died with cryptic trace errors,
    or in the 2D path returned silently wrong results via clamped
    dynamic slices), axis lookup, divisibility, and row-sharded
    placement.  Returns ``(A_placed, n, n_shards)``."""
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"must be a square matrix, got shape {A.shape}")
    n = A.shape[0]
    n_shards = require_axis(mesh, axis_name)
    if n % n_shards != 0:
        raise ValueError(f"dim {n} not divisible by {n_shards} shards")
    A = jax.device_put(A, NamedSharding(mesh, P(axis_name, None)))
    return A, n, n_shards


def _reject_sharded_unsupported(
    config: SolverConfig, entry: str, *, storage_ok: bool = True
) -> None:
    """Honor-or-reject for DIRECT calls into the sharded entries.
    ``api.py``'s mesh path enforces the full config contract, but
    ``parallel/`` is public API and api.py explicitly sends users here
    for the ring/batched variants — these entries used to silently drop
    the single-chip-only knobs (review r5c).  The matvec-family bodies
    honor ``storage_dtype``; the iterated body (``storage_ok=False``)
    cannot."""
    checks = [
        ("symmetric", not config.symmetric,
         "the upper-triangle kernel is single-device"),
        ("chunk", config.chunk is None,
         "the multiround loop is single-device only"),
        ("interpret", config.interpret is None,
         "the sharded bodies run no Pallas kernel"),
    ]
    if not storage_ok:
        checks.append(
            ("storage_dtype", config.storage_dtype is None,
             "the iterated body mutates A and cannot honor the storage "
             "contract"),
        )
    for knob, is_default, why in checks:
        if not is_default:
            raise ValueError(
                f"{knob}={getattr(config, knob)!r} is not supported by "
                f"{entry} — {why}; it would be silently dropped"
            )


def _shard_round_body(
    eps: float, max_itr: int, axis_name: str, eps_mode: str = "absolute"
):
    """Build the per-shard while_loop solver. Runs under shard_map."""

    def solve_block(A_blk: jax.Array) -> SolveResult:
        n_loc, n = A_blk.shape
        dtype = A_blk.dtype
        p = lax.axis_index(axis_name)
        row0 = p * n_loc

        def gather_rowsums(A_blk):
            v_loc = jnp.sum(A_blk, axis=1)  # local rows are complete
            return lax.all_gather(v_loc, axis_name, tiled=True)  # (n,)

        v0 = gather_rowsums(A_blk)
        ev0 = jnp.ones((n_loc,), dtype)

        # Round-2 loop structure (ops/solver_matvec.py): stop check in the
        # COND — the converging round's O(n²) similarity update is skipped
        # by loop EXIT rather than an in-body lax.cond branch, and its ev
        # update runs after the loop.  Same v-sequence bit-for-bit.
        def cond(c):
            A_blk, v, ev, lam, i = c
            # v is replicated (gather completes every round), so the
            # single-chip stop — including eps_mode="relative"'s
            # tol = eps·max|v| — evaluates identically on every shard.
            return (i < max_itr) & jnp.logical_not(
                stop_check(v, eps, eps_mode)
            )

        def body(c):
            A_blk, v, ev, lam, i = c
            m = jnp.max(v)
            one = jnp.asarray(1.0, dtype)
            v_rows = lax.dynamic_slice(v, (row0,), (n_loc,))
            ev = ev * (v_rows / m)
            lam = v[0]
            A_blk = A_blk * ((one / v_rows)[:, None] * v[None, :])
            return (A_blk, gather_rowsums(A_blk), ev, lam, i + 1)

        init = (
            A_blk,
            v0,
            ev0,
            jnp.asarray(0.0, dtype),
            jnp.asarray(0, jnp.int32),
        )
        _, v, ev, lam_prev, i = lax.while_loop(cond, body, init)
        converged = i < max_itr
        v_rows = lax.dynamic_slice(v, (row0,), (n_loc,))
        ev = jnp.where(converged, ev * (v_rows / jnp.max(v)), ev)
        lam = jnp.where(converged, v[0], lam_prev)
        return SolveResult(lam, ev, i, converged)

    return solve_block


@partial(
    jax.jit, static_argnames=("mesh", "axis_name", "eps", "max_itr", "eps_mode")
)
def _solve_sharded_jit(A, mesh, axis_name, eps, max_itr, eps_mode="absolute"):
    solve_block = _shard_round_body(eps, max_itr, axis_name, eps_mode)
    fn = shard_map(
        solve_block,
        mesh=mesh,
        in_specs=P(axis_name, None),
        out_specs=SolveResult(P(), P(axis_name), P(), P()),
        check_vma=False,  # λ/rounds/done are replicated by construction
    )
    return fn(A)


def solve_sharded(
    A: jax.Array,
    mesh: Mesh,
    axis_name: str = "rows",
    config: SolverConfig = DEFAULT_CONFIG,
) -> SolveResult:
    """Row-partitioned solve of one n×n positive matrix over ``mesh``.

    n must be divisible by the mesh axis size.  Returns the same
    :class:`SolveResult` as the single-chip path, with the eigenvector
    sharded across rows.
    """
    _reject_sharded_unsupported(config, "solve_sharded", storage_ok=False)
    A, n, n_shards = _validate_and_place(A, mesh, axis_name)
    return _solve_sharded_jit(
        A, mesh, axis_name, config.eps, config.max_itr, config.eps_mode
    )


def _shard_matvec_body(
    eps: float,
    max_itr: int,
    axis_name: str,
    storage_dtype=None,
    eps_mode: str = "absolute",
):
    """Per-shard matvec-form loop (see ops/solver_matvec.py for the algebra):
    each round is one local matvec against the ORIGINAL row shard plus one
    O(n) all_gather — 3× less memory traffic per round than the iterated
    form, and A is never written (halves per-shard memory).

    ``storage_dtype`` (e.g. bf16) casts the local shard ONCE and runs the
    per-round product as ``storage_matvec`` (f32 products against the f32
    ev), while all O(n) state (v, ev, stop check, λ) stays float32 — the
    exact semantics of the single-device fast mode."""

    def solve_block(A_blk: jax.Array, ev0_scale: jax.Array) -> SolveResult:
        n_loc, n = A_blk.shape
        Aq_blk = A_blk if storage_dtype is None else A_blk.astype(storage_dtype)
        dtype = A_blk.dtype if storage_dtype is None else jnp.float32
        p = lax.axis_index(axis_name)
        row0 = p * n_loc

        def local_matvec(ev):
            if storage_dtype is not None:
                return storage_matvec(Aq_blk, ev)
            # f32-pinned: a TF32 product breaks the absolute stop for
            # large-λ inputs (solver_matvec.dot_f32)
            return dot_f32(A_blk, ev)

        def next_v(ev):
            # v[r] = (A0 @ ev)[r] / ev[r] for local rows, gathered to full
            ev_rows = lax.dynamic_slice(ev, (row0,), (n_loc,))
            v_loc = local_matvec(ev) / ev_rows
            return lax.all_gather(v_loc, axis_name, tiled=True)

        ev0 = jnp.ones((n,), dtype) * ev0_scale.astype(dtype)

        # v is replicated (the gather completes every round), so the round
        # is EXACTLY the single-device matvec-form round — reuse its one
        # definition (cond/body/epilogue, incl. the eps_mode tolerance
        # semantics) and slice the local ev after.
        cond, body = _make_cond_body(next_v, eps, max_itr, eps_mode)
        init = _init_carry(n, next_v, dtype, ev0)
        res = _finish(lax.while_loop(cond, body, init), max_itr)
        ev_loc = lax.dynamic_slice(res.eigenvector, (row0,), (n_loc,))
        return res._replace(eigenvector=ev_loc)

    return solve_block


@partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "axis_name",
        "eps",
        "max_itr",
        "storage_dtype",
        "eps_mode",
    ),
)
def _solve_sharded_matvec_jit(
    A,
    mesh,
    axis_name,
    eps,
    max_itr,
    storage_dtype=None,
    ev0_scale=None,
    eps_mode="absolute",
):
    solve_block = _shard_matvec_body(
        eps, max_itr, axis_name, storage_dtype, eps_mode
    )
    fn = shard_map(
        solve_block,
        mesh=mesh,
        in_specs=(P(axis_name, None), P()),
        out_specs=SolveResult(P(), P(axis_name), P(), P()),
        check_vma=False,  # λ/rounds/done are replicated by construction
    )
    if ev0_scale is None:
        ev0_scale = jnp.float32(1.0)
    return fn(A, jnp.asarray(ev0_scale, jnp.float32))


def solve_sharded_matvec(
    A: jax.Array,
    mesh: Mesh,
    axis_name: str = "rows",
    config: SolverConfig = DEFAULT_CONFIG,
    ev0_scale: jax.Array | float = 1.0,
) -> SolveResult:
    """Row-partitioned matvec-form solve — the production multi-device path.

    ``config.storage_dtype`` (bf16 fast mode) is honored exactly as on a
    single device: the shard is cast once, products are f32, and all
    O(n) state stays float32.  A may also arrive pre-cast in
    ``storage_dtype`` (no f32 copy is ever made — how shard-scale dims
    whose f32 copy would not fit are solved).

    ``config.eps_mode`` is honored with the single-device semantics (the
    gathered v is replicated, so the relative tolerance eps·max|v| needs
    no extra collective).
    """
    _reject_sharded_unsupported(config, "solve_sharded_matvec")
    A, n, n_shards = _validate_and_place(A, mesh, axis_name)
    return _solve_sharded_matvec_jit(
        A,
        mesh,
        axis_name,
        config.eps,
        config.max_itr,
        config.storage_dtype,
        ev0_scale,
        config.eps_mode,
    )


def _shard_matvec_ring_body(
    eps: float,
    max_itr: int,
    axis_name: str,
    storage_dtype=None,
    eps_mode: str = "absolute",
):
    """Fully distributed matvec-form loop with RING-pipelined communication.

    The plain sharded loop (``_shard_matvec_body``) all_gathers the O(n)
    vector, then runs the O(n²/P) local matvec — serializing a DCN/ICI
    latency per round.  Here nothing is ever gathered: the eigenvector
    stays sharded, and each round's matvec runs as P chunk-GEMVs while the
    ev chunks rotate around the ring via ``lax.ppermute`` — the classic
    compute/communication overlap (BASELINE north star: "all-reduce ...
    overlapped with row-sum pass").  XLA's latency-hiding scheduler issues the next
    permute before the current chunk's GEMV completes, hiding the wire
    time behind compute; per round the only blocking collectives are three
    scalar reductions (max, stop, λ).

    Chunk partials are accumulated in source order (not arrival order) so
    the reduction order — and therefore the float32 round count — is
    identical on every SHARD (deterministic for a given P).  Across
    DIFFERENT P the row dot is grouped into P partials, a different f32
    rounding than one length-n dot, so cross-P round equality is only the
    usual ±1 float32 slack (same caveat as the 2D body's pc partials);
    Hilbert parity across the shipped mesh sizes is pinned empirically by
    tests/test_parallel.py, not structurally guaranteed.
    """

    def solve_block(A_blk: jax.Array, ev0_scale: jax.Array) -> SolveResult:
        n_loc, n = A_blk.shape
        Aq_blk = A_blk if storage_dtype is None else A_blk.astype(storage_dtype)
        dtype = A_blk.dtype if storage_dtype is None else jnp.float32
        p = lax.axis_index(axis_name)
        n_shards = n // n_loc
        perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]

        def ring_matvec(ev_loc):
            """(A_blk @ ev_full)[local rows] without materializing ev_full:
            rotate ev chunks through the ring, one chunk-GEMV per step.
            With ``storage_dtype`` the chunk GEMVs are ``storage_matvec``;
            the rotating chunks stay f32 on the wire (an O(n) exchange —
            precision is free, bandwidth negligible)."""

            def gemv_into(s, chunk, parts):
                src = (p - s) % n_shards  # owner of the chunk now held
                blk = lax.dynamic_slice(
                    Aq_blk, (jnp.int32(0), src * n_loc), (n_loc, n_loc)
                )
                if storage_dtype is None:
                    y = dot_f32(blk, chunk)
                else:
                    y = storage_matvec(blk, chunk)
                return lax.dynamic_update_slice(
                    parts, y[None, :], (src, jnp.int32(0))
                )

            def step(s, carry):
                chunk, parts = carry
                parts = gemv_into(s, chunk, parts)
                chunk = lax.ppermute(chunk, axis_name, perm)
                return chunk, parts

            parts0 = jnp.zeros((n_shards, n_loc), dtype)
            chunk, parts = lax.fori_loop(
                0, n_shards - 1, step, (ev_loc, parts0)
            )
            # the LAST chunk's GEMV consumes the carried chunk in place:
            # rotating it home afterwards was one discarded O(n/P) wire
            # hop per matvec (review r5c) — n_shards-1 ppermutes suffice.
            # parts is written by source index and reduced once below, so
            # dropping the rotation changes no value.
            parts = gemv_into(n_shards - 1, chunk, parts)
            # fixed source order: deterministic for THIS P (cross-P round
            # equality stays the empirical ±1-ulp story in the docstring)
            return jnp.sum(parts, axis=0)

        def next_v(ev_loc):
            return ring_matvec(ev_loc) / ev_loc

        ev0 = jnp.ones((n_loc,), dtype) * ev0_scale.astype(dtype)
        v0 = next_v(ev0)

        # Round-2 loop structure: the stop predicate (already a pmin —
        # replicated) moves into the COND so the body is branch-free; the
        # converging round's ev update and λ readout run after the loop.
        # Unlike the gathered/2D bodies this loop CANNOT reuse
        # solver_matvec._make_cond_body: v stays SHARDED here, so stop/max/λ
        # are collective forms (pmin wraparound, pmax, masked psum), not the
        # replicated stop_check/jnp.max/v[0] expressions.
        def stop_only(v_loc):
            """Wraparound stop from shard-local slices: the neighbor of the
            last local element is the NEXT shard's first element (one tiny
            ppermute); replicated via pmin.  In relative mode the
            tolerance is eps·max|v| — v stays sharded here, so the global
            max|v| needs one extra scalar pmax (the other bodies read it
            from the replicated v for free)."""
            e = jnp.asarray(eps, dtype)
            if eps_mode == "relative":
                e = e * lax.pmax(jnp.max(jnp.abs(v_loc)), axis_name)
            first_of_next = lax.ppermute(
                v_loc[0],
                axis_name,
                [((i + 1) % n_shards, i) for i in range(n_shards)],
            )
            ok_local = jnp.all(jnp.abs(v_loc[1:] - v_loc[:-1]) < e) & (
                jnp.abs(first_of_next - v_loc[-1]) < e
            )
            return lax.pmin(ok_local.astype(jnp.int32), axis_name) > 0

        def lam_of(v_loc):
            """λ = global v[0] (shard 0's first element, broadcast via psum
            of a masked scalar)."""
            return lax.psum(
                jnp.where(p == 0, v_loc[0], jnp.zeros((), dtype)), axis_name
            )

        def cond(c):
            ev, v, lam, i = c
            return (i < max_itr) & jnp.logical_not(stop_only(v))

        def body(c):
            ev, v, lam, i = c
            m = lax.pmax(jnp.max(v), axis_name)
            ev = ev * (v / m)
            lam = lam_of(v)
            return (ev, next_v(ev), lam, i + 1)

        init = (ev0, v0, jnp.asarray(0.0, dtype), jnp.asarray(0, jnp.int32))
        ev, v, lam_prev, i = lax.while_loop(cond, body, init)
        converged = i < max_itr
        m = lax.pmax(jnp.max(v), axis_name)
        ev = jnp.where(converged, ev * (v / m), ev)
        lam = jnp.where(converged, lam_of(v), lam_prev)
        return SolveResult(lam, ev, i, converged)

    return solve_block


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis_name", "eps", "max_itr", "storage_dtype", "eps_mode",
    ),
)
def _solve_sharded_ring_jit(
    A, mesh, axis_name, eps, max_itr, storage_dtype=None, ev0_scale=None,
    eps_mode="absolute",
):
    solve_block = _shard_matvec_ring_body(
        eps, max_itr, axis_name, storage_dtype, eps_mode
    )
    fn = shard_map(
        solve_block,
        mesh=mesh,
        in_specs=(P(axis_name, None), P()),
        out_specs=SolveResult(P(), P(axis_name), P(), P()),
        check_vma=False,  # λ/rounds/done are replicated by construction
    )
    if ev0_scale is None:
        ev0_scale = jnp.float32(1.0)
    return fn(A, jnp.asarray(ev0_scale, jnp.float32))


def solve_sharded_matvec_ring(
    A: jax.Array,
    mesh: Mesh,
    axis_name: str = "rows",
    config: SolverConfig = DEFAULT_CONFIG,
    ev0_scale: jax.Array | float = 1.0,
) -> SolveResult:
    """Row-partitioned matvec-form solve with ring-pipelined communication
    (no all_gather; ev chunks rotate via ppermute, overlapped with the
    chunk GEMVs).  Preferred over :func:`solve_sharded_matvec` when the
    per-round gather latency is visible — large meshes or DCN-spanning
    meshes where O(n) wire time rivals the O(n²/P) local pass.

    ``config.storage_dtype`` (bf16 fast mode) is honored: chunk GEMVs run
    as ``storage_matvec``, O(n) state stays f32.
    ``config.eps_mode`` is honored (relative mode costs one extra scalar
    pmax per round — see the body's ``stop_only``)."""
    _reject_sharded_unsupported(config, "solve_sharded_matvec_ring")
    A, n, n_shards = _validate_and_place(A, mesh, axis_name)
    return _solve_sharded_ring_jit(
        A,
        mesh,
        axis_name,
        config.eps,
        config.max_itr,
        config.storage_dtype,
        ev0_scale,
        config.eps_mode,
    )


@partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "batch_axis",
        "row_axis",
        "eps",
        "max_itr",
        "storage_dtype",
        "eps_mode",
    ),
)
def _solve_batched_rowsharded_jit(
    As, mesh, batch_axis, row_axis, eps, max_itr, storage_dtype=None,
    eps_mode="absolute",
):
    solve_block = _shard_matvec_body(
        eps, max_itr, row_axis, storage_dtype=storage_dtype, eps_mode=eps_mode
    )
    fn = shard_map(
        jax.vmap(solve_block, in_axes=(0, None)),
        mesh=mesh,
        in_specs=(P(batch_axis, row_axis, None), P()),
        out_specs=SolveResult(
            P(batch_axis), P(batch_axis, row_axis), P(batch_axis), P(batch_axis)
        ),
        check_vma=False,
    )
    return fn(As, jnp.float32(1.0))


def solve_batched_rowsharded(
    As: jax.Array,
    mesh: Mesh,
    batch_axis: str = "batch",
    row_axis: str = "rows",
    config: SolverConfig = DEFAULT_CONFIG,
) -> SolveResult:
    """2D-mesh batched solve: batch sharded over ``batch_axis`` (DP-like),
    each matrix's rows sharded over ``row_axis`` (TP-like).

    Composition of the two 1D strategies: per (batch-shard, row-shard) the
    body is the matvec-form row-sharded loop vmapped over the local batch;
    the only collective is the per-round all_gather of v along ``row_axis``.
    The vmapped while loop runs until every local batch element converges,
    freezing finished ones (per-matrix round counts preserved); done flags
    are replicated across row shards so the loop stays in lockstep.

    ``config.storage_dtype`` (bf16 fast mode) applies per matrix with the
    single-chip semantics (f32 accumulation, f32 O(n) state);
    ``config.eps_mode`` applies per matrix too (replicated-v stop).
    """
    _reject_sharded_unsupported(config, "solve_batched_rowsharded")
    B, n, n2 = As.shape
    if n != n2:
        raise ValueError(f"expected (B, n, n), got {As.shape}")
    pb, pr = require_axis(mesh, batch_axis), require_axis(mesh, row_axis)
    if B % pb != 0:
        raise ValueError(f"batch {B} not divisible by {pb} shards")
    if n % pr != 0:
        raise ValueError(f"dim {n} not divisible by {pr} shards")
    As = jax.device_put(As, NamedSharding(mesh, P(batch_axis, row_axis, None)))
    return _solve_batched_rowsharded_jit(
        As,
        mesh,
        batch_axis,
        row_axis,
        config.eps,
        config.max_itr,
        config.storage_dtype,
        config.eps_mode,
    )


def _shard2d_matvec_body(
    eps: float,
    max_itr: int,
    row_axis: str,
    col_axis: str,
    n_rows_shards: int,
    storage_dtype=None,
    eps_mode: str = "absolute",
):
    """Per-shard matvec-form loop for a 2D (rows × cols) block sharding.

    Shard (i, j) of a ``pr × pc`` mesh holds the n/pr × n/pc block
    ``A[i·n/pr:(i+1)·n/pr, j·n/pc:(j+1)·n/pc]`` — per-shard matrix memory
    is n²/(pr·pc), the quadratic scaling the 1D row sharding cannot reach
    (its shards keep full n-length rows).  This is the "column-sharded row
    sums need a psum" form SURVEY.md §5 anticipates; 1 × pc meshes give
    pure column sharding as a special case.

    Per round (matvec form — A is never written, see ops/solver_matvec.py):

      1. local block GEMV against the replicated eigenvector's column
         chunk: ``y_loc = A_blk @ ev[cols_j]``            (O(n²/(pr·pc)))
      2. ``psum`` of the pc partials along ``col_axis``   (O(n/pr) wire)
      3. ``v_loc = y_loc / ev[rows_i]``; ``all_gather`` the pr row chunks
         along ``row_axis`` → full v replicated           (O(n) wire)
      4. max / stop / λ / ev update computed redundantly from the
         replicated v (exactly the 1D body's policy).

    Float32 caveat: step 2 splits each row-sum reduction into pc partial
    sums — a different reduction grouping than the single-chip (and 1D
    row-sharded) dot over all n columns, so round counts are only
    guaranteed within the usual float32 slack, not bit-for-bit (tests pin
    Hilbert parity on the shipped mesh shapes).

    ``storage_dtype`` (bf16 fast mode): the local block is cast once,
    block GEMVs are ``storage_matvec``, all O(n) state stays float32 —
    single-device fast-mode semantics (solver_matvec.solve_matvec_storage).
    """

    def solve_block(A_blk: jax.Array, ev0_scale: jax.Array) -> SolveResult:
        n_r, n_c = A_blk.shape
        n = n_r * n_rows_shards
        Aq_blk = A_blk if storage_dtype is None else A_blk.astype(storage_dtype)
        dtype = A_blk.dtype if storage_dtype is None else jnp.float32
        i_row = lax.axis_index(row_axis)
        i_col = lax.axis_index(col_axis)
        row0 = i_row * n_r
        col0 = i_col * n_c

        def next_v(ev):
            ev_cols = lax.dynamic_slice(ev, (col0,), (n_c,))
            if storage_dtype is None:
                y = dot_f32(Aq_blk, ev_cols)
            else:
                y = storage_matvec(Aq_blk, ev_cols)
            y = lax.psum(y, col_axis)  # complete local row sums
            ev_rows = lax.dynamic_slice(ev, (row0,), (n_r,))
            v_loc = y / ev_rows
            return lax.all_gather(v_loc, row_axis, tiled=True)  # (n,)

        ev0 = jnp.ones((n,), dtype) * ev0_scale.astype(dtype)

        # v is replicated (psum + gather complete every round), so the
        # round is EXACTLY the single-chip matvec-form round — reuse its
        # one definition (incl. eps_mode) and slice the local ev after.
        cond, body = _make_cond_body(next_v, eps, max_itr, eps_mode)
        init = _init_carry(n, next_v, dtype, ev0)
        res = _finish(lax.while_loop(cond, body, init), max_itr)
        ev_loc = lax.dynamic_slice(res.eigenvector, (row0,), (n_r,))
        return res._replace(eigenvector=ev_loc)

    return solve_block


@partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "row_axis",
        "col_axis",
        "eps",
        "max_itr",
        "storage_dtype",
        "eps_mode",
    ),
)
def _solve_sharded_2d_jit(
    A, mesh, row_axis, col_axis, eps, max_itr, storage_dtype=None,
    ev0_scale=None, eps_mode="absolute",
):
    solve_block = _shard2d_matvec_body(
        eps,
        max_itr,
        row_axis,
        col_axis,
        mesh.shape[row_axis],
        storage_dtype,
        eps_mode,
    )
    fn = shard_map(
        solve_block,
        mesh=mesh,
        in_specs=(P(row_axis, col_axis), P()),
        out_specs=SolveResult(P(), P(row_axis), P(), P()),
        check_vma=False,  # λ/rounds/done are replicated by construction
    )
    if ev0_scale is None:
        ev0_scale = jnp.float32(1.0)
    return fn(A, jnp.asarray(ev0_scale, jnp.float32))


def solve_sharded_2d(
    A: jax.Array,
    mesh: Mesh,
    row_axis: str = "rows",
    col_axis: str = "cols",
    config: SolverConfig = DEFAULT_CONFIG,
    ev0_scale: jax.Array | float = 1.0,
) -> SolveResult:
    """2D block-sharded matvec-form solve over a ``rows × cols`` mesh.

    Shard (i, j) holds one n/pr × n/pc block of A — per-chip matrix memory
    scales as 1/(pr·pc), vs 1/pr for :func:`solve_sharded_matvec`'s full
    rows.  Use when n² no longer fits a 1D sharding's per-chip footprint
    (the "long-context" scaling axis of SURVEY.md §5); for meshes where the
    rows axis alone suffices, the 1D form does one collective per round
    instead of two and should be preferred.

    Per round: one O(n²/(pr·pc)) local block GEMV, one O(n/pr) ``psum``
    along ``col_axis``, one O(n) ``all_gather`` along ``row_axis``.  A 1×pc
    mesh degenerates to pure column sharding (row sums via psum only).

    ``config.storage_dtype`` (bf16 fast mode) is honored with single-chip
    semantics; A may arrive pre-cast (no f32 copy is ever made).
    ``config.eps_mode`` is honored (replicated-v stop, no extra
    collective).  ``ev0_scale`` threads bench-chain data dependence
    (scale-invariant).

    Round-count caveat: splitting each row sum into pc partials changes
    the float32 reduction grouping, so round counts are guaranteed only
    within the usual ±1 float32 slack of the single-chip path (Hilbert
    parity on the shipped mesh shapes is pinned by tests).
    """
    _reject_sharded_unsupported(config, "solve_sharded_2d")
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        # without this, a non-square A passes the divisibility checks and
        # dynamic_slice CLAMPS the out-of-range ev column offsets — a
        # silently wrong eigenvalue, not an error (review r5c)
        raise ValueError(f"must be a square matrix, got shape {A.shape}")
    n = A.shape[0]
    for ax in (row_axis, col_axis):
        if ax not in mesh.shape:
            raise ValueError(
                f"mesh has no '{ax}' axis (axes: {tuple(mesh.shape)}) — "
                "build it with make_mesh2d"
            )
    pr, pc = mesh.shape[row_axis], mesh.shape[col_axis]
    if n % pr != 0:
        raise ValueError(f"dim {n} not divisible by {pr} row shards")
    if n % pc != 0:
        raise ValueError(f"dim {n} not divisible by {pc} col shards")
    A = jax.device_put(A, NamedSharding(mesh, P(row_axis, col_axis)))
    return _solve_sharded_2d_jit(
        A,
        mesh,
        row_axis,
        col_axis,
        config.eps,
        config.max_itr,
        config.storage_dtype,
        ev0_scale,
        config.eps_mode,
    )


def _first_devices(want: int) -> list:
    """The first ``want`` devices of the default platform.  Raises rather
    than fall back to another platform or build a smaller mesh: either
    would make a scaling run measure the wrong thing."""
    devs = jax.devices()
    if len(devs) < want:
        raise ValueError(
            f"requested a {want}-device mesh but the default platform "
            f"({devs[0].platform}) has only {len(devs)} devices (on the CPU, "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={want} gives "
            "a virtual mesh)"
        )
    return devs[:want]


def make_mesh2d(
    pr: int,
    pc: int,
    row_axis: str = "rows",
    col_axis: str = "cols",
) -> Mesh:
    """pr × pc mesh over the first pr·pc devices of the default platform."""
    devs = _first_devices(pr * pc)
    return Mesh(np.array(devs).reshape(pr, pc), (row_axis, col_axis))


def make_row_mesh(n_devices: Optional[int] = None, axis_name: str = "rows") -> Mesh:
    """1D mesh over the first ``n_devices`` devices of the default platform
    (all of them when None)."""
    devs = jax.devices() if n_devices is None else _first_devices(n_devices)
    return Mesh(np.array(devs), (axis_name,))
