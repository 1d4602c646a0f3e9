"""Checkpoint / resume of an in-flight solve.

The reference has no checkpointing (solves run in ms–s; SURVEY.md §5), but
its iteration state is tiny and well-defined.  Here the production
(matvec-form, ops/solver_matvec.py) solver state is a first-class pytree —
``(A₀, ev, v, λ, rounds, done)`` — that can be stepped a bounded number of
rounds at a time, snapshotted to disk between steps, and resumed
bit-exactly: chunked stepping replays the identical op sequence as the
one-shot ``lax.while_loop``, so a solve split across process restarts
returns the same eigenvalue, eigenvector, and round count.

Intended for very large solves (the matvec form solves 65536² matrices
where a single step is minutes of work on preemptible capacity) and for
the driver pattern: ``step → save → (maybe die) → load → step``.

The state composes with sharding: pass a row-sharded ``A``
(``NamedSharding(mesh, P("rows", None))``) and ``init_state``/``step``
run partitioned under GSPMD with results bit-identical to the
single-device path (tested) — checkpointed solves scale to multi-chip
unchanged.

Formats: ``.npz`` (single-host, no extra deps) and Orbax (sharded
multi-host state, optional).
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .config import EPS, MAX_ITR
from .ops.solver import SolveResult, stop_check
from .ops.solver_matvec import dot_f32, storage_matvec


class SolverState(NamedTuple):
    """Resumable state of a matvec-form solve.

    ``A`` is the ORIGINAL matrix (the matvec form never mutates it —
    solver_matvec.py); ``v`` is the row-sum vector of the CURRENT iterate;
    ``rounds`` follows the reference's 0-based parallel counting
    (similarity_transform.cpp:39-54).
    """

    A: jax.Array
    ev: jax.Array
    v: jax.Array
    lam: jax.Array
    rounds: jax.Array
    done: jax.Array


def _state_dtype(A: jax.Array):
    """O(n) state dtype for a matrix of A's storage dtype: reduced-precision
    storage keeps float32 state, exactly like solve_matvec_storage
    (solver_matvec.py:145-174) — bf16 cannot even represent the 1e-3 stop
    tolerance at λ-scale values."""
    return jnp.float32 if A.dtype.itemsize < 4 else A.dtype


def _state_matvec(A: jax.Array, ev: jax.Array) -> jax.Array:
    """One solver round's v = (A@ev)/ev: :func:`storage_matvec` for
    reduced-precision A, ``dot_f32`` otherwise — the products of
    solve_matvec_storage and solve_matvec, so chunked stepping stays
    bit-identical to the one-shot solvers."""
    if A.dtype.itemsize < 4:
        return storage_matvec(A, ev) / ev
    return dot_f32(A, ev) / ev


def _init_state_impl(A: jax.Array) -> SolverState:
    n = A.shape[0]
    dtype = _state_dtype(A)
    ev0 = jnp.ones((n,), dtype)
    v0 = _state_matvec(A, ev0)
    return SolverState(
        A,
        ev0,
        v0,
        jnp.asarray(0.0, dtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
    )


_init_donated = jax.jit(_init_state_impl, donate_argnums=(0,))
_init_copying = jax.jit(_init_state_impl)


def init_state(A: jax.Array, donate: bool = False) -> SolverState:
    """Start a solve: ev = 1, v = row sums of A (initialise_eigen_vector +
    first sum_across_rows of the reference loop).

    ``donate=True`` hands A's buffer to ``state.A`` (it passes through
    unchanged, so the aliasing is exact) — initialization then never holds
    two copies of A, which matters at the 65536²-bf16 scale this module
    exists for (ADVICE r1: the undonated form transiently held 2×A).
    Donation INVALIDATES the caller's array — use ``state.A`` afterwards —
    so it is opt-in, not the default; the default keeps the caller's
    input alive at the cost of the transient copy."""
    return (_init_donated if donate else _init_copying)(A)


@partial(jax.jit, static_argnames=("eps", "max_itr"), donate_argnums=(0,))
def step(
    state: SolverState,
    num_rounds: jax.Array,
    eps: float = EPS,
    max_itr: int = MAX_ITR,
) -> SolverState:
    """Advance the solve by at most ``num_rounds`` rounds (on device, one
    executable).  A no-op once ``done`` or the global ``max_itr`` cap is
    reached.  Stepping in chunks of k then k' is bit-identical to one
    chunk of k+k': the body is the exact solver_matvec.py round.

    The input ``state`` is DONATED (its buffers are reused for the output
    so stepping never holds two copies of A) — use the returned state.
    """
    A = state.A

    def matvec(ev):
        return _state_matvec(A, ev)

    def cond(c):
        st, j = c
        return (
            jnp.logical_not(st.done)
            & (st.rounds < max_itr)
            & (j < num_rounds)
        )

    def body(c):
        st, j = c
        v = st.v
        m = jnp.max(v)
        ev = st.ev * (v / m)
        done = stop_check(v, eps)
        lam = v[0]
        v = lax.cond(done, lambda e: st.v, matvec, ev)
        i = jnp.where(done, st.rounds, st.rounds + 1)
        return SolverState(st.A, ev, v, lam, i, done), j + 1

    out, _ = lax.while_loop(cond, body, (state, jnp.asarray(0, jnp.int32)))
    return out


def to_result(state: SolverState) -> SolveResult:
    """Project the state onto the public result pytree."""
    return SolveResult(state.lam, state.ev, state.rounds, state.done)


def solve_checkpointed(
    A: jax.Array,
    chunk_rounds: int = 8,
    checkpoint_path: Optional[str] = None,
    eps: float = EPS,
    max_itr: int = MAX_ITR,
    donate: bool = False,
) -> SolveResult:
    """Run a full solve in ``chunk_rounds``-round steps, optionally saving
    an ``.npz`` snapshot after every chunk (the preemption-tolerant driver
    loop).  Resumes automatically if ``checkpoint_path`` already exists —
    after verifying the snapshot was taken for THIS matrix (shape, dtype,
    and a FULL-content device-side digest — one O(n²) read per side, once
    per resume; :func:`_matrix_digest`) AND under this
    ``eps``; a stale snapshot from a different solve, or one whose stop
    tolerance differs (mixing tolerances across chunks would corrupt the
    round count), raises instead of silently returning the wrong result.

    ``donate=True`` hands the matrix buffer to the solver state on a fresh
    start (see :func:`init_state`) — one resident copy of A for very large
    solves, at the price of invalidating the caller's array.  The default
    keeps the caller's A alive (this convenience driver is also used at
    small dims where the copy is free)."""
    if chunk_rounds < 1:
        # a 0-round step would be a no-op and spin this driver loop forever
        raise ValueError(f"chunk_rounds must be >= 1, got {chunk_rounds}")
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state, saved_eps = load_state(checkpoint_path, with_eps=True)
        _check_same_matrix(state.A, A, checkpoint_path)
        if saved_eps is not None and saved_eps != eps:
            raise ValueError(
                f"checkpoint {checkpoint_path!r} was written by a solve with "
                f"eps={saved_eps!r} but this resume uses eps={eps!r} — "
                "mixing stop tolerances across chunks corrupts the round "
                "count; pass the original eps or a fresh checkpoint_path"
            )
    else:
        state = init_state(A, donate=donate)
    while not bool(state.done) and int(state.rounds) < max_itr:
        state = jax.block_until_ready(step(state, chunk_rounds, eps, max_itr))
        if checkpoint_path is not None:
            save_state(checkpoint_path, state, eps=eps)
    return to_result(state)


@jax.jit
def _matrix_digest(A: jax.Array) -> jax.Array:
    """Bit-level content digest of a matrix, computed ON DEVICE in one
    O(n²) read (≈ one matvec's worth of HBM traffic — cheap even at
    65536²).  Position-mixed so permuted/moved entries change the digest;
    wraparound uint32 arithmetic (well-defined in XLA)."""
    if A.dtype.itemsize == 8:  # f64 → two lossless uint32 lanes per entry
        bits = lax.bitcast_convert_type(A, jnp.uint32).reshape(A.shape[0], -1)
    elif A.dtype.itemsize == 2:  # bf16/f16
        bits = lax.bitcast_convert_type(A, jnp.uint16).astype(jnp.uint32)
    else:
        bits = lax.bitcast_convert_type(A, jnp.uint32)
    idx = (
        jax.lax.broadcasted_iota(jnp.uint32, bits.shape, 0)
        * jnp.uint32(bits.shape[-1])
        + jax.lax.broadcasted_iota(jnp.uint32, bits.shape, 1)
    )
    mixed = (bits ^ (idx * jnp.uint32(2654435761))) * jnp.uint32(2246822519)
    return jnp.sum(mixed, dtype=jnp.uint32)


def _check_same_matrix(saved: jax.Array, given, path: str) -> None:
    """Identity check between a snapshot's matrix and the caller's: shape,
    dtype, and a FULL-content device-side digest (VERDICT r1 item 9: a row
    sample misses interior-only differences) — one O(n²) device pass per
    side, once per resume."""
    given = jnp.asarray(given)
    if saved.shape != given.shape or saved.dtype != given.dtype:
        raise ValueError(
            f"checkpoint {path!r} holds a {saved.dtype} {saved.shape} matrix "
            f"but the solve was called with {given.dtype} {given.shape}"
        )
    if int(_matrix_digest(saved)) != int(_matrix_digest(given)):
        raise ValueError(
            f"checkpoint {path!r} was created for a different matrix "
            "(content digest differs) — pass a fresh checkpoint_path"
        )


# ---------------------------------------------------------------- storage

_FIELDS = SolverState._fields


def save_state(path: str, state: SolverState, eps: Optional[float] = None) -> None:
    """Snapshot to a single ``.npz`` (atomic rename; single-host sizes).

    ``eps`` (when given) records the stop tolerance the snapshot was taken
    under, so a resume with a different tolerance is rejected instead of
    silently mixing stop criteria across chunks (ADVICE r1)."""
    arrs = {k: np.asarray(v) for k, v in zip(_FIELDS, state)}
    if eps is not None:
        arrs["_eps"] = np.asarray(float(eps), np.float64)
    tmp = f"{path}.tmp.{os.getpid()}.npz"  # np.savez appends .npz otherwise
    np.savez(tmp, **arrs)
    os.replace(tmp, path)


def load_state(path: str, with_eps: bool = False):
    """Load an ``.npz`` snapshot saved by :func:`save_state`.

    ``with_eps=True`` also returns the recorded stop tolerance (or None
    for snapshots written before it was recorded)."""
    with np.load(path) as z:
        state = SolverState(*(jnp.asarray(z[k]) for k in _FIELDS))
        if with_eps:
            eps = float(z["_eps"][()]) if "_eps" in z.files else None
            return state, eps
    return state


def save_state_orbax(path: str, state: SolverState) -> None:
    """Snapshot via Orbax (handles sharded/multi-host state; optional dep)."""
    import orbax.checkpoint as ocp

    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(path), dict(state._asdict()), force=True)


def load_state_orbax(path: str, template: SolverState) -> SolverState:
    """Restore an Orbax snapshot; ``template`` supplies shapes/shardings
    (e.g. ``jax.eval_shape``-style abstract state or a freshly built one)."""
    import orbax.checkpoint as ocp

    with ocp.StandardCheckpointer() as ckptr:
        restored = ckptr.restore(
            os.path.abspath(path), target=dict(template._asdict())
        )
    return SolverState(**restored)
