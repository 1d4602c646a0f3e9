"""Pallas kernel for the solver's O(n²) pass, written for an NVIDIA GPU
through Pallas's Triton route.

The solver's only O(n²) work is one matrix-vector product per round
(ops/solver_matvec.py).  XLA's own dense product streams A at close to
the card's copy bandwidth, and a hand-written dense kernel did not beat
it, so the default path runs no kernel.  What XLA cannot do is exploit a
property of the input that its dense ``dot`` does not see:
:func:`symv` computes ``A @ x`` for a matrix DECLARED symmetric from the
tiles on or above the diagonal only, ≈ (g+1)/(2g) of A per product for
g tile rows.  The solve is bound by memory bandwidth, so bytes read is
its cost.

The kernel computes in float32 whatever the storage dtype of A (bf16
values are exact in f32), with elementwise multiply-adds and block
reductions, never ``pl.dot``, which would run in TF32 on the tensor
cores.  It uses no atomics, so a result never depends on the order in
which blocks ran.

``interpret=True`` runs a kernel through Pallas's interpreter on any
backend (the CPU test suite); otherwise it compiles for the GPU, and any
other platform is an error (``device.require_gpu``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: Square tile edge of :func:`symv` (a power of two) and its warps per
#: block.  A 64×64 f32 tile is 16 KiB: 2,080 blocks at 8192², and 32
#: registers of tile per thread at 4 warps.  Of 32/2, 64/4 and 128/8 on
#: an H100, 64/4 was fastest at 8192² and 65536².
SYM_TILE = 64
_PARAMS = plgpu.CompilerParams(num_warps=4, num_stages=3)


def sym_tiles(n: int, t: int = SYM_TILE) -> tuple[np.ndarray, np.ndarray]:
    """Row and column tile indices of the g(g+1)/2 tiles on or above the
    diagonal of an n×n matrix cut into t×t tiles, row-major."""
    g = -(-n // t)
    i, j = np.triu_indices(g)
    return i.astype(np.int32), j.astype(np.int32)


def _symv_tile_kernel(ti_ref, tj_ref, a_ref, x_ref, p_ref, *, n: int, t: int):
    """One upper tile (i, j): A_ij·x_j goes to row block i and A_ijᵀ·x_i
    to row block j, each into its own slot of the partial buffer
    ``p[row block, other block, :]``.  A diagonal tile loads only its
    upper triangle (masked, so the lower one is never read) and adds the
    strict part's transpose into the same slot."""
    k = pl.program_id(0)
    bi = plgpu.load(ti_ref.at[k])
    bj = plgpu.load(tj_ref.at[k])
    r = bi * t + jnp.arange(t)
    c = bj * t + jnp.arange(t)
    r_ok, c_ok = r < n, c < n
    mask = r_ok[:, None] & c_ok[None, :] & (r[:, None] <= c[None, :])
    a = plgpu.load(
        a_ref.at[pl.ds(bi * t, t), pl.ds(bj * t, t)], mask=mask, other=0.0
    ).astype(jnp.float32)
    xi = plgpu.load(x_ref.at[pl.ds(bi * t, t)], mask=r_ok, other=0.0)
    xj = plgpu.load(x_ref.at[pl.ds(bj * t, t)], mask=c_ok, other=0.0)
    direct = jnp.sum(a * xj[None, :], axis=1)
    strict = jnp.where(r[:, None] < c[None, :], a, 0.0)
    trans = jnp.sum(strict * xi[:, None], axis=0)
    diag = bi == bj

    @pl.when(diag)
    def _():
        plgpu.store(p_ref.at[bi, bi, :], direct + trans)

    @pl.when(jnp.logical_not(diag))
    def _():
        plgpu.store(p_ref.at[bi, bj, :], direct)
        plgpu.store(p_ref.at[bj, bi, :], trans)


def _symv_sum_kernel(p_ref, y_ref, *, n: int, t: int, g: int):
    """Row block b: the g partials summed in a fixed order."""
    b = pl.program_id(0)

    def body(k, acc):
        return acc + plgpu.load(p_ref.at[b, k, :])

    y = jax.lax.fori_loop(0, g, body, jnp.zeros((t,), jnp.float32))
    rows = b * t + jnp.arange(t)
    plgpu.store(y_ref.at[pl.ds(b * t, t)], y, mask=rows < n)


@functools.partial(jax.jit, static_argnames=("interpret",))
def symv(A: jax.Array, x: jax.Array, interpret: bool = False) -> jax.Array:
    """``A @ x`` for a symmetric ``A``, reading only its upper triangle.

    Pass 1 runs one program per upper tile and writes every product into
    its own slot of a g×g×t partial buffer (no atomics); pass 2 sums each
    row block's g slots in a fixed order.  The result is therefore the
    same on every run, and differs from a dense product only in the
    order of the f32 sums.  Any n works: edge tiles are masked.
    """
    n = A.shape[0]
    t = SYM_TILE
    g = -(-n // t)
    ti, tj = sym_tiles(n, t)
    x = x.astype(jnp.float32)
    parts = pl.pallas_call(
        functools.partial(_symv_tile_kernel, n=n, t=t),
        out_shape=jax.ShapeDtypeStruct((g, g, t), jnp.float32),
        grid=(ti.size,),
        compiler_params=_PARAMS,
        interpret=interpret,
        name="ev_symv_tiles",
    )(jnp.asarray(ti), jnp.asarray(tj), A, x)
    return pl.pallas_call(
        functools.partial(_symv_sum_kernel, n=n, t=t, g=g),
        out_shape=jax.ShapeDtypeStruct((n,), jnp.float32),
        grid=(g,),
        compiler_params=_PARAMS,
        interpret=interpret,
        name="ev_symv_sum",
    )(parts)
