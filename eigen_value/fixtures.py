"""Jittable test/bench fixture generators.

Equivalents of the reference's fixture library (``utils.cpp``): the
reference fills these with SYCL device kernels; here each is a tiny jitted
expression built from ``broadcasted_iota``, so a matrix is generated on the
device and never built on the host.

Reference provenance per fixture:
  * Hilbert matrix ``A[r][c] = 1/(r+c+1)`` — ``utils.cpp:137-154``
    (the benchmark workload, BASELINE.md).
  * identity matrix — ``utils.cpp:5-27``.
  * ramp vector ``1..n`` — ``utils.cpp:37-59`` (find-max fixture).
  * stop-success vector (constant ``1 + 1e-4``) — ``utils.cpp:74-98``.
  * stop-fail vector (``(i+1) * 1e-4``: adjacent diffs tiny but the
    wraparound pair |last − first| is huge) — ``utils.cpp:100-122``; this
    pair specifically exercises the wraparound comparison.
  * random positive matrix, U(0,1) — ``utils.cpp:124-134`` /
    ``wrapper/python/test.py:10-11``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnums=(0, 1))
def hilbert_matrix(n: int, dtype=jnp.float32) -> jax.Array:
    """Hilbert matrix ``A[r][c] = 1/(r+c+1)`` (utils.cpp:137-154).

    Matches the reference's float arithmetic: the divisor is formed in
    integer space then converted, and the reciprocal is taken in ``dtype``.
    """
    r = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    return jnp.asarray(1.0, dtype) / (r + c + 1).astype(dtype)


@partial(jax.jit, static_argnums=(0, 1))
def identity_matrix(n: int, dtype=jnp.float32) -> jax.Array:
    """Identity matrix (utils.cpp:5-27) — row-sum fixture: every row sums to 1."""
    return jnp.eye(n, dtype=dtype)


@partial(jax.jit, static_argnums=(0, 1))
def ramp_vector(n: int, dtype=jnp.float32) -> jax.Array:
    """Vector ``(1, 2, ..., n)`` (utils.cpp:37-59) — max fixture: max == n."""
    i = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    return (i + 1).astype(dtype)


@partial(jax.jit, static_argnums=(0, 1))
def stop_success_vector(n: int, dtype=jnp.float32) -> jax.Array:
    """Constant ``1 + 1e-4`` vector (utils.cpp:74-98): stop check must pass."""
    return jnp.full((n,), 1.0 + 1e-4, dtype=dtype)


@partial(jax.jit, static_argnums=(0, 1))
def stop_fail_vector(n: int, dtype=jnp.float32) -> jax.Array:
    """Ramp ``(i+1) * 1e-4`` (utils.cpp:100-122): adjacent diffs are 1e-4 < EPS
    but the wraparound pair ``|v[n-1] - v[0]|`` is huge ⇒ stop must fail."""
    i = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    return (i + 1).astype(dtype) * jnp.asarray(1e-4, dtype)


def random_positive_matrix(key: jax.Array, n: int, dtype=jnp.float32) -> jax.Array:
    """Random positive matrix with entries U(eps, 1) — the wrapper-test workload
    (wrapper/python/test.py:10-11). Entries are bounded away from 0 so the
    positivity requirement (SURVEY.md §0) holds robustly in float32."""
    return jax.random.uniform(key, (n, n), dtype=dtype, minval=1e-4, maxval=1.0)


#: The 3×3 cross-implementation anchor (tests/test.cpp:79-104, main.py:52-58).
#: Kept as a NumPy array so importing the package never initializes JAX
#: backends (device init locks in XLA_FLAGS before CLIs can set them).
ANCHOR_3X3 = np.array([[1.0, 1.0, 2.0], [2.0, 1.0, 3.0], [2.0, 3.0, 5.0]])
ANCHOR_3X3_EIGENVALUE = 7.531129
ANCHOR_3X3_EIGENVECTOR = (0.394074, 0.578844, 0.997451)

#: Hardware-independent round counts for Hilbert matrices (README.md:70-76 and
#: all five other machines) — the primary parity target (BASELINE.md).
HILBERT_ROUNDS = {128: 9, 256: 10, 512: 12, 1024: 13, 2048: 14, 4096: 15, 8192: 17}
