"""NumPy oracles pinning the reference's exact convergence semantics.

Two oracles, because the reference ships two implementations whose semantics
differ in three ways (dtype, stop neighborhood, round counting):

* :func:`sequential_oracle` — mirrors the reference's pure-Python solver
  (``main.py:13-47``): float64, stop compares adjacent pairs WITHOUT
  wraparound, returns ``itr + 1`` rounds.
* :func:`parallel_oracle` — mirrors the reference's parallel C++ semantics
  (``similarity_transform.cpp:5-75``): float32, stop compares
  ``|v[i] - v[(i+1) % n]| < eps`` WITH wraparound
  (``similarity_transform.cpp:385-417``), eigenvalue read out as ``v[0]``
  (``similarity_transform.cpp:60-65``), and the returned round count is the
  0-based index of the round in which convergence was detected
  (``similarity_transform.cpp:39-54``).

The JAX solver targets the *parallel* semantics (SURVEY.md §0); the
sequential oracle exists as the parallel-free cross-check the reference
itself uses.

The similarity update ``A ← D⁻¹ A D`` is computed elementwise
(``A[r][c] *= (1/v[r]) * v[c]``) exactly as the reference kernel does
(``similarity_transform.cpp:324-325``).  For the sequential oracle this is
bit-identical to the reference's explicit ``diag`` + two matmuls
(``main.py:13-16``): each matmul row/column contains a single nonzero term,
and adding exact zeros does not perturb float arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .config import EPS, MAX_ITR


class OracleResult(NamedTuple):
    eigenvalue: float
    eigenvector: np.ndarray
    rounds: int
    converged: bool


def sequential_oracle(mat: np.ndarray, eps: float = EPS) -> OracleResult:
    """Reference sequential semantics (``main.py:30-47``), float64.

    Stop: adjacent diffs only (no wraparound); rounds counted as ``itr + 1``;
    no iteration cap (the reference loops ``while True``) — we cap at a large
    bound to stay total.
    """
    A = np.asarray(mat, dtype=np.float64).copy()
    n = A.shape[0]
    ev = np.ones(n, dtype=np.float64)

    itr = 0
    for _ in range(1_000_000):
        v = A.sum(axis=1)
        m = v.max()
        ev = ev * (v / m)
        if np.all(np.abs(np.diff(v)) < eps):
            return OracleResult(float(v[0]), ev, itr + 1, True)
        A = A * ((1.0 / v)[:, None] * v[None, :])
        itr += 1
    raise RuntimeError("sequential oracle failed to converge")


def parallel_oracle(
    mat: np.ndarray,
    eps: float = EPS,
    max_itr: int = MAX_ITR,
    dtype=np.float32,
) -> OracleResult:
    """Reference parallel C++ semantics (``similarity_transform.cpp:5-75``).

    Per round i (0-based): row sums → max → eigenvector accumulation → stop
    check (wraparound) → break if converged else similarity update.  On
    convergence at round i the returned count is i and λ = v[0].  If the cap
    is hit, the count is ``max_itr`` and λ is the last checked v[0]
    (``converged=False``).
    """
    A = np.asarray(mat, dtype=dtype).copy()
    n = A.shape[0]
    ev = np.ones(n, dtype=dtype)
    v = np.zeros(n, dtype=dtype)

    for i in range(max_itr):
        v = A.sum(axis=1, dtype=dtype)
        m = v.max()
        ev = (ev * (v / m)).astype(dtype)
        if np.all(np.abs(v - np.roll(v, -1)) < eps):
            return OracleResult(float(v[0]), ev, i, True)
        A = (A * ((dtype(1.0) / v)[:, None] * v[None, :])).astype(dtype)
    return OracleResult(float(v[0]), ev, max_itr, False)
