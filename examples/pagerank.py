"""PageRank as a matrix-free eigenvalue solve: sparse + rank-one operators.

The Google matrix ``G = α·P + (1−α)/n·11ᵀ`` (P column-stochastic link
matrix, α the damping factor) is a POSITIVE matrix whose maximum
eigenvalue is exactly 1 and whose right Perron eigenvector is the
PageRank score vector — precisely the problem class the
similarity-transform method solves.  G is dense (the teleportation term
touches every entry) but never needs materializing: it is the SUM of two
structured operators,

    G·x = ell_matvec(αP)·x  +  low_rank_matvec(teleportation)·x,

composed with `add_matvec` — O(edges + n) per round instead of O(n²).
The reference's dense-buffer design (similarity_transform.hpp:8-9) caps
this workload at HBM-sized graphs; the operator API has no such cap.

Run: python examples/pagerank.py [--nodes 2000 --out-degree 5]
"""

import os as _os, sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np

import jax
import jax.numpy as jnp

from eigen_value import max_eigenvalue, max_eigenvalue_operator
from eigen_value.ops.structured import (
    add_matvec,
    ell_from_coo,
    ell_matvec,
    low_rank_matvec,
)


def random_link_graph(n: int, out_degree: int, seed: int = 3):
    """COO triplets of a random directed graph: every node links to
    ``out_degree`` distinct others (no dangling nodes by construction)."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), out_degree)
    dst = np.concatenate(
        [rng.choice(n - 1, size=out_degree, replace=False) for _ in range(n)]
    )
    dst = np.where(dst >= src, dst + 1, dst)  # no self-links, stays in [0, n)
    return src, dst


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--out-degree", type=int, default=5)
    ap.add_argument("--damping", type=float, default=0.85)
    args = ap.parse_args()
    n, d, alpha = args.nodes, args.out_degree, args.damping

    src, dst = random_link_graph(n, d)
    # column-stochastic P: P[dst, src] = 1/outdeg(src); here outdeg ≡ d
    cols, vals = ell_from_coo(dst, src, np.full(len(src), alpha / d), n)
    link = ell_matvec(cols, vals)  # α·P — O(edges) per matvec
    ones = jnp.ones((n, 1), jnp.float32)
    teleport = low_rank_matvec(ones * ((1 - alpha) / n), ones)  # (1−α)/n·11ᵀ
    google = add_matvec(link, teleport)

    res = jax.block_until_ready(
        jax.jit(lambda: max_eigenvalue_operator(google, n))()
    )
    scores = np.asarray(res.eigenvector, np.float64)
    scores /= scores.sum()

    # G is column-stochastic ⇒ λ_max = 1 exactly — a free correctness oracle
    lam = float(res.eigenvalue)
    print(f"operator solve (n={n}, {n * d} edges): λ = {lam:.6f}, "
          f"rounds = {int(res.rounds)}  (exact answer: λ = 1)")
    assert abs(lam - 1.0) < 2e-3

    # cross-check the scores against the dense solver on materialized G
    G = np.full((n, n), (1 - alpha) / n, np.float32)
    np.add.at(G, (dst, src), alpha / d)
    dense = max_eigenvalue(jnp.asarray(G))
    ref = np.asarray(dense.eigenvector, np.float64)
    ref /= ref.sum()
    err = float(np.max(np.abs(scores - ref)) / ref.max())
    print(f"dense cross-check: λ = {float(dense.eigenvalue):.6f}, "
          f"max score deviation = {err:.2e}")
    assert err < 1e-2

    top = np.argsort(scores)[::-1][:5]
    print("top-5 nodes:", ", ".join(f"#{i} ({scores[i]:.5f})" for i in top))


if __name__ == "__main__":
    main()
