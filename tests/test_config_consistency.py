"""The honored-or-rejected config contract (VERDICT r3 item 3).

Every SolverConfig knob must be honored or rejected with a ValueError on
EVERY public entry point — never silently dropped (a silently dropped
knob is how the round-2 Kronecker cap-exhaustion hid: the caller thought
a setting was in effect and nobody read the artifact that proved it
wasn't).  The reference has one global constants header
(include/similarity_transform.hpp:4-5) so its two knobs can't diverge
per path; this matrix is the generalization to a config system.

The matrix below lists, per entry point, which non-default knob settings
must raise.  Companion semantic tests assert the HONORED side for the
knobs round 4 newly threaded (eps_mode through batched and sharded).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eigen_value import (
    SolverConfig,
    fixtures,
    max_eigenvalue,
    max_eigenvalue_batch,
    max_eigenvalue_operator,
)
from eigen_value.parallel.sharded import make_mesh2d, make_row_mesh

N = 128  # aligned dim so auto resolves the same everywhere


def entry_single(cfg):
    return max_eigenvalue(fixtures.hilbert_matrix(N), cfg)


def entry_mesh1d(cfg):
    return max_eigenvalue(fixtures.hilbert_matrix(N), cfg, mesh=make_row_mesh(4))


def entry_mesh2d(cfg):
    return max_eigenvalue(
        fixtures.hilbert_matrix(N), cfg, mesh=make_mesh2d(2, 2)
    )


def entry_batch(cfg):
    As = jnp.stack([fixtures.hilbert_matrix(N)] * 2)
    return max_eigenvalue_batch(As, cfg)


def entry_batch_mesh(cfg):
    import jax
    from jax.sharding import Mesh

    As = jnp.stack([fixtures.hilbert_matrix(N)] * 4)
    mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("batch",))
    return max_eigenvalue_batch(As, cfg, mesh=mesh)


def entry_batch_mesh2d(cfg):
    As = jnp.stack([fixtures.hilbert_matrix(N)] * 2)
    return max_eigenvalue_batch(
        As, cfg, mesh=make_mesh2d(2, 2, "batch", "rows")
    )


def entry_operator(cfg):
    H = fixtures.hilbert_matrix(N)
    return max_eigenvalue_operator(lambda x: H @ x, N, cfg)


ENTRIES = {
    "single": entry_single,
    "mesh1d": entry_mesh1d,
    "mesh2d": entry_mesh2d,
    "batch": entry_batch,
    "batch_mesh": entry_batch_mesh,
    "batch_mesh2d": entry_batch_mesh2d,
    "operator": entry_operator,
}

# (knob-setting, {entry: "ok" | "raise"}).  "ok" means the call must
# succeed AND converge with a sane λ — the honored semantics themselves
# are pinned by the targeted tests below and in test_solver/test_parallel.
MATRIX = [
    (dict(eps_mode="relative"),
     dict(single="ok", mesh1d="ok", mesh2d="ok", batch="ok", operator="ok")),
    (dict(storage_dtype=jnp.bfloat16),
     dict(single="ok", mesh1d="ok", mesh2d="ok", batch="ok", operator="raise")),
    (dict(storage_dtype=jnp.float16),
     dict(single="ok", mesh1d="ok", mesh2d="ok", batch="ok", operator="raise")),
    (dict(max_itr=3),
     dict(single="capped", mesh1d="capped", mesh2d="capped", batch="capped",
          operator="capped")),
    (dict(eps=1e-2),
     dict(single="ok", mesh1d="ok", mesh2d="ok", batch="ok", operator="ok")),
    (dict(backend="xla"),
     dict(single="ok", mesh1d="ok", mesh2d="raise", batch="raise",
          operator="raise")),
    (dict(backend="matvec"),
     dict(single="ok", mesh1d="ok", mesh2d="ok", batch="ok", operator="ok")),
    (dict(backend="multiround"),
     dict(single="ok", mesh1d="raise", mesh2d="raise", batch="raise",
          operator="raise")),
    (dict(backend="multiround", chunk=5),
     dict(single="ok", mesh1d="raise", mesh2d="raise", batch="raise",
          operator="raise")),
    (dict(backend="multiround", storage_dtype=jnp.bfloat16),
     dict(single="ok", mesh1d="raise", mesh2d="raise", batch="raise",
          operator="raise")),
    (dict(backend="multiround", eps_mode="relative"),
     dict(single="ok", mesh1d="raise", mesh2d="raise", batch="raise",
          operator="raise")),
    # chunk without the multiround backend would be silently dropped on
    # every path (auto resolves to matvec).
    (dict(chunk=5),
     dict(single="raise", mesh1d="raise", mesh2d="raise", batch="raise",
          operator="raise")),
    # interpret applies to the symmetric kernel only: alone, or with a
    # backend that runs no kernel, it would be silently dropped.
    (dict(interpret=True),
     dict(single="raise", mesh1d="raise", mesh2d="raise", batch="raise",
          operator="raise")),
    (dict(interpret=True, backend="xla"),
     dict(single="raise", mesh1d="raise", mesh2d="raise", batch="raise",
          operator="raise")),
    (dict(storage_dtype=jnp.bfloat16, backend="xla"),
     dict(single="raise", mesh1d="raise", mesh2d="raise", batch="raise",
          operator="raise")),
    # symmetric is a property DECLARATION: "auto" consumes it (the dense
    # product keeps the job on the CPU — identical results, config.py),
    # explicit matvec/multiround honor it with the upper-triangle kernel
    # (which on the CPU needs interpret=True, else it raises), "xla" and
    # the sharded/batch/operator entries have no symmetric form.
    (dict(symmetric=True),
     dict(single="ok", mesh1d="raise", mesh2d="raise", batch="raise",
          operator="raise")),
    (dict(symmetric=True, interpret=True),
     dict(single="ok", mesh1d="raise", mesh2d="raise", batch="raise",
          operator="raise")),
    (dict(symmetric=True, backend="multiround", interpret=True),
     dict(single="ok", mesh1d="raise", mesh2d="raise", batch="raise",
          operator="raise")),
    (dict(symmetric=True, backend="matvec", interpret=True),
     dict(single="ok", mesh1d="raise", mesh2d="raise", batch="raise",
          operator="raise")),
    (dict(symmetric=True, backend="matvec"),
     dict(single="raise", mesh1d="raise", mesh2d="raise", batch="raise",
          operator="raise")),
    (dict(symmetric=True, backend="xla"),
     dict(single="raise", mesh1d="raise", mesh2d="raise", batch="raise",
          operator="raise")),
]


@pytest.mark.parametrize(
    "knobs,expectations",
    MATRIX,
    ids=[",".join(f"{k}={v}" for k, v in m[0].items()) for m in MATRIX],
)
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_knob_honored_or_rejected(entry, knobs, expectations):
    cfg = SolverConfig(**knobs)
    # the mesh-batched entries share the plain batch contract (same
    # vmapped matvec-form body, same rejections)
    expect = expectations[entry if entry in expectations else "batch"]
    if expect == "raise":
        with pytest.raises(ValueError):
            ENTRIES[entry](cfg)
        return
    res = ENTRIES[entry](cfg)
    rounds = np.asarray(res.rounds)
    if expect == "capped":
        # max_itr honored: every path stops at the cap, unconverged
        assert (rounds == cfg.max_itr).all(), (entry, knobs, rounds)
        assert not bool(np.asarray(res.converged).any()), (entry, knobs)
        return
    assert bool(np.asarray(res.converged).all()), (entry, knobs)
    # the Hilbert family's λ at N=128 is 2.21719; every honored path must
    # land there (storage modes within their documented tolerance)
    lam = np.asarray(res.eigenvalue, np.float32).reshape(-1)
    assert np.allclose(lam, 2.21719, atol=1e-2), (entry, knobs, lam)
    assert (rounds <= fixtures.HILBERT_ROUNDS[N] + 1).all(), (entry, knobs)


class TestNewlyThreadedSemantics:
    """The honored side of round 4's threading: eps_mode must actually
    change behavior on the paths that used to drop or reject it."""

    def test_batched_relative_stop_converges_large_lambda(self, rng):
        """A large-λ batch (λ ≈ 1e6·n/2): absolute mode cap-exhausts
        every matrix (the kron-class failure), relative converges —
        proof the knob now reaches the vmapped body."""
        As = jnp.asarray(
            rng.random((2, N, N), dtype=np.float32) + 0.1
        ) * jnp.float32(1e6)
        res_abs = max_eigenvalue_batch(As, SolverConfig(max_itr=50))
        assert not bool(np.asarray(res_abs.converged).any())
        res_rel = max_eigenvalue_batch(
            As, SolverConfig(max_itr=200, eps_mode="relative")
        )
        assert bool(np.asarray(res_rel.converged).all())
        # per-matrix λ matches the single-matrix relative solve
        for b in range(2):
            ref = max_eigenvalue(
                As[b], SolverConfig(max_itr=200, eps_mode="relative")
            )
            assert float(res_rel.eigenvalue[b]) == pytest.approx(
                float(ref.eigenvalue), rel=1e-5
            )
            assert int(res_rel.rounds[b]) == int(ref.rounds)

    @pytest.mark.parametrize("variant", ["matvec", "ring", "2d", "iterated"])
    def test_sharded_relative_stop_matches_single_chip(self, rng, variant):
        """Every sharded body honors eps_mode='relative' with single-chip
        semantics: same rounds, same λ (the ring body computes the
        relative tolerance via an extra pmax — the others read it off
        the replicated v)."""
        from eigen_value.ops.solver_matvec import solve_matvec
        from eigen_value.parallel.sharded import (
            solve_sharded,
            solve_sharded_2d,
            solve_sharded_matvec,
            solve_sharded_matvec_ring,
        )

        A = jnp.asarray(
            rng.random((N, N), dtype=np.float32) + 0.1
        ) * jnp.float32(1e6)
        cfg = SolverConfig(max_itr=200, eps_mode="relative")
        ref = solve_matvec(A, cfg.eps, 200, eps_mode="relative")
        assert bool(ref.converged)
        if variant == "matvec":
            got = solve_sharded_matvec(A, make_row_mesh(4), config=cfg)
        elif variant == "ring":
            got = solve_sharded_matvec_ring(A, make_row_mesh(4), config=cfg)
        elif variant == "2d":
            got = solve_sharded_2d(A, make_mesh2d(2, 2), config=cfg)
        else:
            got = solve_sharded(A, make_row_mesh(4), config=cfg)
        assert bool(got.converged), variant
        # the iterated/ring/2d bodies reduce in different f32 orders than
        # the single-chip dot — rounds within ±1, λ to solver tolerance
        assert abs(int(got.rounds) - int(ref.rounds)) <= 1, variant
        assert float(got.eigenvalue) == pytest.approx(
            float(ref.eigenvalue), rel=1e-4
        ), variant

    def test_batched_rowsharded_relative(self, rng):
        from eigen_value.parallel.sharded import solve_batched_rowsharded

        As = jnp.asarray(
            rng.random((2, N, N), dtype=np.float32) + 0.1
        ) * jnp.float32(1e6)
        cfg = SolverConfig(max_itr=200, eps_mode="relative")
        got = solve_batched_rowsharded(As, make_mesh2d(2, 2, "batch", "rows"),
                                       config=cfg)
        assert bool(np.asarray(got.converged).all())

    def test_batched_sharded_relative(self, rng):
        from eigen_value.parallel.batched import solve_batched_sharded
        from jax.sharding import Mesh

        As = jnp.asarray(
            rng.random((4, N, N), dtype=np.float32) + 0.1
        ) * jnp.float32(1e6)
        mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("batch",))
        cfg = SolverConfig(max_itr=200, eps_mode="relative")
        got = solve_batched_sharded(As, mesh, config=cfg)
        assert bool(np.asarray(got.converged).all())

    def test_batch_mesh_door_matches_unsharded(self, rng):
        """The round-4 mesh door on max_eigenvalue_batch: both mesh
        layouts (batch-sharded; batch×rows) must reproduce the unsharded
        batched results per matrix, and a mesh without a batch axis must
        raise."""
        import jax
        from jax.sharding import Mesh

        As = jnp.asarray(rng.random((4, N, N), dtype=np.float32) + 0.1)
        want = max_eigenvalue_batch(As)
        mesh_b = Mesh(np.array(jax.devices("cpu")[:4]), ("batch",))
        got = max_eigenvalue_batch(As, mesh=mesh_b)
        np.testing.assert_array_equal(
            np.asarray(got.rounds), np.asarray(want.rounds)
        )
        np.testing.assert_allclose(
            np.asarray(got.eigenvalue), np.asarray(want.eigenvalue), rtol=1e-6
        )
        got2 = max_eigenvalue_batch(
            As, mesh=make_mesh2d(2, 2, "batch", "rows")
        )
        assert bool(np.asarray(got2.converged).all())
        np.testing.assert_allclose(
            np.asarray(got2.eigenvalue), np.asarray(want.eigenvalue), rtol=1e-4
        )
        with pytest.raises(ValueError, match="batch"):
            max_eigenvalue_batch(As, mesh=make_row_mesh(4))

    def test_multiround_chunk_honored(self):
        """An explicit chunk reaches the multiround loop: any chunk gives
        the same rounds and λ as the per-round loop (the freeze makes the
        chunking invisible), including chunks that split the solve."""
        want = max_eigenvalue(fixtures.hilbert_matrix(256))
        for chunk in (1, 4, 11):
            res = max_eigenvalue(
                fixtures.hilbert_matrix(256),
                SolverConfig(backend="multiround", chunk=chunk),
            )
            assert int(res.rounds) == fixtures.HILBERT_ROUNDS[256]
            assert bool(res.converged)
            assert float(res.eigenvalue) == float(want.eigenvalue)
