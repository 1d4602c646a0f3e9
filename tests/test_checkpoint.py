"""Checkpoint/resume: chunked stepping must be bit-identical to one-shot."""

import numpy as np
import pytest

from eigen_value import checkpoint, fixtures
from eigen_value.config import EPS, MAX_ITR
from eigen_value.ops.solver_matvec import solve_matvec

DIM = 512  # 12 rounds (fixtures.HILBERT_ROUNDS)


@pytest.fixture(scope="module")
def hilbert():
    return fixtures.hilbert_matrix(DIM)


def init_keep(A):
    """init_state without donating the (module-scoped) fixture array."""
    return checkpoint.init_state(A, donate=False)


@pytest.fixture(scope="module")
def oneshot(hilbert):
    return solve_matvec(hilbert, eps=EPS, max_itr=MAX_ITR)


def test_chunked_stepping_bitexact(hilbert, oneshot):
    state = init_keep(hilbert)
    for _ in range(10):  # 5-round chunks; converges inside the 3rd
        state = checkpoint.step(state, 5)
    res = checkpoint.to_result(state)
    assert bool(res.converged)
    assert int(res.rounds) == fixtures.HILBERT_ROUNDS[DIM]
    assert float(res.eigenvalue) == float(oneshot.eigenvalue)  # bit-exact
    np.testing.assert_array_equal(
        np.asarray(res.eigenvector), np.asarray(oneshot.eigenvector)
    )


def test_step_is_noop_after_convergence(hilbert, oneshot):
    state = checkpoint.step(init_keep(hilbert), 1000)
    rounds, lam = int(state.rounds), float(state.lam)
    again = checkpoint.step(state, 7)  # donates (invalidates) `state`
    assert int(again.rounds) == rounds
    assert float(again.lam) == lam


def test_save_load_roundtrip_resume(tmp_path, hilbert, oneshot):
    path = str(tmp_path / "state.npz")
    state = checkpoint.step(init_keep(hilbert), 4)
    assert not bool(state.done)
    checkpoint.save_state(path, state)
    resumed = checkpoint.load_state(path)
    np.testing.assert_array_equal(np.asarray(resumed.v), np.asarray(state.v))
    final = checkpoint.step(resumed, 1000)
    assert bool(final.done)
    assert float(final.lam) == float(oneshot.eigenvalue)
    assert int(final.rounds) == int(oneshot.rounds)


def test_solve_checkpointed_driver_loop(tmp_path, hilbert, oneshot):
    path = str(tmp_path / "drv.npz")
    res = checkpoint.solve_checkpointed(hilbert, chunk_rounds=3, checkpoint_path=path)
    assert bool(res.converged)
    assert float(res.eigenvalue) == float(oneshot.eigenvalue)
    # the final snapshot exists and resuming from it is a no-op solve
    res2 = checkpoint.solve_checkpointed(hilbert, chunk_rounds=3, checkpoint_path=path)
    assert int(res2.rounds) == int(res.rounds)


def test_stale_checkpoint_path_raises(tmp_path, hilbert):
    """Reusing a checkpoint path for a different matrix must raise, not
    silently return the previous solve's result."""
    path = str(tmp_path / "stale.npz")
    checkpoint.solve_checkpointed(hilbert, chunk_rounds=50, checkpoint_path=path)
    other = np.asarray(hilbert) * np.float32(2.0)
    with pytest.raises(ValueError, match="different matrix"):
        checkpoint.solve_checkpointed(other, chunk_rounds=50, checkpoint_path=path)
    with pytest.raises(ValueError, match="checkpoint"):
        checkpoint.solve_checkpointed(
            fixtures.hilbert_matrix(DIM * 2), chunk_rounds=50, checkpoint_path=path
        )


def test_interior_row_mismatch_raises(tmp_path, hilbert):
    """A matrix differing ONLY in interior rows must be rejected on resume
    (VERDICT r1: the old first/last-row check silently resumed wrong)."""
    path = str(tmp_path / "interior.npz")
    checkpoint.solve_checkpointed(hilbert, chunk_rounds=50, checkpoint_path=path)
    other = np.asarray(hilbert).copy()
    other[DIM // 2, :] *= np.float32(1.5)  # boundary rows untouched
    with pytest.raises(ValueError, match="different matrix"):
        checkpoint.solve_checkpointed(other, chunk_rounds=50, checkpoint_path=path)


def test_eps_mismatch_on_resume_raises(tmp_path, hilbert):
    """Resuming under a different stop tolerance than the snapshot's must
    raise — mixing tolerances across chunks corrupts the round count."""
    path = str(tmp_path / "eps.npz")
    checkpoint.solve_checkpointed(
        hilbert, chunk_rounds=2, checkpoint_path=path, eps=EPS
    )
    with pytest.raises(ValueError, match="eps"):
        checkpoint.solve_checkpointed(
            hilbert, chunk_rounds=2, checkpoint_path=path, eps=EPS / 10
        )
    # same eps resumes fine
    res = checkpoint.solve_checkpointed(
        hilbert, chunk_rounds=2, checkpoint_path=path, eps=EPS
    )
    assert bool(res.converged)


def test_init_state_donation():
    """init_state(donate=True) consumes its input (one resident copy of A,
    ADVICE r1); state.A is the live alias."""
    import jax

    H = fixtures.hilbert_matrix(64)
    state = checkpoint.init_state(H, donate=True)
    assert state.A.shape == (64, 64)
    if jax.default_backend() == "cpu":  # donation supported: input is dead
        with pytest.raises(RuntimeError):
            _ = np.asarray(H)


def test_chunk_rounds_zero_raises(hilbert):
    # a 0-round step is a no-op; the driver loop would spin forever
    with pytest.raises(ValueError, match="chunk_rounds"):
        checkpoint.solve_checkpointed(hilbert, chunk_rounds=0)


def test_max_itr_cap(hilbert):
    res = checkpoint.to_result(
        checkpoint.step(init_keep(hilbert), 1000, max_itr=3)
    )
    assert not bool(res.converged)
    assert int(res.rounds) == 3


def test_orbax_roundtrip(tmp_path, hilbert):
    ocp = pytest.importorskip("orbax.checkpoint")  # noqa: F841
    state = checkpoint.step(init_keep(hilbert), 4)
    path = str(tmp_path / "orbax_state")
    checkpoint.save_state_orbax(path, state)
    template = init_keep(hilbert)
    restored = checkpoint.load_state_orbax(path, template)
    np.testing.assert_array_equal(np.asarray(restored.v), np.asarray(state.v))
    assert int(restored.rounds) == int(state.rounds)


def test_sharded_state_steps_identically(hilbert, oneshot):
    """The resumable state composes with sharding: a row-sharded A flows
    through init/step under GSPMD (per-round matvec partitioned, O(n)
    state replicated) with bit-identical results to the single-device
    path — so checkpointed solves scale to multi-chip unchanged."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("rows",))
    Hs = jax.device_put(hilbert, NamedSharding(mesh, P("rows", None)))
    st = checkpoint.step(checkpoint.init_state(Hs), 1000)
    assert bool(st.done)
    assert int(st.rounds) == int(oneshot.rounds)
    assert float(st.lam) == float(oneshot.eigenvalue)


def test_2d_blocksharded_state_steps_identically(hilbert, oneshot):
    """Same composition over a 2D (rows × cols) block sharding: GSPMD
    partitions the matvec over the blocks and inserts the psum/gather."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from eigen_value.parallel.sharded import make_mesh2d

    mesh = make_mesh2d(2, 4)
    Hs = jax.device_put(hilbert, NamedSharding(mesh, P("rows", "cols")))
    st = checkpoint.step(checkpoint.init_state(Hs), 1000)
    assert bool(st.done)
    assert int(st.rounds) == int(oneshot.rounds)
    assert float(st.lam) == pytest.approx(float(oneshot.eigenvalue), rel=1e-6)


def test_bf16_storage_stepping_matches_storage_solver():
    """Chunked stepping of a bf16-storage matrix must match
    solve_matvec_storage — same rounds, λ/ev to within an ulp (XLA fuses
    the bf16 dot differently across the two programs, so exact bitwise
    equality is not guaranteed the way it is for f32).  Round-2 fix: step
    previously ran the matvec without f32 accumulation and kept bf16 O(n)
    state, silently diverging from the storage-mode contract."""
    import jax.numpy as jnp

    from eigen_value.ops.solver_matvec import solve_matvec_storage

    H = fixtures.hilbert_matrix(256)
    want = solve_matvec_storage(H, EPS, MAX_ITR)

    Hq = H.astype(jnp.bfloat16)  # pre-quantized storage input
    state = checkpoint.init_state(Hq, donate=False)
    assert state.v.dtype == jnp.float32  # f32 O(n) state
    for _ in range(6):
        state = checkpoint.step(state, 3)
    res = checkpoint.to_result(state)
    assert bool(res.converged)
    assert int(res.rounds) == int(want.rounds)
    assert float(res.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-6)
    np.testing.assert_allclose(
        np.asarray(res.eigenvector), np.asarray(want.eigenvector), rtol=1e-5
    )
