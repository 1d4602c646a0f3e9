"""Fixture-generator tests (reference analogs: utils.cpp checks)."""

import numpy as np

from eigen_value import fixtures


def test_hilbert_values():
    H = np.asarray(fixtures.hilbert_matrix(16))
    r, c = 3, 7
    assert H[r, c] == np.float32(1.0) / np.float32(r + c + 1)
    assert H.dtype == np.float32
    assert (H > 0).all()


def test_identity_rowsum_is_one():
    # reference test: row sums of the identity are exactly 1 (tests/test.cpp:22-30)
    I = np.asarray(fixtures.identity_matrix(64))
    assert (I.sum(axis=1) == 1.0).all()


def test_ramp_max():
    # reference test: max of (1..n) is exactly n (tests/test.cpp:33-41)
    v = np.asarray(fixtures.ramp_vector(256))
    assert v.max() == 256.0 and v.min() == 1.0


def test_stop_fixtures():
    from eigen_value.ops.solver import stop_check

    ok = fixtures.stop_success_vector(128)
    bad = fixtures.stop_fail_vector(128)
    assert bool(stop_check(ok, 1e-3))
    # adjacent diffs of the fail fixture are all < EPS; only the wraparound
    # pair trips the check — this asserts the wraparound semantics
    # (reference tests/test.cpp:66-73 + similarity_transform.cpp:385-417)
    bad_np = np.asarray(bad)
    assert (np.abs(np.diff(bad_np)) < 1e-3).all()
    assert not bool(stop_check(bad, 1e-3))


def test_random_positive():
    import jax

    m = np.asarray(fixtures.random_positive_matrix(jax.random.key(0), 64))
    assert (m > 0).all() and m.max() <= 1.0
