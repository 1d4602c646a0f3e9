"""Analytical scaling model: its published-figure anchor and limiting
behavior."""

import pytest

from eigen_value.utils import scaling_model as sm


def test_single_chip_calibration():
    """P=1 is the bandwidth-bound product at the published H100 peak:
    8192²·4 B at 3.35 TB/s ≈ 80 µs per round."""
    assert sm.DEFAULT_SPEC.hbm_gbps == 3350.0
    assert sm.round_time_us(8192, 1) == pytest.approx(8192 * 8192 * 4 / 3350e3)
    assert sm.scaling_efficiency(8192, 1) == 1.0


def test_ring_never_worse_than_gather():
    for n in (8192, 32768, 65536):
        for p in (4, 8, 16, 64):
            hosts = max(1, p // 8)
            assert sm.round_time_us(n, p, hosts, ring=True) <= sm.round_time_us(
                n, p, hosts, ring=False
            ) + 1e-9


def test_efficiency_decreases_with_chips_at_fixed_n():
    effs = [sm.scaling_efficiency(8192, p, max(1, p // 8)) for p in (1, 8, 64, 256)]
    assert all(a >= b - 1e-9 for a, b in zip(effs, effs[1:]))


def test_bigger_problems_scale_better():
    """Weak-scaling intuition: at fixed P, larger n has more compute to
    hide the O(n) exchange behind ⇒ higher efficiency."""
    assert sm.scaling_efficiency(65536, 64, 8) > sm.scaling_efficiency(8192, 64, 8)


def test_north_star_prediction_80pct_at_two_hosts():
    """BASELINE config 5 regime (32768², ≥2 hosts): on H100 figures the
    per-round product is short (~80 µs on 16 cards), so the model meets
    the ≥80% target only with the ring form, which hides the exchange
    behind the chunk products; the gathered form pays its step latencies
    in full."""
    assert sm.scaling_efficiency(32768, 16, hosts=2, ring=True) > 0.8
    assert sm.scaling_efficiency(32768, 16, hosts=2, ring=False) < 0.8


def test_overlap_fully_hides_ici_for_large_chunks():
    """Ring exchange is free when each chunk's GEMV exceeds its wire time
    (the overlap premise) — true for 32768² on a single-host mesh."""
    assert sm.ring_exchange_exposed_us(32768, 8, hosts=1) == 0.0


class TestCalibration:
    """The sensitivity sweep over the assumed link parameters."""

    def test_sensitivity_table_covers_grid(self):
        from eigen_value.utils.scaling_model import sensitivity_table

        rows = sensitivity_table(chip_counts=(16,))
        assert len(rows) == 4 * 4 * 2  # gbps x latency x solver form
        assert {r["solver"] for r in rows} == {"matvec_gather", "matvec_ring"}
        # efficiency must degrade monotonically with latency at fixed gbps
        g = [
            r
            for r in rows
            if r["solver"] == "matvec_gather" and r["link_gbps"] == 450.0
        ]
        effs = [r["efficiency"] for r in sorted(g, key=lambda r: r["link_latency_us"])]
        assert effs == sorted(effs, reverse=True)


class TestModel2D:
    def test_balanced_factorization(self):
        from eigen_value.utils.scaling_model import balanced_factorization

        assert balanced_factorization(1) == (1, 1)
        assert balanced_factorization(8) == (2, 4)
        assert balanced_factorization(16) == (4, 4)
        assert balanced_factorization(12) == (3, 4)
        assert balanced_factorization(7) == (1, 7)

    def test_degenerate_cols_axis_equals_gather_form(self):
        """pc=1 has no psum: the 2D round time must equal the 1D gathered
        form with p=pr shards (same local GEMV, same rows gather)."""
        from eigen_value.utils.scaling_model import (
            round_time_2d_us,
            round_time_us,
        )

        for pr in (1, 4, 8):
            assert round_time_2d_us(32768, pr, 1) == pytest.approx(
                round_time_us(32768, pr, ring=False)
            )

    def test_pure_column_sharding_pays_psum_only(self):
        from eigen_value.utils.scaling_model import (
            exchange_2d_us,
            gather_exchange_us,
        )

        # pr=1: no rows gather (gather_exchange_us(n, 1) == 0), psum > 0
        assert gather_exchange_us(4096, 1) == 0.0
        assert exchange_2d_us(4096, 1, 8) > 0.0

    def test_prediction_table_includes_2d_rows(self):
        from eigen_value.utils.scaling_model import prediction_table

        rows = prediction_table(dims=[8192], chip_counts=(1, 8))
        solvers = {r["solver"] for r in rows}
        assert "matvec_2d_2x4" in solvers
        r2d = [r for r in rows if r["solver"] == "matvec_2d_2x4"][0]
        # the extra psum makes 2D no faster than the 1D gathered form at
        # the same chip count — it's a memory-capacity play
        r1d = [
            r
            for r in rows
            if r["solver"] == "matvec_gather" and r["chips"] == 8
        ][0]
        assert r2d["round_us"] >= r1d["round_us"]
