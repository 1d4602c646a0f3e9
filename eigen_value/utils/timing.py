"""Timing utilities and the published peaks a device time is divided by.

A JAX call returns before the device finishes, so every timing here ends
in ``jax.block_until_ready`` and reads the host clock around it (the
reference's ``std::chrono`` around ``q.wait()``,
similarity_transform.cpp:36-58).

Per-op cost is measured *marginally*: time a jitted chain of k dependent
applications and one application, and divide the difference by k — the
fixed per-call dispatch cost cancels.  ``time_marginal`` needs the op to
be expressible as a shape-preserving state transition so the chain stays
on device inside one executable.
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional

import jax


def time_call(fn: Callable[[], Any], reps: int = 5, warmup: int = 1) -> float:
    """Best-of-reps wall ms of ``fn()``, ended by ``block_until_ready``."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def time_marginal(
    step: Callable[[Any, Any], Any],
    init: Any,
    k: int = 64,
    reps: int = 7,
) -> float:
    """Marginal ms per application of ``step(i, state) -> state`` (a
    shape-preserving transition; ``i`` is the chain index), measured as
    (T(k+1 chained) - T(1)) / k inside single jitted executables so the
    dispatch cost cancels.

    ``step`` must not be loop-invariant: carry real data dependence through
    the state (a fused ~1e-38 scalar bias is enough) — otherwise XLA hoists
    the op out of the loop and the marginal reads 0.  The two chain
    lengths are measured interleaved so a drift of the host or the card
    hits both alike.
    """

    def chain(m: int):
        @jax.jit
        def run(state):
            return jax.lax.fori_loop(0, m, step, state)

        return run

    run1, runk = chain(1), chain(k + 1)
    jax.block_until_ready(run1(init))  # compile both before timing
    jax.block_until_ready(runk(init))
    t1 = tk = float("inf")
    for _ in range(reps):
        s0 = time.perf_counter()
        jax.block_until_ready(run1(init))
        t1 = min(t1, (time.perf_counter() - s0) * 1e3)
        s0 = time.perf_counter()
        jax.block_until_ready(runk(init))
        tk = min(tk, (time.perf_counter() - s0) * 1e3)
    return max(tk - t1, 0.0) / k


def roofline_pct(ms: float, bytes_moved: int, peak_gbps: float) -> float:
    """Achieved memory bandwidth as % of peak for a memory-bound op."""
    if ms <= 0:
        return float("nan")
    achieved = bytes_moved / (ms * 1e-3) / 1e9
    return 100.0 * achieved / peak_gbps


class DevicePeak(NamedTuple):
    """Published peaks of one device: memory bandwidth, float32 rate
    outside the tensor cores, and NVLink to the other cards of the host
    (each way)."""

    hbm_gbps: float
    f32_tflops: float
    nvlink_gbps_each_way: float
    source: str


#: Published peaks keyed by ``jax.Device.device_kind``.  Rates assume the
#: card's full power limit; a card set below it cannot hold them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeak(
        hbm_gbps=3350.0,
        f32_tflops=67.0,
        nvlink_gbps_each_way=450.0,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5 part",
    ),
}


def device_peak(device: Optional[jax.Device] = None) -> DevicePeak:
    """The published peaks of ``device`` (default: the first device).
    A device whose kind is not in :data:`PEAKS` is an error, not a
    default: a roofline divided by a guessed peak is no measurement."""
    kind = (device or jax.devices()[0]).device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; add its data-sheet "
            f"figures to utils.timing.PEAKS (known: {sorted(PEAKS)})"
        ) from None
