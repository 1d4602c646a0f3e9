"""Analytical scaling model for multi-device solves.

Pod-scale behavior is PREDICTED from first principles — clearly a model,
not a measurement.  The per-round cost of the row-partitioned matvec-form
solve (parallel/sharded.py) decomposes as:

  * local compute: the shard's matvec is bound by memory bandwidth —
    ``(n²/P)·itemsize / hbm_gbps``;
  * exchange: the O(n) scaling vector.
      - gathered form: one all_gather per round — each card receives
        (P−1)/P·n·itemsize over its NVLink links, plus per-step latency
        on the ring of P shards;
      - ring form: P−1 ppermute steps of an n/P chunk, each OVERLAPPED
        with that chunk's GEMV — the exchange only costs where a chunk's
        wire time exceeds its compute time (latency-bound small chunks);
  * network: when the mesh spans hosts, ``hosts − 1`` chunk boundaries
    of the exchange cross the network between hosts instead of NVLink.

Defaults are NVIDIA's published H100 SXM figures (memory and NVLink
bandwidth) and a published 400 Gb/s network adapter per card; the two
latencies are assumptions, which :func:`sensitivity_table` sweeps.
Override ``ChipSpec`` for other parts.  ``python -m eigen_value.bench
--suite model`` prints the prediction tables.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Hardware parameters of one card and its links (defaults: H100 SXM
    data sheet; the latencies are assumed, not published)."""

    hbm_gbps: float = 3350.0  # published peak memory bandwidth
    link_gbps: float = 450.0  # NVLink to the host's other cards, each way
    link_latency_us: float = 2.0  # per collective step (assumed)
    net_gbps: float = 50.0  # 400 Gb/s adapter per card between hosts
    net_latency_us: float = 10.0  # per host crossing (assumed)
    itemsize: int = 4  # float32 matrix


DEFAULT_SPEC = ChipSpec()


def local_matvec_us(n: int, p: int, spec: ChipSpec = DEFAULT_SPEC) -> float:
    """Bandwidth-bound time of one shard's (n/P × n) GEMV."""
    return (n / p) * n * spec.itemsize / spec.hbm_gbps / 1e3


def gather_exchange_us(
    n: int, p: int, hosts: int = 1, spec: ChipSpec = DEFAULT_SPEC
) -> float:
    """Per-round all_gather of the O(n) vector (gathered form)."""
    if p == 1:
        return 0.0
    wire = (p - 1) / p * n * spec.itemsize / spec.link_gbps / 1e3
    lat = (p - 1) * spec.link_latency_us
    if hosts > 1:
        # one chunk boundary per host crossing rides the network
        net_bytes = (hosts - 1) / p * n * spec.itemsize
        wire += net_bytes / spec.net_gbps / 1e3
        lat += (hosts - 1) * spec.net_latency_us
    return wire + lat


def ring_exchange_exposed_us(
    n: int, p: int, hosts: int = 1, spec: ChipSpec = DEFAULT_SPEC
) -> float:
    """EXPOSED (non-overlapped) exchange cost of the ring form: each of the
    P−1 rotation steps overlaps an n/P-chunk transfer with that chunk's
    GEMV; only the excess of wire over compute is paid."""
    if p == 1:
        return 0.0
    chunk_compute = local_matvec_us(n, p, spec) / p  # one chunk's GEMV
    chunk_wire = (n / p) * spec.itemsize / spec.link_gbps / 1e3 + spec.link_latency_us
    exposed = max(0.0, chunk_wire - chunk_compute) * (p - 1)
    if hosts > 1:
        net_chunk = (n / p) * spec.itemsize / spec.net_gbps / 1e3 + spec.net_latency_us
        exposed += max(0.0, net_chunk - chunk_compute) * (hosts - 1)
    return exposed


def exchange_2d_us(
    n: int, pr: int, pc: int, hosts: int = 1, spec: ChipSpec = DEFAULT_SPEC
) -> float:
    """Per-round exchange of the 2D block-sharded form
    (parallel/sharded.py::solve_sharded_2d): a psum of the n/pr partial
    row-sum vector along the pc-card cols axis (ring all-reduce:
    2(pc−1)/pc of the payload over the wire) followed by the same
    row-axis all_gather as the 1D gathered form.  The cols axis is laid
    out innermost (intra-host) so the psum rides NVLink; only the rows
    gather can cross hosts."""
    psum = 0.0
    if pc > 1:
        payload = (n / pr) * spec.itemsize
        psum = (
            2 * (pc - 1) / pc * payload / spec.link_gbps / 1e3
            + 2 * (pc - 1) * spec.link_latency_us
        )
    return psum + gather_exchange_us(n, pr, hosts, spec)


def round_time_2d_us(
    n: int,
    pr: int,
    pc: int,
    hosts: int = 1,
    spec: ChipSpec = DEFAULT_SPEC,
) -> float:
    """Predicted per-round wall time of the 2D block-sharded solve: the
    bandwidth-bound (n/pr × n/pc) block GEMV plus the psum+gather exchange."""
    local = (n / pr) * (n / pc) * spec.itemsize / spec.hbm_gbps / 1e3
    return local + exchange_2d_us(n, pr, pc, hosts, spec)


def balanced_factorization(p: int) -> tuple:
    """(pr, pc) with pr·pc = p and pr the largest divisor ≤ √p — the
    squarest mesh shape, which the bench suite and prediction table use."""
    pr = 1
    for cand in range(1, int(p**0.5) + 1):
        if p % cand == 0:
            pr = cand
    return pr, p // pr


def round_time_us(
    n: int,
    p: int,
    hosts: int = 1,
    ring: bool = False,
    spec: ChipSpec = DEFAULT_SPEC,
) -> float:
    """Predicted per-round wall time of the sharded matvec-form solve."""
    exch = (
        ring_exchange_exposed_us(n, p, hosts, spec)
        if ring
        else gather_exchange_us(n, p, hosts, spec)
    )
    return local_matvec_us(n, p, spec) + exch


def scaling_efficiency(
    n: int,
    p: int,
    hosts: int = 1,
    ring: bool = False,
    spec: ChipSpec = DEFAULT_SPEC,
) -> float:
    """Predicted strong-scaling efficiency vs the 1-chip round time:
    ideal = T(1)/P, efficiency = ideal / T(P)."""
    t1 = round_time_us(n, 1, 1, ring, spec)
    tp = round_time_us(n, p, hosts, ring, spec)
    return (t1 / p) / tp


def sensitivity_table(
    n: int = 32768,
    chip_counts=(16, 64),
    chips_per_host: int = 8,
    gbps_vals=(100.0, 200.0, 450.0, 900.0),
    lat_vals=(0.5, 2.0, 5.0, 25.0),
) -> List[dict]:
    """Efficiency sensitivity to the UNVALIDATED link parameters.  Sweeps
    link bandwidth and latency over a 9×/50× range around the defaults
    and reports predicted efficiency for both solver forms — showing how
    much the predictions move if the assumptions are wrong."""
    rows = []
    for p in chip_counts:
        hosts = max(1, p // chips_per_host)
        for g in gbps_vals:
            for l in lat_vals:
                spec = dataclasses.replace(
                    DEFAULT_SPEC, link_gbps=g, link_latency_us=l
                )
                for ring in (False, True):
                    rows.append(
                        {
                            "bench": "model_sensitivity",
                            "dim": n,
                            "chips": p,
                            "hosts": hosts,
                            "link_gbps": g,
                            "link_latency_us": l,
                            "solver": "matvec_ring" if ring else "matvec_gather",
                            "efficiency": scaling_efficiency(
                                n, p, hosts, ring, spec
                            ),
                        }
                    )
    return rows


def prediction_table(
    dims: List[int] = (8192, 32768, 65536),
    chip_counts: List[int] = (1, 4, 8, 16, 64, 256),
    chips_per_host: int = 8,
    spec: ChipSpec = DEFAULT_SPEC,
) -> List[dict]:
    """Model predictions for the bench CLI (--suite model)."""
    rows = []
    for n in dims:
        for p in chip_counts:
            if n % p != 0:
                continue
            hosts = max(1, p // chips_per_host)
            for ring in (False, True):
                rows.append(
                    {
                        "bench": "model",
                        "dim": n,
                        "chips": p,
                        "hosts": hosts,
                        "solver": "matvec_ring" if ring else "matvec_gather",
                        "round_us": round_time_us(n, p, hosts, ring, spec),
                        "efficiency": scaling_efficiency(n, p, hosts, ring, spec),
                    }
                )
            pr, pc = balanced_factorization(p)
            if n % pr == 0 and n % pc == 0:
                t1 = round_time_us(n, 1, 1, False, spec)
                t2d = round_time_2d_us(n, pr, pc, hosts, spec)
                rows.append(
                    {
                        "bench": "model",
                        "dim": n,
                        "chips": p,
                        "hosts": hosts,
                        "solver": f"matvec_2d_{pr}x{pc}",
                        "round_us": t2d,
                        "efficiency": (t1 / p) / t2d,
                    }
                )
    return rows
