"""Multi-host solves: `jax.distributed` + host-major meshes.

BASELINE.json config 5: a 32768² matrix row-partitioned across cards of
≥2 hosts.  The reference has no multi-node anything (SURVEY.md §2); this
module is the capability this build adds.

Design:
  * Process group bootstrap via :func:`initialize` (standard
    ``jax.distributed.initialize``; fail-fast on error — no elastic
    recovery needed for parity, SURVEY.md §5).
  * The mesh is host-major: the host dimension is outermost and each
    host's cards innermost — the per-round ``all_gather`` of the O(n)
    scaling vector then rides NVLink within each host and crosses the
    network between hosts once (the collective is tiny: 4n bytes vs n²/P
    per shard of compute).
  * The solver itself is :func:`..sharded.solve_sharded_matvec` — global
    arrays + shard_map are multi-host-transparent in JAX: the same code
    runs on 1 card, 4 cards, or many hosts.

Weak-scaling accounting (north-star: ≥80% efficiency at ≥2 hosts):
``weak_scaling_efficiency`` compares measured elems/s/chip against the
single-chip figure.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_CONFIG, SolverConfig
from ..ops.solver import SolveResult
from .sharded import require_axis, solve_sharded_matvec


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bootstrap the multi-host process group.

    With no arguments, relies on the cluster environment's own
    auto-detection; elsewhere pass all three (e.g. a ``localhost:<port>``
    coordinator).  Call once per process before any device use.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_global_row_mesh(
    axis_name: str = "rows", platform: Optional[str] = None
) -> Mesh:
    """1D row mesh over ALL devices of all processes, host-major so the
    shard boundary crossing the network is between host blocks (the
    all_gather then decomposes into intra-host gathers + one inter-host
    exchange).

    ``platform`` pins the device kind (e.g. ``"cpu"`` for the multi-process
    CPU workers, which must stay off a card present in the machine).
    """
    devs = jax.devices(platform) if platform else jax.devices()
    return Mesh(np.asarray(devs), (axis_name,))


def make_global_mesh2d(
    row_axis: str = "rows",
    col_axis: str = "cols",
    platform: Optional[str] = None,
) -> Mesh:
    """2D (processes × local devices) mesh for block-sharded multi-host
    solves: the rows axis is the PROCESS axis (so the per-round rows
    gather is the only collective crossing the network) and the cols
    axis spans each host's local devices (the psum completing the row
    sums rides NVLink).  Pairs with :func:`assemble_blocksharded` and
    :func:`..sharded.solve_sharded_2d`.
    """
    devs = jax.devices(platform) if platform else jax.devices()
    procs = sorted({d.process_index for d in devs})
    by_proc = [[d for d in devs if d.process_index == p] for p in procs]
    if len({len(b) for b in by_proc}) != 1:
        raise ValueError(
            "processes own unequal device counts "
            f"({[len(b) for b in by_proc]}) — cannot form a rectangular mesh"
        )
    return Mesh(np.array(by_proc), (row_axis, col_axis))


def _require_host_major(proc_seq) -> None:
    """Validate the placement precondition of :func:`assemble_rowsharded`:
    process p's block lands at global rows [p·n/P, (p+1)·n/P) ONLY if the
    mesh's flat device order is host-major — each process's devices in one
    contiguous span, spans ordered by process index.  A caller-built mesh
    that interleaves processes would otherwise place row blocks at wrong
    global offsets with no error (ADVICE r1) — raise instead of trusting
    the docstring."""
    if list(proc_seq) != sorted(proc_seq):
        raise ValueError(
            "mesh device order is not host-major (process indices along the "
            f"flat mesh axis: {list(proc_seq)}) — assemble_rowsharded would "
            "place row blocks at wrong global offsets; build the mesh with "
            "make_global_row_mesh or order devices by process"
        )


def assemble_rowsharded(
    local_rows: np.ndarray, mesh: Mesh, axis_name: str = "rows"
) -> jax.Array:
    """Assemble the GLOBAL row-sharded matrix from this process's block.

    Each process passes only its contiguous block of rows
    ``[p·n/P_host, (p+1)·n/P_host)`` (host-major order, matching the mesh
    from :func:`make_global_row_mesh`); the result is a global
    ``jax.Array`` sharded ``P(axis_name, None)`` whose data never leaves
    the host that produced it.  This is how a 32768² matrix that fits no
    single host's memory is fed to :func:`solve_multihost`.
    """
    n = local_rows.shape[1]
    n_local = local_rows.shape[0]
    # All topology facts are derived from the mesh's own devices, NOT the
    # default backend (the mesh may be on another platform than it).
    flat = list(mesh.devices.flat)
    require_axis(mesh, axis_name)
    if mesh.shape[axis_name] != len(flat):
        raise ValueError(
            f"assemble_rowsharded needs a 1-D mesh over '{axis_name}' "
            f"(axis size {mesh.shape[axis_name]} vs {len(flat)} devices) — "
            "P(axis, None) would replicate chunks this function places as "
            "distinct blocks; use assemble_blocksharded for 2D layouts"
        )
    _require_host_major([d.process_index for d in flat])
    proc_counts: dict = {}
    for d in flat:
        proc_counts[d.process_index] = proc_counts.get(d.process_index, 0) + 1
    if len(set(proc_counts.values())) != 1:
        raise ValueError(
            f"processes own unequal device counts ({proc_counts}) — equal "
            "per-process row blocks would land at wrong global offsets; "
            "build the mesh with make_global_row_mesh"
        )
    n_procs = len(proc_counts)
    if n_local * n_procs != n:
        raise ValueError(
            f"local block {local_rows.shape} with {n_procs} "
            f"processes does not assemble to a square {n}×{n} matrix"
        )
    local_set = set(jax.local_devices(backend=flat[0].platform))
    my_devs = [d for d in flat if d in local_set]
    if not my_devs:
        raise ValueError(
            "this process owns no devices in the mesh — every process in "
            "the group must participate (build the mesh with "
            "make_global_row_mesh over all processes)"
        )
    if n_local % len(my_devs) != 0:
        raise ValueError(
            f"{n_local} local rows not divisible over {len(my_devs)} "
            "local devices"
        )
    sharding = NamedSharding(mesh, P(axis_name, None))
    chunks = np.split(np.ascontiguousarray(local_rows), len(my_devs))
    shards = [jax.device_put(ch, d) for ch, d in zip(chunks, my_devs)]
    return jax.make_array_from_single_device_arrays((n, n), sharding, shards)


def assemble_blocksharded(
    local_rows: np.ndarray,
    mesh: Mesh,
    row_axis: str = "rows",
    col_axis: str = "cols",
) -> jax.Array:
    """Assemble the GLOBAL 2D block-sharded matrix from this process's
    contiguous row block (the 2D analog of :func:`assemble_rowsharded`).

    Each process passes its rows ``[p·n/P, (p+1)·n/P)`` as one host
    array; they are split column-wise across the process's devices along
    ``col_axis`` and placed so device (i, j) holds block
    ``A[i·n/pr:(i+1)·n/pr, j·n/pc:(j+1)·n/pc]``.  No data crosses hosts.
    Preconditions validated: every ``row_axis`` slice of the mesh is
    owned by exactly one process, processes appear in host-major order,
    and each owns the same number of mesh rows (the layout
    :func:`make_global_mesh2d` builds).
    """
    n = local_rows.shape[1]
    names = list(mesh.axis_names)
    grid = np.moveaxis(
        mesh.devices, (names.index(row_axis), names.index(col_axis)), (0, 1)
    )
    pr, pc = grid.shape
    if n % pr or n % pc:
        raise ValueError(f"dim {n} not divisible by the {pr}x{pc} mesh")
    row_procs = []
    for i in range(pr):
        procs = {d.process_index for d in grid[i]}
        if len(procs) != 1:
            raise ValueError(
                f"mesh row {i} spans processes {sorted(procs)} — each "
                "rows-axis block must be owned by one process (build the "
                "mesh with make_global_mesh2d)"
            )
        row_procs.append(procs.pop())
    _require_host_major(row_procs)
    counts = {p: row_procs.count(p) for p in set(row_procs)}
    if len(set(counts.values())) != 1:
        raise ValueError(
            f"processes own unequal mesh-row counts ({counts}) — row "
            "blocks would have unequal sizes"
        )
    n_procs = len(counts)
    if local_rows.shape[0] * n_procs != n:
        raise ValueError(
            f"local block {local_rows.shape} with {n_procs} processes "
            f"does not assemble to a square {n}×{n} matrix"
        )
    local_set = set(jax.local_devices(backend=grid[0, 0].platform))
    my_rows = [i for i in range(pr) if grid[i, 0] in local_set]
    if not my_rows:
        raise ValueError(
            "this process owns no mesh rows — every process in the group "
            "must participate (build the mesh with make_global_mesh2d over "
            "all processes)"
        )
    blk_r, blk_c = n // pr, n // pc
    row_base = min(my_rows) * blk_r
    local_rows = np.ascontiguousarray(local_rows)
    shards = [
        jax.device_put(
            np.ascontiguousarray(
                local_rows[
                    i * blk_r - row_base : (i + 1) * blk_r - row_base,
                    j * blk_c : (j + 1) * blk_c,
                ]
            ),
            grid[i, j],
        )
        for i in my_rows
        for j in range(pc)
    ]
    sharding = NamedSharding(mesh, P(row_axis, col_axis))
    return jax.make_array_from_single_device_arrays((n, n), sharding, shards)


def solve_multihost(
    A,
    config: SolverConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
) -> SolveResult:
    """Row-partitioned solve across every device in the process group.

    ``A`` is either a global ``jax.Array`` (e.g. from
    :func:`assemble_rowsharded`) or, in a single-process group, any
    host array (sharded row-wise via ``jax.device_put``).
    """
    mesh = mesh or make_global_row_mesh()
    return solve_sharded_matvec(A, mesh, axis_name="rows", config=config)


def elems_per_second(n: int, rounds: int, seconds: float) -> float:
    """Matrix elements processed per second: rounds × n² / t (the matvec
    form touches each element once per round)."""
    return rounds * float(n) * float(n) / seconds


def weak_scaling_efficiency(
    elems_per_s_multi: float, n_chips: int, elems_per_s_single: float
) -> float:
    """Efficiency vs perfect linear scaling from the 1-chip baseline."""
    return elems_per_s_multi / (n_chips * elems_per_s_single)
