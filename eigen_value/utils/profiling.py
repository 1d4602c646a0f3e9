"""Profiling/tracing helpers (SURVEY.md §5: the reference had only manual
wall-clock timing; the equivalent here is a jax.profiler trace, viewable in
Perfetto/XProf, with device timelines of the card)."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Capture a device trace around a code region into ``log_dir``.

    Usage::

        with profiling.trace("chiprun_out/trace") as d:
            res = max_eigenvalue(A)
            jax.block_until_ready(res)
        # open `d` in XProf / tensorboard-plugin-profile

    A trace that fails to start or stop raises: a profile that silently
    recorded nothing would be read as one that found nothing.
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return jax.profiler.TraceAnnotation(name)


def device_memory_stats() -> Optional[dict]:
    """Live device-memory usage of device 0 (None where the backend keeps
    no statistics, as the CPU does)."""
    return jax.devices()[0].memory_stats()
