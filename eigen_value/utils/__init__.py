"""Utilities: timing and published peaks, AOT compilation cache and
export, profiling, scaling model."""

from . import profiling, scaling_model
from .aot import (
    disable_persistent_cache,
    enable_persistent_cache,
    export_sharded_solver,
    export_solver,
    load_exported,
    save_exported,
)
from .timing import device_peak, roofline_pct, time_call, time_marginal

__all__ = [
    "device_peak",
    "disable_persistent_cache",
    "enable_persistent_cache",
    "export_sharded_solver",
    "export_solver",
    "load_exported",
    "roofline_pct",
    "save_exported",
    "time_call",
    "time_marginal",
]
