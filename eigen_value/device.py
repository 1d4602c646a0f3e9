"""Which platform a computation runs on, and what that allows.

The solver's default path is plain XLA and runs anywhere.  Its Pallas
kernels (ops/pallas/kernels.py) compile for an NVIDIA GPU only; on any
other platform they run only when the caller asks for Pallas's
interpreter.  Interpret mode is never chosen for a caller.
"""

from __future__ import annotations

from typing import Optional

import jax


def platform(device: Optional[jax.Device] = None) -> str:
    """Platform of ``device``, else of the default device: ``"gpu"`` for
    CUDA, ``"cpu"``.  Honors an explicit ``jax_default_device`` (the test
    suite pins the CPU that way)."""
    if device is not None:
        return device.platform
    d = jax.config.jax_default_device
    if d is not None:
        return getattr(d, "platform", str(d))
    return jax.default_backend()


def require_gpu(interpret: bool, device: Optional[jax.Device] = None) -> None:
    """Raise unless a Pallas kernel can run where the solve runs: compiled
    on a GPU, or interpreted because the caller asked."""
    if interpret:
        return
    plat = platform(device)
    if plat != "gpu":
        raise ValueError(
            f"the Pallas kernels compile for an NVIDIA GPU only, and this "
            f"solve runs on {plat!r}; pass interpret=True to run them "
            f"through the Pallas interpreter, or use backend='auto'"
        )
