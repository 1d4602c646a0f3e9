"""Pallas kernels for the O(n²) pass, compiled for an NVIDIA GPU through
Pallas's Triton route."""

from . import kernels

__all__ = ["kernels"]
