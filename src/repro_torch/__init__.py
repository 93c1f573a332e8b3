"""PyTorch / CUDA port of ``repro``: dynamic load balancing for adaptive
finite element computation.

Same module layout as the JAX package.  This package covers the main
path -- one adaptive FEM step with dynamic load balancing on one device:
``fem.AdaptiveSession`` (solve -> estimate -> mark -> refine -> balance)
and ``core.Balancer`` (SFC keys -> 1-D partition -> remap -> migration
metrics) -- with three hand-written Hopper kernels under it
(``kernels/csrc``).  Entry points take ``device=`` (default ``"cuda"``)
and never fall back to the CPU.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
