"""PyTorch / CUDA port of ``repro``: dynamic load balancing for adaptive
finite element computation.

Same module layout as the JAX package.  This package covers the adaptive
FEM step with dynamic load balancing on one device --
``fem.AdaptiveSession`` (solve -> estimate -> mark -> refine -> balance)
and ``core.Balancer`` (SFC keys -> 1-D partition -> remap -> migration
metrics) -- the same over a ``torch.distributed`` process group, one rank
per part (``distributed``: sharded balancer, ``all_to_all`` migration;
``fem.halo`` / ``fem.parallel``: owned-vertex halo exchange and PCG), and
the serving path of the dense and MoE families (``serve``), with six
hand-written Hopper kernels under them (``kernels/csrc``).  Entry points take
``device=`` (default ``"cuda"``) and never fall back to the CPU.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
