"""Dispatch between the hand-written CUDA kernels and their plain versions.

Library code calls these, never the kernels directly.  ``use_pallas``
keeps the JAX package's name and means "use the hand-written kernels":

* ``None``  -- the kernel for CUDA tensors, the plain version for CPU ones;
* ``False`` -- the plain version wherever the tensors are;
* ``True``  -- the kernel; a CPU tensor raises.

There is no fallback: a CUDA tensor with ``use_pallas`` None or True
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import ref
from .fem_matvec import fem_matvec_cuda
from .ksection_hist import ksection_hist_cuda
from .sfc_keys import sfc_keys_cuda

#: kernel name -> wrapper; each wrapper carries a ``launches`` count
KERNELS = {"sfc_keys": sfc_keys_cuda, "ksection_hist": ksection_hist_cuda,
           "fem_matvec": fem_matvec_cuda}


def use_kernel(x: torch.Tensor, use_pallas: Optional[bool]) -> bool:
    """Resolve ``use_pallas`` for tensors living where ``x`` lives."""
    if use_pallas is None:
        return x.is_cuda
    if use_pallas and not x.is_cuda:
        raise ValueError("use_pallas=True runs the hand-written CUDA kernels, "
                         f"which need CUDA tensors (got one on {x.device})")
    return bool(use_pallas)


def sfc_keys_op(grid: torch.Tensor, *, curve: str = "hilbert", bits: int = 10,
                use_pallas: Optional[bool] = None) -> torch.Tensor:
    """(n, 3) integer grid coords -> (n,) int64 keys."""
    if use_kernel(grid, use_pallas):
        keys = sfc_keys_cuda(grid.to(torch.int32).contiguous(), curve=curve,
                             bits=bits)
        return keys.to(torch.int64)
    fn = ref.hilbert_keys_ref if curve == "hilbert" else ref.morton_keys_ref
    return fn(grid, bits)


def ksection_histogram_op(keys: torch.Tensor, weights: torch.Tensor,
                          cuts: torch.Tensor, *,
                          use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Per-round k-section histogram: float32 weight strictly below each
    of the (m,) candidate cuts (any order).  Exact on integer weights
    either way, so the search is identical across implementations."""
    if use_kernel(keys, use_pallas):
        f32 = torch.float32
        return ksection_hist_cuda(keys.to(f32).contiguous(),
                                  weights.to(f32).contiguous(),
                                  cuts.to(f32).contiguous())
    return ref.ksection_histogram_ref(keys, weights, cuts)


def fem_matvec_op(tets: torch.Tensor, kel: torch.Tensor, u: torch.Tensor,
                  n_out: int, *, use_pallas: Optional[bool] = None
                  ) -> torch.Tensor:
    """P1 element matvec: (C, 4) slot ids and (C, 4, 4) element matrices
    against a (V,) vertex vector -> (n_out,) accumulated contributions.
    Kernel and plain version differ in summation order only."""
    if use_kernel(u, use_pallas):
        return fem_matvec_cuda(tets.to(torch.int32).contiguous(),
                               kel.to(torch.float32).contiguous(),
                               u.contiguous(), n_out)
    return ref.fem_matvec_kel_ref(tets, kel, u, n_out)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
