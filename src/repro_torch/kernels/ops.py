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

from ..segment import fixed_order
from . import ref
from .fem_matvec import build_element_plan, fem_matvec_cuda
from .flash_attention import flash_attention_cuda
from .ksection_hist import ksection_hist_cuda
from .prefix_scan import exclusive_scan_cuda
from .segment_sum import segment_sum_cuda
from .serve_prefill import packed_attention_cuda
from .sfc_keys import sfc_keys_cuda

#: kernel name -> wrapper; each wrapper carries a ``launches`` count
KERNELS = {"sfc_keys": sfc_keys_cuda, "ksection_hist": ksection_hist_cuda,
           "fem_matvec": fem_matvec_cuda, "prefix_scan": exclusive_scan_cuda,
           "flash_attention": flash_attention_cuda,
           "serve_prefill": packed_attention_cuda,
           "segment_sum": segment_sum_cuda}


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


def exclusive_scan_op(x: torch.Tensor, *,
                      use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Exclusive prefix sum (Algorithm 1's S_i) over (n,), any n.  The
    kernel works in float32; the plain version in the input's type."""
    if use_kernel(x, use_pallas):
        return exclusive_scan_cuda(x.to(torch.float32).contiguous())
    return ref.exclusive_scan_ref(x)


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
    Kernel and plain version differ in summation order only.  One call:
    the kernel's plan is built for it and dropped (``ElementOperator``
    keeps one for many calls)."""
    return ElementOperator(tets, kel, n_out, use_pallas=use_pallas).apply(u)


class ElementOperator:
    """The element matvec of one fixed set of elements, for many calls:
    ``apply(u)`` is ``fem_matvec_op(tets, kel, u, n_out)``.

    On the kernel's path the plan (``fem_matvec.build_element_plan``) is
    built here, once, on the elements in the order given (the mesh's own
    order keeps a chunk's elements together), and every ``apply``
    launches the kernel on it.  On the plain path ``apply`` runs
    ``ref.fem_matvec_kel_ref`` on the sum's fixed order: ``order`` where
    the caller keeps one for these ids (``P1Elements.order``), else built
    once here (``segment.fixed_order``: on CUDA tensors only)."""

    def __init__(self, tets: torch.Tensor, kel: torch.Tensor, n_out: int, *,
                 use_pallas: Optional[bool] = None, order=None):
        self.n_out, self.plan, self.order = n_out, None, None
        if not use_kernel(kel, use_pallas):
            self.tets, self.kel = tets, kel
            self.order = (order if order is not None
                          else fixed_order(tets.reshape(-1), n_out))
            return
        self.tets = tets.to(torch.int32).contiguous()
        self.kel = kel.to(torch.float32).contiguous()
        self.plan = build_element_plan(self.tets, n_out)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        if self.plan is not None:
            return fem_matvec_cuda(self.tets, self.kel, u.contiguous(),
                                   self.n_out, plan=self.plan)
        return ref.fem_matvec_kel_ref(self.tets, self.kel, u, self.n_out,
                                      self.order)


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: Optional[int] = None,
                       use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Blocked attention: q (b, hq, s, d), k / v (b, hkv, s_kv, d) with
    the kv heads unexpanded (query head h reads kv head h // (hq // hkv)).
    Any s runs on either path; s_kv != s (cross-attention) without a mask
    only."""
    if use_kernel(q, use_pallas):
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window)
    return ref.mha_ref(q, k, v, causal=causal, window=window)


def packed_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seg: torch.Tensor, *, softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Segment-masked causal attention over one packed prefill buffer:
    q (hq, C, d), k / v (hkv, C, d) unexpanded, seg (C,) request ids with
    -1 = pad.  Rows with no visible key are exactly 0 on either path."""
    if use_kernel(q, use_pallas):
        return packed_attention_cuda(q.contiguous(), k.contiguous(),
                                     v.contiguous(),
                                     seg.to(torch.int32).contiguous(),
                                     softcap=softcap, scale=scale)
    return ref.packed_attention_ref(q, k, v, seg, softcap=softcap,
                                    scale=scale)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        for variant in getattr(fn, "variants", {}):
            fn.variants[variant] = 0
