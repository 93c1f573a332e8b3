"""Error-feedback int8 gradient compression.  Counterpart of
``repro/train/compress.py``.

``ef_compress_grads`` quantizes each gradient to int8 with a per-tensor
absmax scale after adding the error carried from the previous step, and
carries the new quantization error (EF-SGD), so the compressed direction
is unbiased over time.  ``compressed_psum`` is the wire side: each rank
quantizes its tensor, the int8 payloads and the scales are all-gathered
over a ``distributed.Comm``, and every rank dequantizes and sums them --
a quarter of a float32 all-reduce's bytes.  Gradients and errors are
dicts keyed by parameter name.

The reference quantizes each leaf of its parameter tree with one scale,
and its dense, MoE, VLM, SSM and encoder-decoder layers are stacked over
depth: there one leaf holds a parameter of every layer.  Given the model
config, ``ef_compress_grads`` groups the port's per-layer tensors the
same way (``scale_groups``), so both packages quantize to the same
bits; the hybrid's layers are a list in the reference, one leaf each.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

from .optimizer import named

F32 = torch.float32


class CompressState(NamedTuple):
    err: Dict[str, torch.Tensor]    # carried quantization errors, float32


def init_compress_state(params: Mapping[str, torch.Tensor]) -> CompressState:
    """Zero errors beside each tensor of ``params`` (a model or a dict)."""
    return CompressState({n: torch.zeros(p.shape, dtype=F32, device=p.device)
                          for n, p in named(params).items()})


def _quantize(x: torch.Tensor, amax: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 ``round(x / scale)`` clipped to +-127, with ``scale =
    max|x| / 127 + 1e-30`` (float32; rounding half to even, as
    ``jnp.round``); ``amax`` replaces max|x| (a group's)."""
    amax = torch.max(torch.abs(x)) if amax is None else amax
    scale = amax / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def scale_groups(names, cfg=None) -> List[List[str]]:
    """The tensors that share one quantization scale: with ``cfg`` of a
    family whose layers the reference stacks, a parameter's copies in
    every layer of a stack (``layers.0.attn.wq``, ``layers.1.attn.wq``,
    ...); otherwise each tensor alone."""
    if cfg is None or cfg.family == "hybrid":
        return [[n] for n in names]
    groups: Dict[str, List[str]] = {}
    for n in names:
        key = ".".join("*" if p.isdigit() else p for p in n.split("."))
        groups.setdefault(key, []).append(n)
    return list(groups.values())


def ef_compress_grads(grads: Mapping[str, torch.Tensor],
                      state: Optional[CompressState], cfg=None
                      ) -> Tuple[Dict[str, torch.Tensor], CompressState]:
    """Quantize ``grads`` to int8 with error feedback: the dequantized
    gradients (in each gradient's dtype: what the optimizer consumes) and
    the new error state.  ``cfg`` (the model's config) shares one scale
    over a stacked parameter's layers, as the reference's tree does."""
    if state is None:
        state = init_compress_state(grads)
    new_g, new_e = {}, {}
    for group in scale_groups(list(grads), cfg):
        corrected = {n: grads[n].to(F32) + state.err[n] for n in group}
        amax = torch.max(torch.stack([torch.max(torch.abs(c))
                                      for c in corrected.values()]))
        for n, c in corrected.items():
            q, scale = _quantize(c, amax)
            deq = q.to(F32) * scale
            new_g[n] = deq.to(grads[n].dtype)
            new_e[n] = c - deq
    return new_g, CompressState(new_e)


def compressed_psum(x: torch.Tensor, comm) -> torch.Tensor:
    """The sum of ``x`` over ``comm``'s ranks with int8 on the wire:
    quantize here, all-gather the payloads and the scales, dequantize and
    sum (float32).  Every rank gets the same result."""
    q, scale = _quantize(x.to(F32))
    qs = comm.all_gather(q[None])                  # (p, ...) int8
    ss = comm.all_gather(scale.reshape(1))         # (p,)
    return torch.tensordot(ss, qs.to(F32), dims=([0], [0]))
