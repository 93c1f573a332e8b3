"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).
Counterpart of ``repro/models/rglru.py``.

Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_r x_t + b_r)           recurrence gate
    i_t = sigmoid(W_i x_t + b_i)           input gate
    a_t = a ^ (c * r_t),  a = sigmoid(Lambda)   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

The block wraps it with in / gate projections and a depthwise causal conv
of width 4.  The recurrence over a prompt is a log-depth scan in plain
torch on the reference's combine ``(a_l a_r, b_l a_r + b_r)`` (the
reference's ``associative_scan``): ceil(log2 s) passes, not one launch a
token.  Decode is one step on the O(1) state.

On a model axis (``model=``, the model group's ``Comm``) the reference's
rules put "mlp" on the recurrent width: a rank holds its columns of
``in_x`` / ``in_gate``, its channels of the conv, its rows of ``w_r`` /
``w_i`` and of ``out``; ``b_r``, ``b_i`` and ``lam`` are replicated.
The conv, the gates and the scan are per channel, so each rank runs them
on its channels, except the gates' products: ``xc @ w_r`` over the
rank's rows is a partial sum of every channel's pre-activation, summed
over the group in float32 and cut to the rank's channels
(``reduce_scatter_to_model``).  The replicated vectors enter the rank's
channels through ``copy_to_model`` (their gradients summed over the
group), and ``out`` sums the ranks' partial products in float32 (the
reference has no ``shard_map`` branch here).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from .config import ModelConfig
from .layers import (copy_to_model, dense_param, gelu, kept, matmul_f32,
                     on_model_axis, reduce_scatter_to_model, row_parallel)

F32 = torch.float32
_C = 8.0
CONV = 4        # the block's conv width (the reference's constant)


@dataclasses.dataclass
class RGLRUCache:
    h: torch.Tensor        # (b, w) float32 recurrent state
    conv: torch.Tensor     # (b, w, CONV - 1) the last conv inputs


class RGLRU(nn.Module):
    """``in_x``, ``in_gate`` (d, w), the conv (``conv_w`` (w, 4),
    ``conv_b``), the gates ``w_r``, ``w_i`` (w, w) with float32 biases
    ``b_r``, ``b_i``, float32 ``lam`` (w,) and ``out`` (w, d): the
    reference's ``init_rglru_block``, drawn from ``gen`` (its fixed-valued
    leaves are set whatever ``gen``)."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        d, w, dt = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.p_dtype
        self.in_x = dense_param((d, w), dt, device, gen)
        self.in_gate = dense_param((d, w), dt, device, gen)
        self.conv_w = dense_param((w, CONV), dt, device, gen, scale=0.1)
        self.conv_b = kept(torch.zeros(w, dtype=dt, device=device))
        self.w_r = dense_param((w, w), dt, device, gen)
        self.b_r = kept(torch.zeros(w, dtype=F32, device=device))
        self.w_i = dense_param((w, w), dt, device, gen)
        self.b_i = kept(torch.zeros(w, dtype=F32, device=device))
        lin = torch.linspace(0.9, 0.999, w, dtype=F32, device=device)
        self.lam = kept(torch.log(lin / (1 - lin)))
        self.out = dense_param((w, d), dt, device, gen)


def rglru_scan(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + x_t along axis 1 (h_{-1} = 0), x / a (b, s, w)
    float32: a Hillis-Steele scan of the combine (a_l a_r, b_l a_r +
    b_r), ceil(log2 s) passes."""
    s, off = x.shape[1], 1
    while off < s:
        a_r, b_r = a[:, off:], x[:, off:]
        x = torch.cat([x[:, :off], x[:, :-off] * a_r + b_r], dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a_r], dim=1)
        off *= 2
    return x


def _gates(block: RGLRU, xc: torch.Tensor, model=None):
    """(a_t, sqrt(1 - a_t^2) i_t x_t) from the conv output, float32.  With
    the model group ``model``, ``xc`` and the gates' rows are this rank's
    channels (the module docstring)."""
    xf = xc.to(F32)
    pre = [torch.matmul(xf, w.to(F32)) for w in (block.w_r, block.w_i)]
    vecs = (block.b_r, block.b_i, block.lam)
    if model is not None:
        pre = reduce_scatter_to_model(torch.stack(pre), model, xf.dim())
        n = xf.shape[-1]
        vecs = [copy_to_model(t, model).narrow(0, model.rank * n, n)
                for t in vecs]
    b_r, b_i, lam = vecs
    r = torch.sigmoid(pre[0] + b_r)
    i = torch.sigmoid(pre[1] + b_i)
    log_a_base = -torch.nn.functional.softplus(-lam)
    a = torch.exp(_C * r * log_a_base)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * (i * xf)


def rglru_block_apply(block: RGLRU, x: torch.Tensor, cfg: ModelConfig, *,
                      return_cache: bool = False, model=None):
    """Full-sequence recurrent block, x (b, s, d) -> (b, s, d) in
    ``act_dtype``.  ``return_cache=True`` also returns the ``RGLRUCache``
    after the last token: the last state and the last three conv inputs
    rounded to ``act_dtype``.  ``model``: the model group, where the
    block holds this rank's slices (the module docstring)."""
    s = x.shape[1]
    tp = on_model_axis(block.in_x.shape[1], cfg.lru_width or cfg.d_model,
                       model)
    model = model if tp else None
    if tp:
        x = copy_to_model(x, model)
    xb = matmul_f32(x, block.in_x)
    gate = gelu(matmul_f32(x, block.in_gate))
    w = block.conv_w.to(F32)
    xp = torch.nn.functional.pad(xb, (0, 0, CONV - 1, 0))
    xc = xp[:, 0:s] * w[:, 0]
    for j in range(1, CONV):
        xc = xc + xp[:, j:j + s] * w[:, j]
    xc = xc + block.conv_b.to(F32)
    a, bterm = _gates(block, xc, model)
    h = rglru_scan(bterm, a)
    y = (h * gate).to(cfg.act_dtype)
    out = row_parallel(y, block.out, cfg, model, shardmap=False)
    if return_cache:
        tail = xb[:, s - (CONV - 1):, :].movedim(1, 2).to(cfg.act_dtype)
        return out, RGLRUCache(h[:, -1], tail)
    return out


def rglru_block_decode(block: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                       cache: RGLRUCache, model=None
                       ) -> Tuple[torch.Tensor, RGLRUCache]:
    """One token, x (b, 1, d) -> (out (b, 1, d), the next cache).  The
    next conv window is float32, as the reference's concatenate promotes
    it.  ``model``: the model group, where the block holds this rank's
    slices and ``cache`` its channels (as ``rglru_block_apply``)."""
    tp = on_model_axis(block.in_x.shape[1], cfg.lru_width or cfg.d_model,
                       model)
    model = model if tp else None
    if tp:
        x = copy_to_model(x, model)
    xb = matmul_f32(x, block.in_x)[:, 0]
    gate = gelu(matmul_f32(x, block.in_gate))[:, 0]
    conv_in = torch.cat([cache.conv.to(F32), xb[:, :, None]], dim=2)
    xc = (conv_in * block.conv_w.to(F32)).sum(-1) + block.conv_b.to(F32)
    a, bterm = _gates(block, xc, model)
    h = a * cache.h + bterm
    y = (h * gate).to(cfg.act_dtype)
    out = row_parallel(y, block.out, cfg, model, shardmap=False)
    return out[:, None], RGLRUCache(h, conv_in[:, :, 1:])


def init_rglru_cache(cfg: ModelConfig, batch: int, *, device, m: int = 1
                     ) -> RGLRUCache:
    """Zero state; ``m``: a model rank's channels of ``m``."""
    w = (cfg.lru_width or cfg.d_model) // m
    return RGLRUCache(
        h=torch.zeros((batch, w), dtype=F32, device=device),
        conv=torch.zeros((batch, w, CONV - 1), dtype=cfg.act_dtype,
                         device=device))
