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
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from .config import ModelConfig
from .layers import dense_param, gelu, matmul_f32

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
        fixed = lambda t: nn.Parameter(t, requires_grad=False)  # noqa: E731
        self.in_x = dense_param((d, w), dt, device, gen)
        self.in_gate = dense_param((d, w), dt, device, gen)
        self.conv_w = dense_param((w, CONV), dt, device, gen, scale=0.1)
        self.conv_b = fixed(torch.zeros(w, dtype=dt, device=device))
        self.w_r = dense_param((w, w), dt, device, gen)
        self.b_r = fixed(torch.zeros(w, dtype=F32, device=device))
        self.w_i = dense_param((w, w), dt, device, gen)
        self.b_i = fixed(torch.zeros(w, dtype=F32, device=device))
        lin = torch.linspace(0.9, 0.999, w, dtype=F32, device=device)
        self.lam = fixed(torch.log(lin / (1 - lin)))
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


def _gates(block: RGLRU, xc: torch.Tensor):
    """(a_t, sqrt(1 - a_t^2) i_t x_t) from the conv output, float32."""
    xf = xc.to(F32)
    r = torch.sigmoid(torch.matmul(xf, block.w_r.to(F32)) + block.b_r)
    i = torch.sigmoid(torch.matmul(xf, block.w_i.to(F32)) + block.b_i)
    log_a_base = -torch.nn.functional.softplus(-block.lam)
    a = torch.exp(_C * r * log_a_base)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * (i * xf)


def rglru_block_apply(block: RGLRU, x: torch.Tensor, cfg: ModelConfig, *,
                      return_cache: bool = False):
    """Full-sequence recurrent block, x (b, s, d) -> (b, s, d) in
    ``act_dtype``.  ``return_cache=True`` also returns the ``RGLRUCache``
    after the last token: the last state and the last three conv inputs
    rounded to ``act_dtype``."""
    s = x.shape[1]
    xb = matmul_f32(x, block.in_x)
    gate = gelu(matmul_f32(x, block.in_gate))
    w = block.conv_w.to(F32)
    xp = torch.nn.functional.pad(xb, (0, 0, CONV - 1, 0))
    xc = xp[:, 0:s] * w[:, 0]
    for j in range(1, CONV):
        xc = xc + xp[:, j:j + s] * w[:, j]
    xc = xc + block.conv_b.to(F32)
    a, bterm = _gates(block, xc)
    h = rglru_scan(bterm, a)
    y = (h * gate).to(cfg.act_dtype)
    out = matmul_f32(y, block.out).to(cfg.act_dtype)
    if return_cache:
        tail = xb[:, s - (CONV - 1):, :].movedim(1, 2).to(cfg.act_dtype)
        return out, RGLRUCache(h[:, -1], tail)
    return out


def rglru_block_decode(block: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                       cache: RGLRUCache) -> Tuple[torch.Tensor, RGLRUCache]:
    """One token, x (b, 1, d) -> (out (b, 1, d), the next cache).  The
    next conv window is float32, as the reference's concatenate promotes
    it."""
    xb = matmul_f32(x, block.in_x)[:, 0]
    gate = gelu(matmul_f32(x, block.in_gate))[:, 0]
    conv_in = torch.cat([cache.conv.to(F32), xb[:, :, None]], dim=2)
    xc = (conv_in * block.conv_w.to(F32)).sum(-1) + block.conv_b.to(F32)
    a, bterm = _gates(block, xc)
    h = a * cache.h + bterm
    y = (h * gate).to(cfg.act_dtype)
    out = matmul_f32(y, block.out).to(cfg.act_dtype)
    return out[:, None], RGLRUCache(h, conv_in[:, :, 1:])


def init_rglru_cache(cfg: ModelConfig, batch: int, *, device) -> RGLRUCache:
    w = cfg.lru_width or cfg.d_model
    return RGLRUCache(
        h=torch.zeros((batch, w), dtype=F32, device=device),
        conv=torch.zeros((batch, w, CONV - 1), dtype=cfg.act_dtype,
                         device=device))
