"""Mamba-2 (SSD, state-space duality) block -- arXiv:2405.21060.
Counterpart of ``repro/models/ssm.py``.

Chunked SSD: the sequence splits into chunks of ``ssm_chunk`` tokens;
inside a chunk the output is a masked quadratic form (plain large
products: ``torch.einsum`` / ``torch.matmul``, as the reference leaves
them to XLA outside any kernel), and across chunks a short recurrence
carries the per-chunk states (h, dstate, p) -- the reference's
``lax.scan`` becomes a loop over the chunks.  Decode is one step of the
recurrence on an O(1) state.

ngroups = 1 (B / C shared across heads) and a depthwise causal conv of
width ``ssm_conv`` on (x, B, C), as in the reference.  ``Mamba2`` holds
the reference's parameter layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from .config import ModelConfig
from .layers import dense_param, kept, matmul_f32

F32 = torch.float32


@dataclasses.dataclass
class SSMCache:
    state: torch.Tensor    # (b, h, dstate, p) float32
    conv: torch.Tensor     # (b, conv_dim, kconv - 1) the last conv inputs


class Mamba2(nn.Module):
    """``in_proj`` (d, 2 d_in + 2 ds + h), the depthwise conv (``conv_w``
    (conv_dim, kconv), ``conv_b``), float32 ``A_log``, ``D`` and
    ``dt_bias`` (h,), ``norm_w`` (d_in,) and ``out_proj`` (d_in, d): the
    reference's ``init_mamba2``, drawn from ``gen`` (its fixed-valued
    leaves are set whatever ``gen``)."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        d, d_in, h, ds = cfg.d_model, cfg.ssm_inner, cfg.ssm_heads, \
            cfg.ssm_state
        conv_dim = d_in + 2 * ds
        dt = cfg.p_dtype
        self.in_proj = dense_param((d, 2 * d_in + 2 * ds + h), dt, device,
                                   gen)
        self.conv_w = dense_param((conv_dim, cfg.ssm_conv), dt, device, gen,
                                  scale=0.1)
        self.conv_b = kept(torch.zeros(conv_dim, dtype=dt, device=device))
        self.A_log = kept(torch.log(torch.linspace(1.0, 16.0, h, dtype=F32,
                                                    device=device)))
        self.D = kept(torch.ones(h, dtype=F32, device=device))
        self.dt_bias = kept(torch.zeros(h, dtype=F32, device=device))
        self.norm_w = kept(torch.ones(d_in, dtype=dt, device=device))
        self.out_proj = dense_param((d_in, d), dt, device, gen)


def _split_proj(zxd: torch.Tensor, cfg: ModelConfig):
    d_in, ds = cfg.ssm_inner, cfg.ssm_state
    return (zxd[..., :d_in], zxd[..., d_in:2 * d_in + 2 * ds],
            zxd[..., 2 * d_in + 2 * ds:])


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv along the sequence, float32: x (b, s, c),
    w (c, k) -> out[:, t] = sum_j w[:, j] x[:, t - (k - 1) + j] + bias."""
    s, k = x.shape[1], w.shape[1]
    xp = torch.nn.functional.pad(x.to(F32), (0, 0, k - 1, 0))
    wf = w.to(F32)
    out = xp[:, 0:s] * wf[:, 0]
    for j in range(1, k):
        out = out + xp[:, j:j + s] * wf[:, j]
    return out + bias.to(F32)


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor
                   ) -> torch.Tensor:
    yz = y.to(F32) * torch.nn.functional.silu(z.to(F32))
    var = (yz * yz).mean(dim=-1, keepdim=True)
    return yz * torch.rsqrt(var + 1e-6) * w.to(F32)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """segsum(x)[..., i, j] = sum_{j < l <= i} x[..., l] (lower triangle,
    -inf above): a difference of cumulative sums, as the reference takes
    it."""
    L = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, -math.inf)


def ssd_forward(x_h: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD, float32.  x_h (b, s, h, p); dt (b, s, h) after the
    softplus; A (h,); B / C (b, s, dstate).  Returns (y (b, s, h, p),
    final state (b, h, dstate, p)).

    A sequence is padded to a multiple of ``chunk`` with dt = 0, which
    adds nothing to the output or the state (the caller's dt is already
    through its softplus, so the zeros stay zeros)."""
    b, s_orig, h, p = x_h.shape
    pad = (-s_orig) % chunk
    if pad:
        x_h = torch.nn.functional.pad(x_h, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    s = x_h.shape[1]
    ds = B.shape[-1]
    nc, L = s // chunk, chunk
    xc = x_h.reshape(b, nc, L, h, p)
    dtc = dt.reshape(b, nc, L, h)
    Bc = B.reshape(b, nc, L, ds)
    Cc = C.reshape(b, nc, L, ds)
    dA = dtc * A                                     # (b, nc, L, h), A < 0

    # within a chunk: Y[i] = sum_{j <= i} C_i.B_j exp(seg(i, j)) dt_j x_j
    decay = torch.exp(_segsum(dA.movedim(-1, -2)))   # (b, nc, h, L, L)
    cb = torch.matmul(Cc, Bc.transpose(-1, -2))      # (b, nc, L, L)
    att = cb[:, :, None] * decay
    xdt = xc * dtc[..., None]                        # (b, nc, L, h, p)
    y = torch.einsum("bchij,bcjhp->bcihp", att, xdt)
    del decay, att

    # chunk states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
    cum = torch.cumsum(dA, dim=2)                    # (b, nc, L, h)
    w = dtc * torch.exp(cum[:, :, -1:, :] - cum)
    S = torch.einsum("bcjs,bcjhp->bchsp", Bc, xc * w[..., None])
    total = torch.exp(cum[:, :, -1, :])              # (b, nc, h)

    # across chunks: the state before chunk c, then S' = S exp(sum dA) + S_c
    state = (torch.zeros((b, h, ds, p), dtype=F32, device=x_h.device)
             if init_state is None else init_state.to(F32))
    before = []
    for c in range(nc):
        before.append(state)
        state = state * total[:, c, :, None, None] + S[:, c]
    S_prev = torch.stack(before, dim=1)              # (b, nc, h, ds, p)

    # Y_i += C_i . S_prev exp(cum_i)
    y_inter = torch.einsum("bcis,bchsp->bcihp", Cc, S_prev)
    y = y + y_inter * torch.exp(cum)[..., None]
    return y.reshape(b, s, h, p)[:, :s_orig], state


def mamba2_apply(mixer: Mamba2, x: torch.Tensor, cfg: ModelConfig, *,
                 return_cache: bool = False):
    """Full-sequence forward, x (b, s, d_model) -> (b, s, d_model) in
    ``act_dtype``.  ``return_cache=True`` also returns the ``SSMCache``
    after the last token (prefill seeding): the final state and the last
    ``kconv - 1`` conv inputs rounded to ``act_dtype``."""
    b, s, _ = x.shape
    h, p, ds, d_in = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, \
        cfg.ssm_inner
    zxd = matmul_f32(x, mixer.in_proj)
    z, xbc_raw, dt = _split_proj(zxd, cfg)
    xbc = torch.nn.functional.silu(causal_conv(xbc_raw, mixer.conv_w,
                                               mixer.conv_b))
    x_h = xbc[..., :d_in].reshape(b, s, h, p)
    B, C = xbc[..., d_in:d_in + ds], xbc[..., d_in + ds:]
    dt = torch.nn.functional.softplus(dt.to(F32) + mixer.dt_bias)
    A = -torch.exp(mixer.A_log)
    y, final = ssd_forward(x_h, dt, A, B, C, cfg.ssm_chunk)
    y = y + mixer.D[None, None, :, None] * x_h
    y = _gated_rmsnorm(y.reshape(b, s, h * p), z, mixer.norm_w)
    out = matmul_f32(y.to(cfg.act_dtype), mixer.out_proj).to(cfg.act_dtype)
    if return_cache:
        kc = cfg.ssm_conv - 1
        tail = xbc_raw[:, s - kc:, :].movedim(1, 2).to(cfg.act_dtype)
        return out, SSMCache(final, tail)
    return out


def mamba2_decode(mixer: Mamba2, x: torch.Tensor, cfg: ModelConfig,
                  cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """One token, x (b, 1, d_model) -> (out (b, 1, d_model), the next
    cache).  The next conv window is float32 (the reference's concatenate
    of the ``act_dtype`` window and the float32 input promotes)."""
    b = x.shape[0]
    h, p, ds, d_in = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, \
        cfg.ssm_inner
    z, xbc, dt = _split_proj(matmul_f32(x, mixer.in_proj)[:, 0], cfg)
    conv_in = torch.cat([cache.conv.to(F32), xbc[:, :, None]], dim=2)
    xbc_c = (conv_in * mixer.conv_w.to(F32)).sum(-1) + mixer.conv_b.to(F32)
    xbc_c = torch.nn.functional.silu(xbc_c)
    x_in = xbc_c[..., :d_in].reshape(b, h, p)
    B, C = xbc_c[..., d_in:d_in + ds], xbc_c[..., d_in + ds:]
    dt1 = torch.nn.functional.softplus(dt.to(F32) + mixer.dt_bias)  # (b, h)
    dA = torch.exp(dt1 * -torch.exp(mixer.A_log))
    S = (cache.state * dA[..., None, None]
         + B[:, None, :, None] * (dt1[..., None] * x_in)[:, :, None, :])
    y = torch.matmul(C[:, None, None, :], S)[:, :, 0]              # (b, h, p)
    y = y + mixer.D[None, :, None] * x_in
    y = _gated_rmsnorm(y.reshape(b, h * p), z, mixer.norm_w)
    out = matmul_f32(y.to(cfg.act_dtype), mixer.out_proj).to(cfg.act_dtype)
    return out[:, None], SSMCache(S, conv_in[:, :, 1:])


def init_ssm_cache(cfg: ModelConfig, batch: int, *, device,
                   n_layers: Optional[int] = None) -> SSMCache:
    """Zero state and conv window; with ``n_layers``, stacked over the
    layers on a leading axis (the serving state's layout)."""
    lead = () if n_layers is None else (n_layers,)
    conv_dim = cfg.ssm_inner + 2 * cfg.ssm_state
    return SSMCache(
        state=torch.zeros(lead + (batch, cfg.ssm_heads, cfg.ssm_state,
                                  cfg.ssm_headdim), dtype=F32, device=device),
        conv=torch.zeros(lead + (batch, conv_dim, cfg.ssm_conv - 1),
                         dtype=cfg.act_dtype, device=device))
