"""The LMs: an ``nn.ModuleList`` of pre-norm blocks between the
embedding and the final norm.  Counterpart of
``repro/models/transformer.py``:

* ``DecoderLM`` (dense, MoE and the VLM): attention + SwiGLU MLP, or
  attention + MoE, a block; the VLM's stub front end prepends patch
  embeddings to the token embeddings (``decoder_inputs``) and rotates
  with M-RoPE (``decoder_hidden``);
* ``SSMLM`` (mamba2): ``ln`` and a ``Mamba2`` mixer a block;
* ``HybridLM`` (recurrentgemma): the repeating ``block_pattern`` of
  RG-LRU and local-attention blocks (``hybrid_layer_kinds``), each with
  ``ln_mix``, ``ln_mlp`` and its own GeGLU ``mlp``;
* ``EncDecLM`` (whisper): ``enc_layers`` of ``EncBlock`` over stub frame
  embeddings (``encoder_apply``: non-causal, no RoPE, sinusoidal
  positions) and ``dec_layers`` of ``DecBlock`` (self-attention,
  cross-attention to the encoder, plain GELU MLP).

The reference stacks the decoder's and the SSM's layers for
``lax.scan``; here every family is a Python loop, and each LM's
constructor takes the place of the reference's ``init_*``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .config import ModelConfig
from .layers import (MLP, Attention, Embedding, attention_apply,
                     embed_tokens, mlp_apply, ones_param, rmsnorm)
from .moe import MoE, moe_apply
from .rglru import RGLRU
from .ssm import Mamba2

F32 = torch.float32


class Block(nn.Module):
    """One decoder block: ``ln_attn``, ``attn``, ``ln_mlp`` and ``mlp``,
    or ``moe`` in place of ``mlp`` when ``cfg.n_experts > 0`` (the
    reference's ``init_block``)."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.ln_attn = ones_param(cfg.d_model, cfg.p_dtype, device)
        self.attn = Attention(cfg, device, gen)
        self.ln_mlp = ones_param(cfg.d_model, cfg.p_dtype, device)
        if cfg.n_experts > 0:
            self.moe = MoE(cfg, device, gen)
        else:
            self.mlp = MLP(cfg, device, gen)


def block_ffn(block: Block, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """``x`` plus the block's MLP, or MoE, of ``rmsnorm(x)``: the second
    half of every block, for prefill, decode and packed prefill alike.
    The MoE's aux loss is a training term and is dropped here."""
    h = rmsnorm(x, block.ln_mlp)
    if hasattr(block, "moe"):
        y, _ = moe_apply(block.moe, h, cfg)
    else:
        y = mlp_apply(block.mlp, h, cfg)
    return x + y


class DecoderLM(nn.Module):
    """``embed`` (token table and LM head), ``layers``, ``ln_f``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.embed = Embedding(cfg, device, gen)
        self.layers = nn.ModuleList(Block(cfg, device, gen)
                                    for _ in range(cfg.n_layers))
        self.ln_f = ones_param(cfg.d_model, cfg.p_dtype, device)


def decoder_inputs(model: DecoderLM, tokens: torch.Tensor, cfg: ModelConfig,
                   patch_embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """The first hidden state (b, s, d) -- the VLM's patch embeddings (b,
    n_p, d), if given, before the token embeddings -- with its positions
    ``pos`` (b, s) and, for M-RoPE configs, ``pos3`` (3, b, s): the same
    ``arange`` in all three streams, as the reference builds it."""
    x = embed_tokens(model.embed, tokens, cfg)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(cfg.act_dtype), x], dim=1)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    pos3 = None if cfg.mrope_sections is None else pos[None].expand(3, b, s)
    return x, pos, pos3


def decoder_hidden(model: DecoderLM, tokens: torch.Tensor, cfg: ModelConfig,
                   *, pos3: Optional[torch.Tensor] = None,
                   patch_embeds: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The final hidden state (b, s, d) of a causal forward over
    ``patch_embeds`` and ``tokens``; ``pos3`` replaces the M-RoPE streams
    ``decoder_inputs`` builds (distinct (t, h, w) ids of image patches).
    The MoE's aux loss is dropped."""
    x, pos, own3 = decoder_inputs(model, tokens, cfg, patch_embeds)
    pos3 = own3 if pos3 is None else pos3
    for layer in model.layers:
        h = rmsnorm(x, layer.ln_attn)
        x = block_ffn(layer, x + attention_apply(layer.attn, h, cfg, pos=pos,
                                                 pos3=pos3, causal=True), cfg)
    return rmsnorm(x, model.ln_f)


class SSMBlock(nn.Module):
    """``ln`` and ``mixer`` (the reference's stacked ``init_ssm_lm``
    layer)."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.ln = ones_param(cfg.d_model, cfg.p_dtype, device)
        self.mixer = Mamba2(cfg, device, gen)


class SSMLM(nn.Module):
    """``embed``, ``layers`` of ``SSMBlock``, ``ln_f``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.embed = Embedding(cfg, device, gen)
        self.layers = nn.ModuleList(SSMBlock(cfg, device, gen)
                                    for _ in range(cfg.n_layers))
        self.ln_f = ones_param(cfg.d_model, cfg.p_dtype, device)


def hybrid_layer_kinds(cfg: ModelConfig):
    """'rglru' or 'attn' for each layer: ``block_pattern`` repeated."""
    pat = cfg.block_pattern or ("rglru", "rglru", "attn")
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


class HybridBlock(nn.Module):
    """``ln_mix``, ``ln_mlp``, ``mlp`` and ``attn`` or ``rglru`` by the
    layer's kind (the reference's per-layer dict of ``init_hybrid``)."""

    def __init__(self, cfg: ModelConfig, kind: str, device, gen=None):
        super().__init__()
        self.ln_mix = ones_param(cfg.d_model, cfg.p_dtype, device)
        self.ln_mlp = ones_param(cfg.d_model, cfg.p_dtype, device)
        self.mlp = MLP(cfg, device, gen)
        if kind == "attn":
            self.attn = Attention(cfg, device, gen)
        else:
            self.rglru = RGLRU(cfg, device, gen)


class HybridLM(nn.Module):
    """``embed``, ``layers`` of ``HybridBlock`` by
    ``hybrid_layer_kinds``, ``ln_f``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.embed = Embedding(cfg, device, gen)
        self.layers = nn.ModuleList(HybridBlock(cfg, kind, device, gen)
                                    for kind in hybrid_layer_kinds(cfg))
        self.ln_f = ones_param(cfg.d_model, cfg.p_dtype, device)


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper): stub frame embeddings -> encoder; a decoder
# with cross-attention.  Sinusoidal positions (parameter-free, any length).
# ---------------------------------------------------------------------------

def _sinusoid(s: int, d: int, dtype: torch.dtype, device=None
              ) -> torch.Tensor:
    """(s, d) sinusoidal positions: sin on the even columns, cos on the
    odd, computed in float32 and rounded to ``dtype`` as the reference's
    ``_sinusoid``."""
    pos = torch.arange(s, dtype=F32, device=device)[:, None]
    rate = -torch.log(torch.tensor(10000.0, device=device)) / d   # float32
    div = torch.exp(torch.arange(0, d, 2, dtype=F32, device=device) * rate)
    pe = torch.zeros((s, d), dtype=F32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


class EncBlock(nn.Module):
    """``ln_attn``, ``attn`` (non-causal, no RoPE), ``ln_mlp``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.ln_attn = ones_param(cfg.d_model, cfg.p_dtype, device)
        self.attn = Attention(cfg, device, gen)
        self.ln_mlp = ones_param(cfg.d_model, cfg.p_dtype, device)
        self.mlp = MLP(cfg, device, gen)


class DecBlock(nn.Module):
    """``ln_self``, ``self_attn`` (causal, no RoPE), ``ln_cross``,
    ``cross_attn`` (K/V from the encoder's output), ``ln_mlp``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.ln_self = ones_param(cfg.d_model, cfg.p_dtype, device)
        self.self_attn = Attention(cfg, device, gen)
        self.ln_cross = ones_param(cfg.d_model, cfg.p_dtype, device)
        self.cross_attn = Attention(cfg, device, gen)
        self.ln_mlp = ones_param(cfg.d_model, cfg.p_dtype, device)
        self.mlp = MLP(cfg, device, gen)


class EncDecLM(nn.Module):
    """``embed``, ``enc_layers`` (``cfg.enc_layers`` ``EncBlock``s),
    ``dec_layers`` (``cfg.n_layers`` ``DecBlock``s), ``ln_enc``,
    ``ln_f``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.embed = Embedding(cfg, device, gen)
        self.enc_layers = nn.ModuleList(EncBlock(cfg, device, gen)
                                        for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(DecBlock(cfg, device, gen)
                                        for _ in range(cfg.n_layers))
        self.ln_enc = ones_param(cfg.d_model, cfg.p_dtype, device)
        self.ln_f = ones_param(cfg.d_model, cfg.p_dtype, device)


def encoder_apply(model: EncDecLM, frames: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """frames (b, s_enc, d): precomputed embeddings (the reference's stub
    of the conv front end) -> the encoder's output (b, s_enc, d)."""
    b, s, d = frames.shape
    x = frames.to(cfg.act_dtype) + _sinusoid(s, d, cfg.act_dtype,
                                             frames.device)
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    for layer in model.enc_layers:
        h = rmsnorm(x, layer.ln_attn)
        x = x + attention_apply(layer.attn, h, cfg, pos=pos, causal=False,
                                use_rope=False)
        x = x + mlp_apply(layer.mlp, rmsnorm(x, layer.ln_mlp), cfg)
    return rmsnorm(x, model.ln_enc)
