"""The LMs: an ``nn.ModuleList`` of pre-norm blocks between the
embedding and the final norm.  Counterpart of the decoder, SSM and
hybrid parts of ``repro/models/transformer.py``:

* ``DecoderLM`` (dense and MoE): attention + SwiGLU MLP, or attention +
  MoE, a block;
* ``SSMLM`` (mamba2): ``ln`` and a ``Mamba2`` mixer a block;
* ``HybridLM`` (recurrentgemma): the repeating ``block_pattern`` of
  RG-LRU and local-attention blocks (``hybrid_layer_kinds``), each with
  ``ln_mix``, ``ln_mlp`` and its own GeGLU ``mlp``.

The reference stacks the decoder's and the SSM's layers for
``lax.scan``; here every family is a Python loop, and each LM's
constructor takes the place of the reference's ``init_*``.  The
encoder-decoder family waits (ROADMAP.md, queue 1, item 10).
"""
from __future__ import annotations

import torch
from torch import nn

from .config import ModelConfig
from .layers import (MLP, Attention, Embedding, mlp_apply, ones_param,
                     rmsnorm)
from .moe import MoE, moe_apply
from .rglru import RGLRU
from .ssm import Mamba2


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
