"""The dense and MoE decoder LM: an ``nn.ModuleList`` of pre-norm blocks
(attention + SwiGLU MLP, or attention + MoE) between the embedding and
the final norm.  Counterpart of the dense / MoE part of
``repro/models/transformer.py``, whose layers are stacked for
``lax.scan``; here they are a Python loop, and ``DecoderLM``'s
constructor takes the place of ``init_decoder``.  The SSM, hybrid and
encoder-decoder families wait (ROADMAP.md, queue 1, item 10).
"""
from __future__ import annotations

import torch
from torch import nn

from .config import ModelConfig
from .layers import (MLP, Attention, Embedding, mlp_apply, ones_param,
                     rmsnorm)
from .moe import MoE, moe_apply


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
