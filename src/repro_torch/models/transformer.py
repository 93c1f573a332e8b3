"""The dense decoder LM: an ``nn.ModuleList`` of pre-norm blocks
(attention + SwiGLU MLP) between the embedding and the final norm.
Counterpart of the dense part of ``repro/models/transformer.py``, whose
layers are stacked for ``lax.scan``; here they are a Python loop, and
``DecoderLM``'s constructor takes the place of ``init_decoder``.  The
MoE, SSM, hybrid and encoder-decoder families wait (ROADMAP.md, queue 1,
item 10).
"""
from __future__ import annotations

from torch import nn

from .config import ModelConfig
from .layers import MLP, Attention, Embedding, ones_param


class Block(nn.Module):
    """One decoder block: ``ln_attn``, ``attn``, ``ln_mlp``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.ln_attn = ones_param(cfg.d_model, cfg.p_dtype, device)
        self.attn = Attention(cfg, device, gen)
        self.ln_mlp = ones_param(cfg.d_model, cfg.p_dtype, device)
        self.mlp = MLP(cfg, device, gen)


class DecoderLM(nn.Module):
    """``embed`` (token table and LM head), ``layers``, ``ln_f``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        if cfg.n_experts > 0:
            raise NotImplementedError(
                "MoE blocks are not ported yet (ROADMAP.md, queue 1, item 10)")
        self.embed = Embedding(cfg, device, gen)
        self.layers = nn.ModuleList(Block(cfg, device, gen)
                                    for _ in range(cfg.n_layers))
        self.ln_f = ones_param(cfg.d_model, cfg.p_dtype, device)

