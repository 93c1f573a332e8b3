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

Training: ``decoder_loss``, ``encdec_loss``, ``hybrid_loss`` and
``ssm_loss`` score each family's hidden states (``decoder_hidden``,
``encdec_hidden``, ``hybrid_hidden``, ``ssm_hidden``) with the
sequence-chunked masked cross-entropy ``_masked_ce``; the decoder adds
0.01 of the MoE aux loss.  Where the reference wraps a layer body in
``jax.checkpoint`` under ``cfg.remat`` (decoder, encoder, decoder of the
encoder-decoder, SSM), ``remat`` runs it through
``torch.utils.checkpoint`` while grad is enabled.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .layers import (MLP, Attention, Embedding, attention_apply,
                     embed_tokens, matmul_f32, mlp_apply, ones_param,
                     project_heads, rmsnorm)
from .moe import MoE, moe_apply
from .rglru import RGLRU, rglru_block_apply
from .ssm import Mamba2, mamba2_apply

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


def block_ffn(block: Block, x: torch.Tensor, cfg: ModelConfig, *,
              with_aux: bool = False):
    """``x`` plus the block's MLP, or MoE, of ``rmsnorm(x)``: the second
    half of every block, for prefill, decode, packed prefill and training
    alike.  The MoE's aux loss is a training term: ``with_aux=True``
    returns it too (a float32 zero for an MLP block), else it is
    dropped."""
    h = rmsnorm(x, block.ln_mlp)
    if hasattr(block, "moe"):
        y, aux = moe_apply(block.moe, h, cfg)
    else:
        y = mlp_apply(block.mlp, h, cfg)
        aux = torch.zeros((), dtype=F32, device=x.device)
    return (x + y, aux) if with_aux else x + y


def remat(cfg: ModelConfig, body, *args):
    """``body(*args)``; under ``cfg.remat`` while grad is enabled, through
    ``torch.utils.checkpoint`` (its activations recomputed in the
    backward pass: the reference's ``jax.checkpoint`` of a layer body).
    Serving runs without grad and calls ``body`` as it is."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


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


def block_apply(layer: Block, x: torch.Tensor, cfg: ModelConfig,
                pos: torch.Tensor, pos3: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One causal decoder block over the whole sequence: (x, aux)."""
    h = rmsnorm(x, layer.ln_attn)
    x = x + attention_apply(layer.attn, h, cfg, pos=pos, pos3=pos3,
                            causal=True)
    return block_ffn(layer, x, cfg, with_aux=True)


def decoder_hidden(model: DecoderLM, tokens: torch.Tensor, cfg: ModelConfig,
                   *, pos3: Optional[torch.Tensor] = None,
                   patch_embeds: Optional[torch.Tensor] = None,
                   with_aux: bool = False):
    """The final hidden state (b, s, d) of a causal forward over
    ``patch_embeds`` and ``tokens``; ``pos3`` replaces the M-RoPE streams
    ``decoder_inputs`` builds (distinct (t, h, w) ids of image patches).
    ``with_aux=True`` returns (hidden, aux): the MoE's aux loss summed
    over the layers (float32; 0 without experts), as the reference's
    ``decoder_hidden`` does; else the aux is dropped."""
    x, pos, own3 = decoder_inputs(model, tokens, cfg, patch_embeds)
    pos3 = own3 if pos3 is None else pos3
    aux = torch.zeros((), dtype=F32, device=x.device)
    for layer in model.layers:
        x, a = remat(cfg, block_apply, layer, x, cfg, pos, pos3)
        aux = aux + a
    x = rmsnorm(x, model.ln_f)
    return (x, aux) if with_aux else x


def _masked_ce(head: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is >= 0, in
    ``nc = max(s // loss_chunk, 1)`` sequence chunks of ``cs = s // nc``
    positions (the (b, s, vocab) logits never exist at once).  As in the
    reference, positions past ``nc * cs`` are not scored: s = 200 with
    chunks of 64 scores 198."""
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    b, s, _ = x.shape
    nc = max(s // cfg.loss_chunk, 1)
    cs = s // nc
    num = torch.zeros((), dtype=F32, device=x.device)
    den = torch.zeros((), dtype=F32, device=x.device)
    for ci in range(nc):
        sl = slice(ci * cs, (ci + 1) * cs)
        logits = matmul_f32(x[:, sl], head)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[:, sl, None])[..., 0]
        num = num + torch.sum(torch.where(mask[:, sl], logz - gold, 0.0))
        den = den + torch.sum(mask[:, sl])
    return num / torch.clamp(den, min=1.0)


def decoder_loss(model: DecoderLM, batch: Dict, cfg: ModelConfig
                 ) -> torch.Tensor:
    """``_masked_ce`` of ``batch['labels']`` plus 0.01 times the MoE aux
    loss.  The VLM's patch positions carry no label: -1 is prepended
    over them."""
    patches = batch.get("patch_embeds")
    x, aux = decoder_hidden(model, batch["tokens"], cfg,
                            pos3=batch.get("pos3"), patch_embeds=patches,
                            with_aux=True)
    labels = batch["labels"]
    if patches is not None:
        pad = torch.full((labels.shape[0], patches.shape[1]), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    return _masked_ce(model.embed.head, x, labels, cfg) + 0.01 * aux


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


def _encoder_block(layer: EncBlock, x: torch.Tensor, cfg: ModelConfig,
                   pos: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(x, layer.ln_attn)
    x = x + attention_apply(layer.attn, h, cfg, pos=pos, causal=False,
                            use_rope=False)
    return x + mlp_apply(layer.mlp, rmsnorm(x, layer.ln_mlp), cfg)


def encoder_apply(model: EncDecLM, frames: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """frames (b, s_enc, d): precomputed embeddings (the reference's stub
    of the conv front end) -> the encoder's output (b, s_enc, d)."""
    b, s, d = frames.shape
    x = frames.to(cfg.act_dtype) + _sinusoid(s, d, cfg.act_dtype,
                                             frames.device)
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    for layer in model.enc_layers:
        x = remat(cfg, _encoder_block, layer, x, cfg, pos)
    return rmsnorm(x, model.ln_enc)


def _decoder_block(layer: DecBlock, x: torch.Tensor, enc: torch.Tensor,
                   cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """Self-attention, cross-attention to ``enc`` (its K/V projected here,
    once a layer), MLP."""
    act = cfg.act_dtype
    h = rmsnorm(x, layer.ln_self)
    x = x + attention_apply(layer.self_attn, h, cfg, pos=pos, causal=True,
                            use_rope=False)
    h = rmsnorm(x, layer.ln_cross)
    kv = (project_heads(enc, layer.cross_attn.wk, act),
          project_heads(enc, layer.cross_attn.wv, act))
    x = x + attention_apply(layer.cross_attn, h, cfg, pos=pos, causal=False,
                            kv_override=kv)
    return x + mlp_apply(layer.mlp, rmsnorm(x, layer.ln_mlp), cfg)


def encdec_hidden(model: EncDecLM, frames: torch.Tensor,
                  tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The decoder's final hidden state (b, s, d) over ``tokens`` (b, s)
    with cross-attention to the encoder's output over ``frames``."""
    enc = encoder_apply(model, frames, cfg)
    b, s = tokens.shape
    x = embed_tokens(model.embed, tokens, cfg) + _sinusoid(
        s, cfg.d_model, cfg.act_dtype, enc.device)
    pos = torch.arange(s, device=enc.device)[None].expand(b, s)
    for layer in model.dec_layers:
        x = remat(cfg, _decoder_block, layer, x, enc, cfg, pos)
    return rmsnorm(x, model.ln_f)


def encdec_loss(model: EncDecLM, batch: Dict, cfg: ModelConfig
                ) -> torch.Tensor:
    x = encdec_hidden(model, batch["frames"], batch["tokens"], cfg)
    return _masked_ce(model.embed.head, x, batch["labels"], cfg)


def hybrid_hidden(model: HybridLM, tokens: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """The final hidden state (b, s, d): RG-LRU or local-attention mixer,
    then the GeGLU MLP, a layer.  The reference unrolls these layers
    without remat, and so does this."""
    x = embed_tokens(model.embed, tokens, cfg)
    b, s = tokens.shape
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    for layer, kind in zip(model.layers, hybrid_layer_kinds(cfg)):
        h = rmsnorm(x, layer.ln_mix)
        if kind == "attn":
            x = x + attention_apply(layer.attn, h, cfg, pos=pos, causal=True)
        else:
            x = x + rglru_block_apply(layer.rglru, h, cfg)
        x = x + mlp_apply(layer.mlp, rmsnorm(x, layer.ln_mlp), cfg)
    return rmsnorm(x, model.ln_f)


def hybrid_loss(model: HybridLM, batch: Dict, cfg: ModelConfig
                ) -> torch.Tensor:
    x = hybrid_hidden(model, batch["tokens"], cfg)
    return _masked_ce(model.embed.head, x, batch["labels"], cfg)


def _ssm_block(layer: SSMBlock, x: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    return x + mamba2_apply(layer.mixer, rmsnorm(x, layer.ln), cfg)


def ssm_hidden(model: SSMLM, tokens: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    x = embed_tokens(model.embed, tokens, cfg)
    for layer in model.layers:
        x = remat(cfg, _ssm_block, layer, x, cfg)
    return rmsnorm(x, model.ln_f)


def ssm_loss(model: SSMLM, batch: Dict, cfg: ModelConfig) -> torch.Tensor:
    x = ssm_hidden(model, batch["tokens"], cfg)
    return _masked_ce(model.embed.head, x, batch["labels"], cfg)
