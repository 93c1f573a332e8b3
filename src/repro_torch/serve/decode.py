"""Prefill and single-token decode for the KV-cache families (dense and
MoE decoders).

Counterpart of the dense / MoE part of ``repro/serve/decode.py``.  The
blocks' second half is ``models.transformer.block_ffn`` (MLP or MoE);
an MoE block routes each batch row as its own group, so a decode row, a
full prefill's prompt and the whole packed buffer (pad tokens included)
are each one group.

The KV cache layout is the reference's: k / v (L, b, hkv, S, hd) with
``stored_pos`` (b, S) the absolute position each cache slot holds (-1
empty) and ``pos`` (b,) the next position; S = min(window, max_seq)
makes a ring buffer for sliding-window models.

The reference's caches are immutable pytrees; here ``KVCache`` is updated
in place (``decode_step``, ``reset_slot``, ``write_slot``), since a copy
of a full-width cache is gigabytes.  So nothing may keep a second
reference to a cache and expect it unchanged: ``reset_slot`` writes the
empty values directly instead of copying them from a pristine cache.

The SSM, hybrid, encoder-decoder and VLM families wait (ROADMAP.md,
queue 1, items 10 and 11).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..kernels.ops import packed_attention_op
from ..models.config import ModelConfig
from ..models.layers import (apply_rope, attention_apply, attention_decode,
                             embed_tokens, lm_logits, merge_heads,
                             project_heads, rmsnorm)
from ..models.transformer import DecoderLM, block_ffn

#: the families whose serving state is a ``KVCache``
KV_FAMILIES = ("dense", "moe")
FAMILY_TODO = ("family {!r} cannot be served yet: the port serves the "
               "KV-cache families " + str(KV_FAMILIES) + " (ROADMAP.md, "
               "queue 1, items 10 and 11)")


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor            # (L, b, hkv, S, hd)
    v: torch.Tensor
    stored_pos: torch.Tensor   # (b, S) int32 absolute position, -1 empty
    pos: torch.Tensor          # (b,) int32 next position


def _kv_family(cfg: ModelConfig) -> None:
    if cfg.family not in KV_FAMILIES:
        raise NotImplementedError(FAMILY_TODO.format(cfg.family))


def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    """S: the context budget, or the window for a sliding-window ring."""
    return max_seq if cfg.window is None else min(cfg.window, max_seq)


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                  device) -> KVCache:
    S = cache_len(cfg, max_seq)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, S, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.act_dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.act_dtype, device=device),
        stored_pos=torch.full((batch, S), -1, dtype=torch.int32,
                              device=device),
        pos=torch.zeros(batch, dtype=torch.int32, device=device))


def _write_slot(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor
                ) -> KVCache:
    """Write (L, b, hkv, 1, hd) entries at each row's current position
    (ring slot ``pos % S``) and advance ``pos``, in place."""
    L, b, hkv, S, hd = cache.k.shape
    slot = (cache.pos % S).long()
    bi = torch.arange(b, device=cache.k.device)
    # advanced indices (bi, slot) separated by slices: the indexed view is
    # (b, L, hkv, hd), the advanced dims first (as in NumPy and JAX)
    cache.k[:, bi, :, slot, :] = k_new[:, :, :, 0, :].movedim(0, 1)
    cache.v[:, bi, :, slot, :] = v_new[:, :, :, 0, :].movedim(0, 1)
    cache.stored_pos[bi, slot] = cache.pos
    cache.pos += 1
    return cache


# ---------------------------------------------------------------------------
# dense / MoE decoder
# ---------------------------------------------------------------------------

@torch.no_grad()
def decoder_prefill(model: DecoderLM, tokens: torch.Tensor,
                    cfg: ModelConfig, *, max_seq: int
                    ) -> Tuple[torch.Tensor, KVCache]:
    """Forward over the prompt (b, s): last-position logits (b, vocab)
    float32 and a cache seeded with the prompt's K/V."""
    x = embed_tokens(model.embed, tokens, cfg)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for layer in model.layers:
        h = rmsnorm(x, layer.ln_attn)
        y, (k, v) = attention_apply(layer.attn, h, cfg, pos=pos, causal=True,
                                    return_kv=True)
        ks.append(k)
        vs.append(v)
        x = block_ffn(layer, x + y, cfg)
    x = rmsnorm(x, model.ln_f)
    logits = lm_logits(model.embed, x[:, -1])

    cache = init_kv_cache(cfg, b, max_seq, device=x.device)
    S = cache.k.shape[3]
    if S >= s:
        for li, (k, v) in enumerate(zip(ks, vs)):
            cache.k[li, :, :, :s] = k
            cache.v[li, :, :, :s] = v
        cache.stored_pos[:, :s] = torch.arange(s, dtype=torch.int32,
                                               device=x.device)
    else:   # sliding-window ring: keep the last S positions
        ring_pos = torch.arange(s - S, s, device=x.device)
        slot = ring_pos % S
        for li, (k, v) in enumerate(zip(ks, vs)):
            cache.k[li][:, :, slot] = k[:, :, s - S:]
            cache.v[li][:, :, slot] = v[:, :, s - S:]
        cache.stored_pos[:, slot] = ring_pos.to(torch.int32)
    cache.pos.fill_(s)
    return logits, cache


@torch.no_grad()
def decoder_decode_step(model: DecoderLM, cache: KVCache,
                        tokens: torch.Tensor, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, KVCache]:
    """One token for every row: tokens (b, 1) -> logits (b, 1, vocab)
    float32; ``cache`` advances in place.  Every layer attends to the
    cache as it was before the step; the new entries are written after."""
    x = embed_tokens(model.embed, tokens, cfg)
    ks, vs = [], []
    for li, layer in enumerate(model.layers):
        h = rmsnorm(x, layer.ln_attn)
        y, k_new, v_new = attention_decode(
            layer.attn, h, cfg, cache_k=cache.k[li], cache_v=cache.v[li],
            stored_pos=cache.stored_pos, pos=cache.pos)
        ks.append(k_new)
        vs.append(v_new)
        x = block_ffn(layer, x + y, cfg)
    x = rmsnorm(x, model.ln_f)
    logits = lm_logits(model.embed, x)
    _write_slot(cache, torch.stack(ks), torch.stack(vs))
    return logits, cache


def _packed_attention(attn, h: torch.Tensor, cfg: ModelConfig,
                      pos: torch.Tensor, seg: torch.Tensor, *,
                      use_pallas: Optional[bool]):
    """``attention_apply``'s projections over one packed buffer with the
    segment-masked core ``packed_attention_op``.  h: (1, C, d_model);
    pos: (1, C) within-segment positions; seg: (C,), -1 = pad.  Returns
    (y, (k, v)) with k / v the rope'd unexpanded (hkv, C, hd) entries."""
    act = cfg.act_dtype
    q = apply_rope(project_heads(h, attn.wq, act), pos, cfg.rope_theta)
    k = apply_rope(project_heads(h, attn.wk, act), pos, cfg.rope_theta)
    v = project_heads(h, attn.wv, act)
    out = packed_attention_op(q[0], k[0], v[0], seg,
                              softcap=cfg.attn_logit_softcap or None,
                              use_pallas=use_pallas)
    return merge_heads(out[None].to(act), attn.wo, act), (k[0], v[0])


@torch.no_grad()
def packed_prefill(model: DecoderLM, tokens: torch.Tensor, seg: torch.Tensor,
                   pos: torch.Tensor, last_idx: torch.Tensor,
                   cfg: ModelConfig, *, use_pallas: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward over a packed multi-request prompt buffer.

    tokens: (C,) (pad = token 0, masked by seg); seg: (C,) request ids,
    -1 = pad; pos: (C,) within-segment positions; last_idx: (m,) buffer
    index of each request's last prompt token.  Returns (logits (m, vocab)
    float32, ks, vs) with ks / vs the rope'd unexpanded K/V of every
    layer, (L, hkv, C, hd), for the paged slot scatter
    (``slots.make_paged_insert``)."""
    _kv_family(cfg)
    x = embed_tokens(model.embed, tokens[None], cfg)        # (1, C, d)
    C = tokens.shape[0]
    shape = (cfg.n_layers, cfg.n_kv_heads, C, cfg.hd)
    ks = torch.empty(shape, dtype=cfg.act_dtype, device=x.device)
    vs = torch.empty(shape, dtype=cfg.act_dtype, device=x.device)
    pos_b = pos[None]
    for li, layer in enumerate(model.layers):
        h = rmsnorm(x, layer.ln_attn)
        y, (k, v) = _packed_attention(layer.attn, h, cfg, pos_b, seg,
                                      use_pallas=use_pallas)
        ks[li] = k
        vs[li] = v
        x = block_ffn(layer, x + y, cfg)
    x = rmsnorm(x, model.ln_f)
    logits = lm_logits(model.embed, x[0, last_idx.long()])
    return logits, ks, vs


# ---------------------------------------------------------------------------
# dispatch by family (the KV-cache families only)
# ---------------------------------------------------------------------------

def prefill(model: DecoderLM, batch: Dict, cfg: ModelConfig, *,
            max_seq: int) -> Tuple[torch.Tensor, KVCache]:
    _kv_family(cfg)
    if batch.get("patch_embeds") is not None:
        raise NotImplementedError(FAMILY_TODO.format("vlm"))
    return decoder_prefill(model, batch["tokens"], cfg, max_seq=max_seq)


def decode_step(model: DecoderLM, state: KVCache, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    _kv_family(cfg)
    return decoder_decode_step(model, state, tokens, cfg)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device) -> KVCache:
    """The reference's dry-run state: every row's positions pre-wound
    (``pos = max_seq - 1``, ``stored_pos = arange(S)``) over zero K/V.
    The 'cheap' prefill oracle starts from it."""
    _kv_family(cfg)
    c = init_kv_cache(cfg, batch, max_seq, device=device)
    c.pos.fill_(max_seq - 1)
    c.stored_pos.copy_(torch.arange(c.k.shape[3], dtype=torch.int32,
                                    device=device).expand_as(c.stored_pos))
    return c


def init_serve_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                     device) -> KVCache:
    """Empty decode state: pos = 0, no stored positions (the 'full' and
    'packed' prefills seed each row)."""
    _kv_family(cfg)
    return init_kv_cache(cfg, batch, max_seq, device=device)


def reset_slot(state: KVCache, i: int, cfg: ModelConfig, *,
               wound_to: Optional[int] = None) -> KVCache:
    """Reset batch row ``i`` in place: zero K/V, and the positions of an
    empty row (``stored_pos = -1``, ``pos = 0``) -- or, with ``wound_to
    = max_seq``, those of ``init_decode_state(max_seq)``'s rows.

    A freed slot still holds its last request's K/V and positions;
    admitting a new request without clearing them leaks the old context
    into its attention.  The reference copies the row from a pristine
    state; here the values are written directly."""
    _kv_family(cfg)
    state.k[:, i].zero_()
    state.v[:, i].zero_()
    if wound_to is None:
        state.stored_pos[i].fill_(-1)
        state.pos[i] = 0
    else:
        state.stored_pos[i].copy_(torch.arange(
            state.k.shape[3], dtype=torch.int32, device=state.k.device))
        state.pos[i] = wound_to - 1
    return state
