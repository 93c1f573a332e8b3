"""Prefill and single-token decode for every family: the KV-cache
decoders (dense, MoE and the VLM), the SSM (mamba2), the hybrid
(recurrentgemma) and the encoder-decoder (whisper).  Counterpart of
``repro/serve/decode.py``.

Serving state by family (the batch dimension is the slot axis):

* dense / MoE / VLM: ``KVCache`` -- k / v (L, b, hkv, S, hd) with
  ``stored_pos`` (b, S) the absolute position each cache slot holds (-1
  empty) and ``pos`` (b,) the next position; S = min(window, max_seq)
  makes a ring buffer for sliding-window models.  The blocks' second
  half is ``models.transformer.block_ffn`` (MLP or MoE); an MoE block
  routes each batch row as its own group, so a decode row, a full
  prefill's prompt and the whole packed buffer (pad tokens included) are
  each one group.  The VLM's prefill prepends patch embeddings and
  rotates with M-RoPE, whose three streams a prompt gives the same
  positions (so its angles are RoPE's); its decode is RoPE's.
* SSM: ``SSMState`` -- an ``SSMCache`` stacked over the layers (float32
  state (L, b, h, dstate, p), conv window (L, b, conv_dim, kconv - 1))
  and ``pos``: O(1) in the sequence length.
* hybrid: ``HybridState`` -- one cache a layer, a ``KVCache`` of one
  layer (a ring of S = min(window, max_seq)) for local attention or an
  ``RGLRUCache``, and ``pos``.
* encoder-decoder: ``EncDecState`` -- the decoder's self-attention
  ``KVCache``, the cross-attention K/V of every layer over the encoder's
  frames (L, b, hkv, s_enc, hd), computed once at prefill, and ``pos``.
  Only ``prefill`` (the batch API, with ``batch['frames']``) runs the
  encoder; a serving session seats whisper with ``prefill='cheap'``
  over zero cross K/V, as the reference does.

The conv windows follow the reference's types: a prefill seeds them in
``act_dtype``, and the first decode step turns them float32 (the
reference's concatenate of the window and the float32 input promotes),
for good.

On a model axis (``prefill`` / ``decode_step`` with ``model=``, the
model group's ``Comm``, and ``slices=``, the rank's
``distributed.sharding.model_slices`` under ``launch.mesh.serve_rules``,
from which the model was built) every layer runs its part as training
runs it (heads, MLP and recurrent width, vocab and experts sliced; a
layer with no slice whole on every rank), and the KV caches' sequence
is split over the model ranks: rank i holds slots ``[i S/m, (i+1)
S/m)`` of every K/V head (``"cache_seq"``), ``prefill`` seeds each
rank's block, ``decode_step`` writes a new entry on the rank that owns
its slot ``pos % S`` and attends over every rank's block
(``models.layers.attention_decode``).  The recurrent states follow the
rules: the RG-LRU's ``h`` and conv window hold the rank's channels, the
SSM's state and whisper's cross K/V are whole on every rank.  With the
head's vocab sliced the logits are the rank's vocab columns.

The reference's states are immutable pytrees; here they are updated in
place (``decode_step``, ``reset_slot``, ``slots.write_slot``), since a
copy of a full-width cache is gigabytes.  So nothing may keep a second
reference to a state and expect it unchanged: ``reset_slot`` writes the
empty values directly instead of copying them from a pristine state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..kernels.ops import packed_attention_op
from ..models.config import ModelConfig
from ..models.layers import (apply_rope, attention_apply, attention_decode,
                             embed_tokens, lm_logits, merge_heads, mlp_apply,
                             project_heads, rmsnorm)
from ..models.rglru import (RGLRUCache, init_rglru_cache, rglru_block_apply,
                            rglru_block_decode)
from ..models.ssm import (SSMCache, init_ssm_cache, mamba2_apply,
                          mamba2_decode)
from ..models.transformer import (DecoderLM, EncDecLM, HybridLM, SSMLM,
                                  _sinusoid, block_ffn, decoder_inputs,
                                  encoder_apply, hybrid_layer_kinds)

F32 = torch.float32
#: the families whose serving state is a ``KVCache``
KV_FAMILIES = ("dense", "moe", "vlm")
#: the families the port serves
SERVED_FAMILIES = KV_FAMILIES + ("ssm", "hybrid", "encdec")


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor            # (L, b, hkv, S, hd)
    v: torch.Tensor
    stored_pos: torch.Tensor   # (b, S) int32 absolute position, -1 empty
    pos: torch.Tensor          # (b,) int32 next position


def kv_cache_spec_axes():
    """The logical axes of the K / V caches' dims, (L, b, hkv, S, hd)."""
    return (None, "batch", "kv_heads", "seq", "head_dim")


@dataclasses.dataclass
class SSMState:
    layers: SSMCache           # stacked over the layers: (L, b, ...)
    pos: torch.Tensor          # (b,) int32 next position


@dataclasses.dataclass
class HybridState:
    layers: Tuple              # a KVCache (L = 1) or an RGLRUCache a layer
    pos: torch.Tensor          # (b,) int32 next position


@dataclasses.dataclass
class EncDecState:
    self_kv: KVCache           # the decoder's self-attention cache
    cross_k: torch.Tensor      # (L, b, hkv, s_enc, hd)
    cross_v: torch.Tensor
    pos: torch.Tensor          # (b,) int32 next position


State = Union[KVCache, SSMState, HybridState, EncDecState]


def _served(cfg: ModelConfig) -> None:
    if cfg.family not in SERVED_FAMILIES:
        raise ValueError(f"family {cfg.family!r}: one of {SERVED_FAMILIES}")


def _kv_family(cfg: ModelConfig) -> None:
    """The packed prefill and its paged insert take KV caches only, as in
    the reference: recurrent state cannot be segment-masked inside one
    packed forward, and the encoder-decoder's rows need their frames."""
    _served(cfg)
    if cfg.family not in KV_FAMILIES:
        raise ValueError(f"family {cfg.family!r} carries recurrent state or "
                         "encoder frames, which one packed forward cannot "
                         "segment-mask: the packed prefill takes the "
                         f"KV-cache families {KV_FAMILIES}")


def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    """S: the context budget, or the window for a sliding-window ring."""
    return max_seq if cfg.window is None else min(cfg.window, max_seq)


def _axis(model) -> Tuple[int, int]:
    """(m, rank) of the model group ``model`` (None: (1, 0))."""
    return (1, 0) if model is None else (model.size, model.rank)


def cache_block(S: int, m: int) -> int:
    """The slots of a cache of S a model rank holds."""
    if S % m:
        raise ValueError(f"a cache of {S} slots does not split over {m} "
                         "model ranks")
    return S // m


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                  device, n_layers: Optional[int] = None, m: int = 1
                  ) -> KVCache:
    """Empty cache; ``m``: a model rank's block of the slots of ``m``."""
    S = cache_block(cache_len(cfg, max_seq), m)
    L = cfg.n_layers if n_layers is None else n_layers
    shape = (L, batch, cfg.n_kv_heads, S, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.act_dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.act_dtype, device=device),
        stored_pos=torch.full((batch, S), -1, dtype=torch.int32,
                              device=device),
        pos=torch.zeros(batch, dtype=torch.int32, device=device))


def _write_slot(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                model=None) -> KVCache:
    """Write (L, b, hkv, 1, hd) entries at each row's current position
    (ring slot ``pos % S``) and advance ``pos``, in place.  On the model
    group ``model`` the cache is this rank's block of the slots, and a
    row's entry is written where its slot lies in that block."""
    L, b, hkv, S, hd = cache.k.shape
    m, r = _axis(model)
    slot = (cache.pos % (S * m)).long()
    bi = torch.arange(b, device=cache.k.device)
    k_rows = k_new[:, :, :, 0, :].movedim(0, 1)
    v_rows = v_new[:, :, :, 0, :].movedim(0, 1)
    pos = cache.pos
    if model is not None:       # the rows whose slot is this rank's
        mine = slot // S == r
        slot = slot % S
        keep = mine[:, None, None, None]
        k_rows = torch.where(keep, k_rows, cache.k[:, bi, :, slot, :])
        v_rows = torch.where(keep, v_rows, cache.v[:, bi, :, slot, :])
        pos = torch.where(mine, pos, cache.stored_pos[bi, slot])
    # advanced indices (bi, slot) separated by slices: the indexed view is
    # (b, L, hkv, hd), the advanced dims first (as in NumPy and JAX)
    cache.k[:, bi, :, slot, :] = k_rows
    cache.v[:, bi, :, slot, :] = v_rows
    cache.stored_pos[bi, slot] = pos
    cache.pos += 1
    return cache


def _seed_kv(cache: KVCache, li: int, k: torch.Tensor, v: torch.Tensor,
             model=None) -> None:
    """Seed layer ``li`` of ``cache`` (all rows) with a prompt's rotated
    K/V (b, hkv, s, hd) and ``stored_pos`` with its positions: slot g
    holds position g where S >= s; a sliding-window ring keeps the last S
    positions, position p at slot ``p % S``.  On the model group
    ``model``, only this rank's block of the slots."""
    S_loc = cache.k.shape[3]
    s = k.shape[2]
    m, r = _axis(model)
    S = S_loc * m
    g = r * S_loc + torch.arange(S_loc, device=k.device)
    if S >= s:
        valid = g < s
        p = torch.clamp(g, max=s - 1)
    else:       # the last S positions: slot g holds the p with p % S == g
        valid = torch.ones_like(g, dtype=torch.bool)
        p = s - S + (g - (s - S)) % S
    drop = ~valid[:, None]
    cache.k[li] = k.index_select(2, p).masked_fill_(drop, 0)
    cache.v[li] = v.index_select(2, p).masked_fill_(drop, 0)
    cache.stored_pos.copy_(torch.where(valid, p, -1).to(torch.int32)
                           .expand_as(cache.stored_pos))


# ---------------------------------------------------------------------------
# dense / MoE / VLM decoder
# ---------------------------------------------------------------------------

@torch.no_grad()
def decoder_prefill(lm: DecoderLM, tokens: torch.Tensor,
                    cfg: ModelConfig, *, max_seq: int,
                    patch_embeds: Optional[torch.Tensor] = None, model=None
                    ) -> Tuple[torch.Tensor, KVCache]:
    """Forward over the prompt (b, s) -- after the VLM's patch embeddings
    (b, n_p, d), if given -- : last-position logits (b, vocab) float32 and
    a cache seeded with the K/V of all n_p + s positions.  ``model``: the
    model group (the module docstring)."""
    x, pos, pos3 = decoder_inputs(lm, tokens, cfg, patch_embeds, model)
    b, s, _ = x.shape
    cache = init_kv_cache(cfg, b, max_seq, device=x.device,
                          m=_axis(model)[0])
    for li, layer in enumerate(lm.layers):
        h = rmsnorm(x, layer.ln_attn)
        y, (k, v) = attention_apply(layer.attn, h, cfg, pos=pos, pos3=pos3,
                                    causal=True, return_kv=True, model=model)
        _seed_kv(cache, li, k, v, model)
        x = block_ffn(layer, x + y, cfg, model=model)
    x = rmsnorm(x, lm.ln_f)
    logits = lm_logits(lm.embed, x[:, -1])
    cache.pos.fill_(s)
    return logits, cache


@torch.no_grad()
def decoder_decode_step(lm: DecoderLM, cache: KVCache,
                        tokens: torch.Tensor, cfg: ModelConfig, model=None
                        ) -> Tuple[torch.Tensor, KVCache]:
    """One token for every row: tokens (b, 1) -> logits (b, 1, vocab)
    float32; ``cache`` advances in place.  Every layer attends to the
    cache as it was before the step; the new entries are written after.
    ``model``: the model group (the module docstring)."""
    x = embed_tokens(lm.embed, tokens, cfg, model)
    ks, vs = [], []
    for li, layer in enumerate(lm.layers):
        h = rmsnorm(x, layer.ln_attn)
        y, k_new, v_new = attention_decode(
            layer.attn, h, cfg, cache_k=cache.k[li], cache_v=cache.v[li],
            stored_pos=cache.stored_pos, pos=cache.pos, model=model)
        ks.append(k_new)
        vs.append(v_new)
        x = block_ffn(layer, x + y, cfg, model=model)
    x = rmsnorm(x, lm.ln_f)
    logits = lm_logits(lm.embed, x)
    _write_slot(cache, torch.stack(ks), torch.stack(vs), model)
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
# ssm (mamba2)
# ---------------------------------------------------------------------------

def _promote_conv(cache) -> None:
    """The reference's decode concatenates the ``act_dtype`` conv window
    with a float32 input, so the window is float32 from the first decode
    step on: swap it for a float32 copy once (the same values)."""
    if cache.conv.dtype != F32:
        cache.conv = cache.conv.to(F32)


@torch.no_grad()
def ssm_prefill(lm: SSMLM, tokens: torch.Tensor, cfg: ModelConfig,
                model=None) -> Tuple[torch.Tensor, SSMState]:
    """Forward over the prompt (b, s): last-position logits (b, vocab)
    float32 and the state after it (conv windows in ``act_dtype``).
    ``model``: the model group (the mixers run whole on every rank)."""
    x = embed_tokens(lm.embed, tokens, cfg, model)
    b, s = tokens.shape
    caches = init_ssm_cache(cfg, b, device=x.device, n_layers=cfg.n_layers)
    for li, layer in enumerate(lm.layers):
        y, c = mamba2_apply(layer.mixer, rmsnorm(x, layer.ln), cfg,
                            return_cache=True)
        caches.state[li] = c.state
        caches.conv[li] = c.conv
        x = x + y
    x = rmsnorm(x, lm.ln_f)
    logits = lm_logits(lm.embed, x[:, -1])
    return logits, SSMState(caches, torch.full((b,), s, dtype=torch.int32,
                                               device=x.device))


@torch.no_grad()
def ssm_decode_step(lm: SSMLM, state: SSMState, tokens: torch.Tensor,
                    cfg: ModelConfig, model=None
                    ) -> Tuple[torch.Tensor, SSMState]:
    """One token for every row: tokens (b, 1) -> logits (b, 1, vocab)
    float32; ``state`` advances in place.  ``model``: the model group."""
    x = embed_tokens(lm.embed, tokens, cfg, model)
    caches = state.layers
    _promote_conv(caches)
    for li, layer in enumerate(lm.layers):
        y, c = mamba2_decode(layer.mixer, rmsnorm(x, layer.ln), cfg,
                             SSMCache(caches.state[li], caches.conv[li]))
        caches.state[li] = c.state
        caches.conv[li] = c.conv
        x = x + y
    x = rmsnorm(x, lm.ln_f)
    logits = lm_logits(lm.embed, x)
    state.pos += 1
    return logits, state


# ---------------------------------------------------------------------------
# hybrid (recurrentgemma)
# ---------------------------------------------------------------------------

@torch.no_grad()
def hybrid_prefill(lm: HybridLM, tokens: torch.Tensor, cfg: ModelConfig,
                   *, max_seq: int, model=None
                   ) -> Tuple[torch.Tensor, HybridState]:
    """Forward over the prompt (b, s): last-position logits (b, vocab)
    float32 and the state after it.  An attention layer's ring keeps the
    last S = min(window, max_seq) positions, position p at slot ``p %
    S`` (``_seed_kv``), as the reference writes it.  ``model``: the model
    group (the RG-LRU and its cache on the rank's channels)."""
    x = embed_tokens(lm.embed, tokens, cfg, model)
    b, s = tokens.shape
    dev = x.device
    m = _axis(model)[0]
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    caches: List = []
    for layer, kind in zip(lm.layers, hybrid_layer_kinds(cfg)):
        h = rmsnorm(x, layer.ln_mix)
        if kind == "attn":
            y, (k, v) = attention_apply(layer.attn, h, cfg, pos=pos,
                                        causal=True, return_kv=True,
                                        model=model)
            c = init_kv_cache(cfg, b, max_seq, device=dev, n_layers=1, m=m)
            _seed_kv(c, 0, k, v, model)
            c.pos.fill_(s)
        else:
            y, c = rglru_block_apply(layer.rglru, h, cfg, return_cache=True,
                                     model=model)
        caches.append(c)
        x = x + y
        x = x + mlp_apply(layer.mlp, rmsnorm(x, layer.ln_mlp), cfg, model)
    x = rmsnorm(x, lm.ln_f)
    logits = lm_logits(lm.embed, x[:, -1])
    return logits, HybridState(tuple(caches), torch.full(
        (b,), s, dtype=torch.int32, device=dev))


@torch.no_grad()
def hybrid_decode_step(lm: HybridLM, state: HybridState,
                       tokens: torch.Tensor, cfg: ModelConfig, model=None
                       ) -> Tuple[torch.Tensor, HybridState]:
    """One token for every row: tokens (b, 1) -> logits (b, 1, vocab)
    float32; ``state`` advances in place.  An attention layer's cache
    takes the state's positions before its entry is written (the
    reference sets the layer's ``pos`` from the state's).  ``model``:
    the model group."""
    x = embed_tokens(lm.embed, tokens, cfg, model)
    for layer, kind, c in zip(lm.layers, hybrid_layer_kinds(cfg),
                              state.layers):
        h = rmsnorm(x, layer.ln_mix)
        if kind == "attn":
            y, k_new, v_new = attention_decode(
                layer.attn, h, cfg, cache_k=c.k[0], cache_v=c.v[0],
                stored_pos=c.stored_pos, pos=state.pos, model=model)
            c.pos.copy_(state.pos)
            _write_slot(c, k_new[None], v_new[None], model)
        else:
            _promote_conv(c)
            y, c2 = rglru_block_decode(layer.rglru, h, cfg, c, model)
            c.h.copy_(c2.h)
            c.conv.copy_(c2.conv)
        x = x + y
        x = x + mlp_apply(layer.mlp, rmsnorm(x, layer.ln_mlp), cfg, model)
    x = rmsnorm(x, lm.ln_f)
    logits = lm_logits(lm.embed, x)
    state.pos += 1
    return logits, state


# ---------------------------------------------------------------------------
# encoder-decoder (whisper): decode over the decoder's positions with
# cross-attention to the (fixed) encoder output
# ---------------------------------------------------------------------------

@torch.no_grad()
def encdec_prefill(lm: EncDecLM, frames: torch.Tensor,
                   tokens: torch.Tensor, cfg: ModelConfig, *, max_seq: int,
                   model=None) -> Tuple[torch.Tensor, EncDecState]:
    """The encoder over ``frames`` (b, s_enc, d), then the decoder over
    the prompt (b, s): last-position logits (b, vocab) float32 and the
    state with the prompt's self-attention K/V and every layer's cross
    K/V (the encoder's output projected once; every K/V head on every
    rank of a model group ``model``)."""
    enc = encoder_apply(lm, frames, cfg, model)
    b, s = tokens.shape
    dev, act = enc.device, cfg.act_dtype
    x = embed_tokens(lm.embed, tokens, cfg, model) + _sinusoid(
        s, cfg.d_model, act, dev)
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    cache = init_kv_cache(cfg, b, max_seq, device=dev, m=_axis(model)[0])
    shape = (cfg.n_layers, b, cfg.n_kv_heads, enc.shape[1], cfg.hd)
    cross_k = torch.empty(shape, dtype=act, device=dev)
    cross_v = torch.empty(shape, dtype=act, device=dev)
    for li, layer in enumerate(lm.dec_layers):
        h = rmsnorm(x, layer.ln_self)
        y, (k, v) = attention_apply(layer.self_attn, h, cfg, pos=pos,
                                    causal=True, return_kv=True,
                                    use_rope=False, model=model)
        _seed_kv(cache, li, k, v, model)
        x = x + y
        h = rmsnorm(x, layer.ln_cross)
        cross_k[li] = project_heads(enc, layer.cross_attn.wk, act)
        cross_v[li] = project_heads(enc, layer.cross_attn.wv, act)
        x = x + attention_apply(layer.cross_attn, h, cfg, pos=pos,
                                causal=False,
                                kv_override=(cross_k[li], cross_v[li]),
                                model=model)
        x = x + mlp_apply(layer.mlp, rmsnorm(x, layer.ln_mlp), cfg, model)
    x = rmsnorm(x, lm.ln_f)
    logits = lm_logits(lm.embed, x[:, -1])
    cache.pos.fill_(s)
    return logits, EncDecState(cache, cross_k, cross_v, _pos(b, s, dev))


@torch.no_grad()
def encdec_decode_step(lm: EncDecLM, state: EncDecState,
                       tokens: torch.Tensor, cfg: ModelConfig, model=None
                       ) -> Tuple[torch.Tensor, EncDecState]:
    """One token for every row: tokens (b, 1) -> logits (b, 1, vocab)
    float32; ``state`` advances in place.  ``model``: the model group.

    Two of the reference's choices are kept: every row adds the
    sinusoid of row 0's position (``state.pos[0]``), and that position
    indexes a table of S + 1 rows, which JAX clamps to its last row once
    the position passes S (a 'cheap' session's rows start at ``max_seq -
    1``); here the index is clamped explicitly."""
    x = embed_tokens(lm.embed, tokens, cfg, model)
    cache = state.self_kv
    S = cache.k.shape[3] * _axis(model)[0]
    pe = _sinusoid(S + 1, cfg.d_model, cfg.act_dtype, x.device)
    x = x + pe.index_select(0, state.pos[:1].clamp(0, S).long())
    ks, vs = [], []
    for li, layer in enumerate(lm.dec_layers):
        h = rmsnorm(x, layer.ln_self)
        y, k_new, v_new = attention_decode(
            layer.self_attn, h, cfg, cache_k=cache.k[li],
            cache_v=cache.v[li], stored_pos=cache.stored_pos, pos=cache.pos,
            use_rope=False, model=model)
        ks.append(k_new)
        vs.append(v_new)
        x = x + y
        h = rmsnorm(x, layer.ln_cross)
        x = x + attention_apply(layer.cross_attn, h, cfg,
                                pos=cache.pos[:, None], causal=False,
                                kv_override=(state.cross_k[li],
                                             state.cross_v[li]), model=model)
        x = x + mlp_apply(layer.mlp, rmsnorm(x, layer.ln_mlp), cfg, model)
    x = rmsnorm(x, lm.ln_f)
    logits = lm_logits(lm.embed, x)
    _write_slot(cache, torch.stack(ks), torch.stack(vs), model)
    state.pos += 1
    return logits, state


# ---------------------------------------------------------------------------
# dispatch by family
# ---------------------------------------------------------------------------

def _model_pair(model, slices) -> None:
    if (model is None) != (slices is None):
        raise ValueError("model and slices come together: a model group's "
                         "rank serves its slices")


def prefill(lm, batch: Dict, cfg: ModelConfig, *, max_seq: int, model=None,
            slices: Optional[Dict] = None) -> Tuple[torch.Tensor, State]:
    """Last-position logits (b, vocab) float32 and the batch's state after
    its prompts ``batch['tokens']`` (b, s); the encoder-decoder also takes
    ``batch['frames']`` (b, s_enc, d) and the decoders the VLM's
    ``batch['patch_embeds']`` (b, n_p, d).  ``model`` and ``slices``: the
    model group and this rank's slices, from which ``lm`` was built (the
    module docstring)."""
    _served(cfg)
    _model_pair(model, slices)
    if cfg.family == "ssm":
        return ssm_prefill(lm, batch["tokens"], cfg, model)
    if cfg.family == "hybrid":
        return hybrid_prefill(lm, batch["tokens"], cfg, max_seq=max_seq,
                              model=model)
    if cfg.family == "encdec":
        return encdec_prefill(lm, batch["frames"], batch["tokens"], cfg,
                              max_seq=max_seq, model=model)
    return decoder_prefill(lm, batch["tokens"], cfg, max_seq=max_seq,
                           patch_embeds=batch.get("patch_embeds"),
                           model=model)


def decode_step(lm, state: State, tokens: torch.Tensor, cfg: ModelConfig,
                *, model=None, slices: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, State]:
    """One token for every row (``model``, ``slices``: as ``prefill``)."""
    _served(cfg)
    _model_pair(model, slices)
    if cfg.family == "ssm":
        return ssm_decode_step(lm, state, tokens, cfg, model)
    if cfg.family == "hybrid":
        return hybrid_decode_step(lm, state, tokens, cfg, model)
    if cfg.family == "encdec":
        return encdec_decode_step(lm, state, tokens, cfg, model)
    return decoder_decode_step(lm, state, tokens, cfg, model)


def _pos(batch: int, value: int, device) -> torch.Tensor:
    return torch.full((batch,), value, dtype=torch.int32, device=device)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device, model=None) -> State:
    """The reference's dry-run state: every row's positions pre-wound
    (``pos = max_seq - 1``; a KV cache's ``stored_pos = arange(S)``, a
    hybrid attention layer's ring the last S positions) over zero K/V,
    zero cross K/V of ``cfg.enc_seq`` frames and zero recurrent state.
    The 'cheap' prefill oracle starts from it.  ``model``: the model
    group, whose rank holds its block of each cache's slots and its
    channels of each RG-LRU state."""
    _served(cfg)
    m, r = _axis(model)
    if cfg.family == "encdec":
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.enc_seq, cfg.hd)
        state = EncDecState(
            init_kv_cache(cfg, batch, max_seq, device=device, m=m),
            torch.zeros(shape, dtype=cfg.act_dtype, device=device),
            torch.zeros(shape, dtype=cfg.act_dtype, device=device),
            _pos(batch, 0, device))
        for i in range(batch):
            reset_slot(state, i, cfg, wound_to=max_seq, model=model)
        return state
    if cfg.family == "ssm":
        return SSMState(init_ssm_cache(cfg, batch, device=device,
                                       n_layers=cfg.n_layers),
                        _pos(batch, max_seq - 1, device))
    if cfg.family == "hybrid":
        state = init_serve_state(cfg, batch, max_seq, device=device,
                                 model=model)
        for i in range(batch):
            reset_slot(state, i, cfg, wound_to=max_seq, model=model)
        return state
    c = init_kv_cache(cfg, batch, max_seq, device=device, m=m)
    S = c.k.shape[3]
    c.pos.fill_(max_seq - 1)
    c.stored_pos.copy_(torch.arange(r * S, (r + 1) * S, dtype=torch.int32,
                                    device=device).expand_as(c.stored_pos))
    return c


def init_serve_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                     device, model=None) -> State:
    """Empty decode state: pos = 0, no stored positions, zero recurrent
    state (the 'full' and 'packed' prefills seed each row).  The
    encoder-decoder has none, as in the reference: a prefill of its row
    needs encoder frames, which a serving request does not carry.
    ``model``: as ``init_decode_state``."""
    _served(cfg)
    m = _axis(model)[0]
    if cfg.family == "encdec":
        raise ValueError(f"init_serve_state: family {cfg.family!r} "
                         "unsupported (encdec prefill needs frames; use "
                         "prefill='cheap')")
    if cfg.family == "ssm":
        return SSMState(init_ssm_cache(cfg, batch, device=device,
                                       n_layers=cfg.n_layers),
                        _pos(batch, 0, device))
    if cfg.family == "hybrid":
        return HybridState(tuple(
            init_kv_cache(cfg, batch, max_seq, device=device, n_layers=1,
                          m=m)
            if kind == "attn"
            else init_rglru_cache(cfg, batch, device=device, m=m)
            for kind in hybrid_layer_kinds(cfg)), _pos(batch, 0, device))
    return init_kv_cache(cfg, batch, max_seq, device=device, m=m)


def _reset_kv_row(c: KVCache, i: int, first: Optional[int],
                  pos: Optional[int]) -> None:
    """Zero row i's K/V; ``first=None``: the positions of an empty row,
    else ``stored_pos = first, first + 1, ...`` and ``pos``."""
    c.k[:, i].zero_()
    c.v[:, i].zero_()
    if first is None:
        c.stored_pos[i].fill_(-1)
        c.pos[i] = 0
    else:
        c.stored_pos[i].copy_(torch.arange(
            first, first + c.k.shape[3], dtype=torch.int32,
            device=c.k.device))
        c.pos[i] = pos


def reset_slot(state: State, i: int, cfg: ModelConfig, *,
               wound_to: Optional[int] = None, model=None) -> State:
    """Reset batch row ``i`` in place: zero K/V and recurrent state, and
    the positions of an empty row (``stored_pos = -1``, ``pos = 0``) --
    or, with ``wound_to = max_seq``, those of ``init_decode_state
    (max_seq)``'s rows (``model``: of this model rank's block).

    A freed slot still holds its last request's K/V, state and
    positions; admitting a new request without clearing them leaks the
    old context into it.  The reference copies the row from a pristine
    state; here the values are written directly."""
    _served(cfg)
    m, r = _axis(model)
    pos = 0 if wound_to is None else wound_to - 1

    def first(c: KVCache, start: int) -> Optional[int]:
        return None if wound_to is None else start + r * c.k.shape[3]
    if cfg.family == "ssm":
        state.layers.state[:, i].zero_()
        state.layers.conv[:, i].zero_()
    elif cfg.family == "encdec":
        _reset_kv_row(state.self_kv, i, first(state.self_kv, 0), pos)
        state.cross_k[:, i].zero_()
        state.cross_v[:, i].zero_()
    elif cfg.family == "hybrid":
        for c in state.layers:
            if isinstance(c, KVCache):
                S = c.k.shape[3] * m
                _reset_kv_row(c, i, None if wound_to is None
                              else first(c, wound_to - S), pos)
            else:
                c.h[i].zero_()
                c.conv[i].zero_()
    else:
        _reset_kv_row(state, i, first(state, 0), pos)
        return state
    state.pos[i] = pos
    return state
