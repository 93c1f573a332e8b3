"""Shared model layers: RMSNorm, RoPE and M-RoPE, attention, the MLPs
(SwiGLU, GeGLU and the plain GELU MLP), embeddings.  Counterpart of
``repro/models/layers.py``.

Parameters live in ``nn.Module``s with the JAX package's layouts (``wq``
is (d_model, heads, head_dim), ``wo`` is (heads, head_dim, d_model)), so
weights carry across unchanged (``repro_torch.interop.params_from_jax``);
the ``*_apply`` functions take the module and compute.  Matrix products
accumulate in float32 and round to ``cfg.act_dtype`` -- a bf16
``torch.matmul`` does exactly that -- except the LM head, whose logits
come out of a float32 product as float32 (a bf16 head over 128,256
entries would tie the argmax).  The MLP (and the MoE layer's expert
products, ``models.moe``) keep the up-projections in float32 through
the activation and round once, as the reference does (``matmul_f32``,
``bmm_f32``).

Full-sequence attention has the reference's three strategies: chunked
(online softmax over KV chunks), blocked causal, and the hand-written
flash kernel (``cfg.use_pallas``; plain ``mha_ref`` on CPU tensors), which
also takes the encoder-decoder's cross-attention (K/V of another length
than Q, no mask).  The reference's tensor-parallel ``shard_map`` branch
is not ported (ROADMAP.md, queue 1, item 10).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.ops import flash_attention_op
from .config import ModelConfig

F32 = torch.float32
#: the gated MLP activations: SwiGLU and GeGLU (``"gelu_mlp"`` is the
#: plain GELU MLP, ``wo(gelu(x wi))``)
GATED_ACTS = ("silu", "gelu")


def dense_param(shape, dtype: torch.dtype, device, gen=None,
                scale: Optional[float] = None) -> nn.Parameter:
    """Normal(0, 1/fan_in) weights drawn in float32 from ``gen`` and cast
    to ``dtype`` (the reference's ``_init_dense``); ``gen=None`` leaves
    them uninitialised, to be loaded."""
    if gen is None:
        w = torch.empty(shape, dtype=dtype, device=device)
    else:
        fan_in = shape[0] if len(shape) >= 2 else shape[-1]
        scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        w = torch.randn(shape, generator=gen, dtype=F32,
                        device=device).mul_(scale).to(dtype)
    return nn.Parameter(w, requires_grad=False)


def ones_param(d: int, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# RMSNorm, RoPE
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.to(F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.to(F32)).to(x.dtype)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32, device=device)
                            / hd))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (b, h, s, d), pos: (b, s) -> rotated x (rotate-half)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = pos[:, None, :, None].to(F32) * freqs          # (b, 1, s, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): x (b, h, s, d), pos3 (3, b, s) the
    (t, h, w) position streams; the d/2 rotary frequencies are split into
    ``sections``, each rotated by its own stream."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to d/2 = "
                         f"{d // 2}")
    freqs = rope_freqs(d, theta, x.device)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.as_tensor(sections, device=x.device))
    pos_sel = pos3.to(F32)[sec_id]                       # (d/2, b, s)
    ang = pos_sel.permute(1, 2, 0)[:, None] * freqs      # (b, 1, s, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """Projections of one attention layer (GQA)."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        hd, d, dt = cfg.hd, cfg.d_model, cfg.p_dtype
        self.wq = dense_param((d, cfg.n_heads, hd), dt, device, gen)
        self.wk = dense_param((d, cfg.n_kv_heads, hd), dt, device, gen)
        self.wv = dense_param((d, cfg.n_kv_heads, hd), dt, device, gen)
        self.wo = dense_param((cfg.n_heads, hd, d), dt, device, gen)


def project_heads(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
                  ) -> torch.Tensor:
    """``einsum('bsd,dhk->bhsk')``, float32 accumulation, in ``dtype``."""
    b, s, d = x.shape
    _, h, k = w.shape
    y = torch.matmul(x.to(w.dtype), w.reshape(d, h * k))
    return y.view(b, s, h, k).transpose(1, 2).to(dtype)


def merge_heads(o: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
    """``einsum('bhsk,hkd->bsd')``, float32 accumulation, in ``dtype``."""
    b, h, s, k = o.shape
    y = torch.matmul(o.transpose(1, 2).reshape(b, s, h * k).to(w.dtype),
                     w.reshape(h * k, -1))
    return y.to(dtype)


def _mask(rows, cols, causal: bool, window: Optional[int]) -> torch.Tensor:
    mask = torch.ones((rows.shape[0], cols.shape[0]), dtype=torch.bool,
                      device=rows.device)
    if causal:
        mask &= cols[None, :] <= rows[:, None]
    if window is not None:
        mask &= cols[None, :] > rows[:, None] - window
    return mask


def _chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                       chunk: int, softcap: Optional[float] = None):
    """Online softmax over KV chunks.  q: (b, h, sq, d); k/v: (b, h, skv, d).
    Like the reference, ``skv`` must split into equal chunks."""
    b, h, s, d = q.shape
    skv = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    nc = max(skv // chunk, 1)
    chunk = skv // nc
    qf = q.to(F32) * scale
    kc = k.to(F32).reshape(b, h, nc, chunk, d)
    vc = v.to(F32).reshape(b, h, nc, chunk, d)
    rows = torch.arange(s, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=F32, device=q.device)
    m = torch.full((b, h, s, 1), -1e30, dtype=F32, device=q.device)
    l = torch.zeros((b, h, s, 1), dtype=F32, device=q.device)
    for ci in range(nc):
        kci, vci = kc[:, :, ci], vc[:, :, ci]
        cols = ci * chunk + torch.arange(chunk, device=q.device)
        logits = torch.matmul(qf, kci.transpose(-1, -2))
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        logits = torch.where(_mask(rows, cols, causal, window)[None, None],
                             logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vci)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _blocked_causal_attention(q, k, v, *, window: Optional[int], chunk: int,
                              softcap: Optional[float] = None):
    """Query chunk i attends keys [lo, (i + 1) chunk) only: the causal
    band, with static shapes per chunk."""
    b, h, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    nc = max(s // chunk, 1)
    chunk = s // nc
    outs = []
    for i in range(nc):
        qi = q[:, :, i * chunk:(i + 1) * chunk].to(F32) * scale
        hi = (i + 1) * chunk
        lo = 0
        if window is not None:
            lo = max(0, (i * chunk - window) // chunk * chunk)
        ki = k[:, :, lo:hi].to(F32)
        vi = v[:, :, lo:hi].to(F32)
        logits = torch.matmul(qi, ki.transpose(-1, -2))
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        rows = i * chunk + torch.arange(chunk, device=q.device)
        cols = lo + torch.arange(hi - lo, device=q.device)
        logits = torch.where(_mask(rows, cols, True, window)[None, None],
                             logits, -1e30)
        p = torch.softmax(logits, dim=-1)
        outs.append(torch.matmul(p, vi))
    return torch.cat(outs, dim=2).to(q.dtype)


def attention_apply(attn: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                    pos: torch.Tensor, causal: bool = True,
                    pos3: Optional[torch.Tensor] = None,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    return_kv: bool = False, use_rope: bool = True):
    """Full-sequence attention (prefill).  x: (b, s, d_model), pos: (b, s).

    ``pos3`` (3, b, s): M-RoPE's position streams (configs with
    ``mrope_sections``).  ``kv_override=(k, v)``: K/V (b, hkv, s_kv, hd)
    given, not projected from ``x`` -- the encoder-decoder's
    cross-attention, whose K and Q take no rotation.  ``use_rope=False``
    for the absolute-position whisper stacks.  ``return_kv=True`` also
    returns the rotated, unexpanded (hkv) K/V for seeding the cache.
    With ``cfg.use_pallas`` the attention core is ``flash_attention_op``
    on the unexpanded K/V (the kernel reads kv head ``h // group``;
    cross-attention with s_kv != s as well); like the reference's flash
    path it ignores ``cfg.attn_logit_softcap``."""
    group = cfg.n_heads // cfg.n_kv_heads
    act = cfg.act_dtype
    q = project_heads(x, attn.wq, act)
    if kv_override is None:
        k = project_heads(x, attn.wk, act)
        v = project_heads(x, attn.wv, act)
    else:
        k, v = kv_override
    if cfg.mrope_sections is not None and pos3 is not None:
        q = apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    elif kv_override is None and use_rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    kv_cacheable = (k, v)
    if cfg.use_pallas:
        out = flash_attention_op(q, k, v, causal=causal, window=cfg.window)
    else:
        if group > 1:
            k = k.repeat_interleave(group, dim=1)
            v = v.repeat_interleave(group, dim=1)
        if causal and cfg.causal_blocked_attn:
            out = _blocked_causal_attention(
                q, k, v, window=cfg.window, chunk=cfg.attn_chunk,
                softcap=cfg.attn_logit_softcap)
        else:
            out = _chunked_attention(
                q, k, v, causal=causal, window=cfg.window,
                chunk=cfg.attn_chunk, softcap=cfg.attn_logit_softcap)
    y = merge_heads(out, attn.wo, act)
    if return_kv:
        return y, kv_cacheable
    return y


def attention_decode(attn: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     stored_pos: torch.Tensor, pos: torch.Tensor,
                     use_rope: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode against a position-tracked cache.

    x: (b, 1, d); cache: (b, hkv, S, hd); stored_pos: (b, S) absolute
    position held by each cache slot (-1 empty); pos: (b,) current
    position.  The new K/V entry is folded in here; the caller writes it
    to the cache afterwards.  ``use_rope=False``: no rotation (whisper's
    decoder).  Returns (y, k_new, v_new), entries (b, hkv, 1, hd)."""
    b = x.shape[0]
    group = cfg.n_heads // cfg.n_kv_heads
    act = cfg.act_dtype
    q = project_heads(x, attn.wq, act)
    k_new = project_heads(x, attn.wk, act)
    v_new = project_heads(x, attn.wv, act)
    if use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.hd)
    qg = q.reshape(b, cfg.n_kv_heads, group, cfg.hd).to(F32)
    logits = torch.matmul(qg, cache_k.to(F32).transpose(-1, -2)) * scale
    cap = cfg.attn_logit_softcap
    if cap:
        logits = cap * torch.tanh(logits / cap)
    valid = (stored_pos >= 0) & (stored_pos < pos[:, None])
    if cfg.window is not None:
        valid &= stored_pos > (pos[:, None] - cfg.window)
    logits = torch.where(valid[:, None, None, :], logits, -1e30)
    self_logit = torch.matmul(qg, k_new.to(F32).transpose(-1, -2)) * scale
    if cap:
        self_logit = cap * torch.tanh(self_logit / cap)
    m = torch.maximum(logits.amax(dim=-1, keepdim=True), self_logit)
    p_cache = torch.exp(logits - m)
    p_self = torch.exp(self_logit - m)
    l = p_cache.sum(dim=-1, keepdim=True) + p_self
    out = torch.matmul(p_cache, cache_v.to(F32))
    out = (out + p_self * v_new.to(F32)) / torch.clamp(l, min=1e-30)
    out = out.reshape(b, cfg.n_heads, 1, cfg.hd).to(act)
    return merge_heads(out, attn.wo, act), k_new, v_new


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / plain GELU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """A gated MLP, ``wo(act(x wg) * (x wi))``: SwiGLU (``mlp_act='silu'``,
    the dense and MoE configs) or GeGLU (``'gelu'``, recurrentgemma); or
    the plain GELU MLP ``wo(gelu(x wi))`` (``'gelu_mlp'``, whisper), which
    has no ``wg``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        if cfg.mlp_act not in GATED_ACTS + ("gelu_mlp",):
            raise ValueError(f"mlp_act={cfg.mlp_act!r}: one of "
                             f"{GATED_ACTS + ('gelu_mlp',)}")
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.p_dtype
        self.wi = dense_param((d, f), dt, device, gen)
        if cfg.mlp_act in GATED_ACTS:
            self.wg = dense_param((d, f), dt, device, gen)
        self.wo = dense_param((f, d), dt, device, gen)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., k) @ w (k, n)`` with a float32 result from operands of
    their own type (the reference's ``preferred_element_type=float32``).
    On the card bf16 operands go to ``torch.mm(..., out_dtype=float32)``
    as they are, so the weights are never copied to float32; the CPU has
    no such product, so there the operands are upcast first."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        y = torch.mm(x2, w, out_dtype=F32)
    else:
        y = torch.mm(x2.to(F32), w.to(F32))
    return y.reshape(*x.shape[:-1], w.shape[-1])


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (n, i, k) @ b (n, k, j)`` with a float32 result, as
    ``matmul_f32``: on the card bf16 operands go to ``torch.bmm(...,
    out_dtype=float32)``; the CPU upcasts them first."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=F32)
    return torch.bmm(a.to(F32), b.to(F32))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the erf form)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def mlp_apply(mlp: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The input products stay in float32 through the activation and are
    rounded once to ``act_dtype`` before ``wo``, as the reference does;
    ``wo`` too sums in float32 and rounds once."""
    h = matmul_f32(x, mlp.wi)
    if cfg.mlp_act == "gelu_mlp":
        h = gelu(h)
    else:
        act = torch.nn.functional.silu if cfg.mlp_act == "silu" else gelu
        h = act(matmul_f32(x, mlp.wg)) * h
    return matmul_f32(h.to(cfg.act_dtype), mlp.wo).to(cfg.act_dtype)


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.tok = dense_param((cfg.vocab, cfg.d_model), cfg.p_dtype, device,
                               gen, scale=0.02)
        self.head = dense_param((cfg.d_model, cfg.vocab), cfg.p_dtype,
                                device, gen)
        self._head_f32, self._head_f32_key = None, None

    def head_f32(self) -> torch.Tensor:
        """The head in float32.  A bf16 head is cast once and the copy kept
        (2.1 GB at llama3-8b width) until the head is moved or written,
        rather than cast anew on every call."""
        h = self.head
        if h.dtype == F32:
            return h
        key = (h.device, h.data_ptr(), h._version)
        if self._head_f32_key != key:
            self._head_f32 = None           # free the stale copy first
            self._head_f32 = h.detach().to(F32)
            self._head_f32_key = key
        return self._head_f32


def embed_tokens(emb: Embedding, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    return emb.tok[tokens].to(cfg.act_dtype)


def lm_logits(emb: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Float32 logits from a float32 product (any leading dims)."""
    return torch.matmul(x.to(F32), emb.head_f32())
