"""Architecture configuration: one dataclass covers all 10 architectures of
the JAX package (same fields, defaults and parameter count);
``act_dtype`` / ``p_dtype`` are torch dtypes."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # expert-parallel shard_map: number of model-axis ranks the expert
    # weights are pre-blocked for (0 = dense single-device layout).
    # ep > n_experts stores f-slices: (ep, d, f*E/ep).  See models/moe.py.
    ep_shards: int = 0
    # attention
    window: Optional[int] = None          # sliding-window attention
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl
    mlp_act: str = "silu"                 # silu (swiglu) | gelu (geglu) | gelu_mlp
    attn_logit_softcap: Optional[float] = None
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_expand: int = 2
    # hybrid (recurrentgemma): repeating block pattern
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru", "rglru", "attn")
    lru_width: Optional[int] = None
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500
    # VLM stub frontend
    vision_patches: int = 0
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # training
    remat: bool = True
    loss_chunk: int = 512
    attn_chunk: int = 1024
    # beyond-paper perf knobs (hillclimb)
    causal_blocked_attn: bool = False     # compute only causal band chunks
    use_pallas: bool = False
    # shard_map tensor parallelism for output projections: local f32
    # accumulation, bf16 on the wire (halves TP all-reduce bytes)
    tp_shardmap: bool = False
    # sequence-parallel residual stream: the per-layer saved activations
    # (remat carries) shard their seq dim over the model axis -- 16x less
    # live activation memory; the TP all-reduce pair becomes
    # reduce-scatter + all-gather (wire-neutral, overlap-friendly)
    seq_shard: bool = False
    # dry-run accounting: unroll layer scans so XLA cost analysis counts
    # every layer (while-loop bodies are otherwise counted once)
    scan_unroll: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def p_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_headdim

    def n_params(self) -> int:
        """Total parameter count (for roofline MODEL_FLOPS)."""
        return _count_params(self, active_only=False)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k experts only)."""
        return _count_params(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    mats = 3 if cfg.mlp_act in ("silu", "gelu") else 2
    return mats * cfg.d_model * d_ff


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.hd
    q = cfg.d_model * cfg.n_heads * hd
    kv = 2 * cfg.d_model * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * cfg.d_model
    return q + kv + o


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    n = 0
    emb = cfg.vocab * cfg.d_model
    if cfg.family == "ssm":
        d_in = cfg.ssm_inner
        h = cfg.ssm_heads
        conv_dim = d_in + 2 * cfg.ssm_state
        per_layer = (cfg.d_model * (2 * d_in + 2 * cfg.ssm_state + h)  # in_proj
                     + conv_dim * cfg.ssm_conv                          # conv
                     + 3 * h                                            # A, D, dt_bias
                     + d_in                                             # norm
                     + d_in * cfg.d_model)                              # out_proj
        n = cfg.n_layers * per_layer + 2 * emb
        return n
    if cfg.family == "hybrid":
        lw = cfg.lru_width or cfg.d_model
        attn = _attn_params(cfg)
        rec = (2 * cfg.d_model * lw + lw * cfg.ssm_conv                  # in/gate + conv
               + 2 * lw * 1 + 2 * lw                                     # rg-lru gates (diag blocks approx)
               + lw * cfg.d_model)
        mlp = _mlp_params(cfg, cfg.d_ff)
        pat = cfg.block_pattern or ("rglru",)
        per_cycle = sum(attn if b == "attn" else rec for b in pat) + len(pat) * mlp
        n_cycles = cfg.n_layers / len(pat)
        n = int(n_cycles * per_cycle) + 2 * emb
        return n
    # transformer families
    attn = _attn_params(cfg)
    if cfg.n_experts > 0:
        e = cfg.top_k if active_only else cfg.n_experts
        mlp = e * _mlp_params(cfg, cfg.d_ff) + cfg.d_model * cfg.n_experts
    else:
        mlp = _mlp_params(cfg, cfg.d_ff)
    per_layer = attn + mlp + 2 * cfg.d_model
    n = cfg.n_layers * per_layer + 2 * emb
    if cfg.family == "encdec":
        # encoder layers: self-attn + mlp; decoder adds cross-attn
        enc = cfg.enc_layers * (attn + _mlp_params(cfg, cfg.d_ff) + 2 * cfg.d_model)
        dec_cross = cfg.n_layers * attn
        n += enc + dec_cross
    return n
