"""grok-1-314b [moe]: 64L d6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]

Sharding: 8 experts do not divide the 16-way model axis, so experts are
tensor-sharded over d_ff ("mlp" -> model) instead of expert-parallel
(DESIGN.md section 5).  Attention logit softcap 30 per the released impl.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
    attn_logit_softcap=30.0,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="grok-1-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab=512,
    n_experts=8,
    top_k=2,
    attn_logit_softcap=30.0,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=64,
    loss_chunk=64,
    remat=False,
)
