"""qwen2-vl-72b [vlm]: 80L d8192 64H (GQA kv=8) d_ff=29568 vocab=152064
-- M-RoPE, dynamic resolution; ViT frontend is a STUB (input_specs
provides precomputed patch embeddings).  [arXiv:2409.12191; hf]

M-RoPE sections (t, h, w) = (16, 24, 24) half-dims of head_dim 128.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    mrope_sections=(16, 24, 24),
    rope_theta=1000000.0,
    vision_patches=256,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab=512,
    mrope_sections=(4, 2, 2),
    vision_patches=16,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=64,
    loss_chunk=64,
    remat=False,
)
