"""recurrentgemma-2b [hybrid]: 26L d2560 10H (MQA kv=1) d_ff=7680
vocab=256000 -- RG-LRU + local attention, pattern 1 attn : 2 recurrent.
[arXiv:2402.19427; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    window=2048,                      # local attention window
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=2560,
    mlp_act="gelu",                   # GeGLU
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab=512,
    window=32,
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=128,
    mlp_act="gelu",
    dtype="float32",
    param_dtype="float32",
    attn_chunk=64,
    loss_chunk=64,
    remat=False,
)
