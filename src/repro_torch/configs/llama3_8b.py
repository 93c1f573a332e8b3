"""llama3-8b [dense]: 32L d4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
[arXiv:2407.21783; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama3-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=448,
    vocab=512,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=64,
    loss_chunk=64,
    remat=False,
)
