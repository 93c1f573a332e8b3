"""h2o-danube-3-4b [dense]: 24L d3840 32H (GQA kv=8) d_ff=10240
vocab=32000 -- llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab=32000,
    window=4096,                      # SWA
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="h2o-danube-3-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=320,
    vocab=512,
    window=32,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=64,
    loss_chunk=64,
    remat=False,
)
