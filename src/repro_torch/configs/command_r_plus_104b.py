"""command-r-plus-104b [dense]: 64L d12288 96H (GQA kv=8) d_ff=33792
vocab=256000 -- GQA, no biases.  [hf:CohereForAI/c4ai-command-r-v01;
unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab=256000,
    rope_theta=75000000.0,
)

SMOKE = ModelConfig(
    name="command-r-smoke",
    family="dense",
    n_layers=2,
    d_model=192,
    n_heads=12,
    n_kv_heads=2,
    head_dim=16,
    d_ff=528,
    vocab=512,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=64,
    loss_chunk=64,
    remat=False,
)
