"""h2o-danube-1.8b [dense]: 24L d2560 32H (GQA kv=8) d_ff=6912 vocab=32000
-- llama+mistral mix with sliding-window attention.  [arXiv:2401.16818; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    window=4096,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="h2o-danube-1.8-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=216,
    vocab=512,
    window=32,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=64,
    loss_chunk=64,
    remat=False,
)
