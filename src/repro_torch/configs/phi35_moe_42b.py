"""phi3.5-moe-42b-a6.6b [moe]: 32L d4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]

16 experts divide the 16-way model axis exactly -> true expert parallelism
("expert" -> model), the showcase arch for the paper's balanced dispatch.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab=512,
    n_experts=16,
    top_k=2,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=64,
    loss_chunk=64,
    remat=False,
)
