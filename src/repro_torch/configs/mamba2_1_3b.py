"""mamba2-1.3b [ssm]: 48L d2048 (attention-free) vocab=50280,
ssm_state=128 -- SSD (state-space duality).  [arXiv:2405.21060; unverified]

d_inner = 2*d_model = 4096, headdim 64 -> 64 SSD heads; chunk 256.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,        # unused by the ssm family
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_chunk=256,
    ssm_expand=2,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=128,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=512,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=32,
    ssm_expand=2,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=64,
    loss_chunk=64,
    remat=False,
)
