"""whisper-medium [audio]: 24L d1024 16H (MHA kv=16) d_ff=4096 vocab=51865
-- encoder-decoder; conv frontend is a STUB (input_specs provides
precomputed frame embeddings, 1500 frames).  [arXiv:2212.04356; unverified]

24 encoder + 24 decoder layers (whisper-medium's actual layout; the
assignment's "24L" is interpreted per stack).  Sinusoidal positions
(parameter-free) instead of learned ones so any decode length lowers.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    enc_layers=24,
    enc_seq=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    mlp_act="gelu_mlp",               # plain GELU MLP (2 matrices)
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    n_layers=2,
    enc_layers=2,
    enc_seq=64,
    d_model=128,
    n_heads=8,
    n_kv_heads=8,
    head_dim=16,
    d_ff=256,
    vocab=512,
    mlp_act="gelu_mlp",
    dtype="float32",
    param_dtype="float32",
    attn_chunk=64,
    loss_chunk=64,
    remat=False,
)
