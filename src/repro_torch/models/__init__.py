"""LM substrate: the dense and MoE decoders of the JAX package's
``repro.models``."""
from .config import ModelConfig
from .model import init_model, model_from_tensors
from .moe import MoE, dispatch_quality, dispatch_spec, moe_apply
from .transformer import Block, DecoderLM, block_ffn

__all__ = ["Block", "DecoderLM", "MoE", "ModelConfig", "block_ffn",
           "dispatch_quality", "dispatch_spec", "init_model",
           "model_from_tensors", "moe_apply"]
