"""LM substrate: the dense decoder of the JAX package's ``repro.models``."""
from .config import ModelConfig
from .model import init_model, model_from_tensors
from .transformer import Block, DecoderLM

__all__ = ["Block", "DecoderLM", "ModelConfig", "init_model",
           "model_from_tensors"]
