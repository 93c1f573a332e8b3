"""LM substrate: the dense, MoE, VLM, encoder-decoder, SSM and hybrid
LMs of the JAX package's ``repro.models``."""
from .config import ModelConfig
from .model import FAMILIES, init_model, model_from_tensors
from .moe import MoE, dispatch_quality, dispatch_spec, moe_apply
from .rglru import (RGLRU, RGLRUCache, init_rglru_cache, rglru_block_apply,
                    rglru_block_decode, rglru_scan)
from .ssm import (Mamba2, SSMCache, init_ssm_cache, mamba2_apply,
                  mamba2_decode, ssd_forward)
from .transformer import (Block, DecBlock, DecoderLM, EncBlock, EncDecLM,
                          HybridBlock, HybridLM, SSMBlock, SSMLM, block_ffn,
                          decoder_hidden, decoder_inputs, encoder_apply,
                          hybrid_layer_kinds)

__all__ = ["Block", "DecBlock", "DecoderLM", "EncBlock", "EncDecLM",
           "FAMILIES", "HybridBlock", "HybridLM",
           "MoE", "Mamba2", "ModelConfig", "RGLRU", "RGLRUCache", "SSMBlock",
           "SSMCache", "SSMLM", "block_ffn", "decoder_hidden",
           "decoder_inputs", "dispatch_quality", "dispatch_spec",
           "encoder_apply", "hybrid_layer_kinds", "init_model",
           "init_rglru_cache", "init_ssm_cache", "mamba2_apply",
           "mamba2_decode", "model_from_tensors", "moe_apply",
           "rglru_block_apply", "rglru_block_decode", "rglru_scan",
           "ssd_forward"]
