"""LM substrate: the dense, MoE, SSM and hybrid LMs of the JAX package's
``repro.models``."""
from .config import ModelConfig
from .model import FAMILIES, init_model, model_from_tensors
from .moe import MoE, dispatch_quality, dispatch_spec, moe_apply
from .rglru import (RGLRU, RGLRUCache, init_rglru_cache, rglru_block_apply,
                    rglru_block_decode, rglru_scan)
from .ssm import (Mamba2, SSMCache, init_ssm_cache, mamba2_apply,
                  mamba2_decode, ssd_forward)
from .transformer import (Block, DecoderLM, HybridBlock, HybridLM, SSMBlock,
                          SSMLM, block_ffn, hybrid_layer_kinds)

__all__ = ["Block", "DecoderLM", "FAMILIES", "HybridBlock", "HybridLM",
           "MoE", "Mamba2", "ModelConfig", "RGLRU", "RGLRUCache", "SSMBlock",
           "SSMCache", "SSMLM", "block_ffn", "dispatch_quality",
           "dispatch_spec", "hybrid_layer_kinds", "init_model",
           "init_rglru_cache", "init_ssm_cache", "mamba2_apply",
           "mamba2_decode", "model_from_tensors", "moe_apply",
           "rglru_block_apply", "rglru_block_decode", "rglru_scan",
           "ssd_forward"]
