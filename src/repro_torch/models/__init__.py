"""LM substrate: the dense, MoE, VLM, encoder-decoder, SSM and hybrid
LMs of the JAX package's ``repro.models``."""
from .config import ModelConfig
from .model import (FAMILIES, hidden_fn, init_model, loss_fn,
                    model_from_tensors)
from .moe import MoE, dispatch_quality, dispatch_spec, moe_apply
from .rglru import (RGLRU, RGLRUCache, init_rglru_cache, rglru_block_apply,
                    rglru_block_decode, rglru_scan)
from .ssm import (Mamba2, SSMCache, init_ssm_cache, mamba2_apply,
                  mamba2_decode, ssd_forward)
from .transformer import (Block, DecBlock, DecoderLM, EncBlock, EncDecLM,
                          HybridBlock, HybridLM, SSMBlock, SSMLM, block_ffn,
                          decoder_hidden, decoder_inputs, decoder_loss,
                          encdec_hidden, encdec_loss, encoder_apply,
                          hybrid_hidden, hybrid_layer_kinds, hybrid_loss,
                          ssm_hidden, ssm_loss)

__all__ = ["Block", "DecBlock", "DecoderLM", "EncBlock", "EncDecLM",
           "FAMILIES", "HybridBlock", "HybridLM",
           "MoE", "Mamba2", "ModelConfig", "RGLRU", "RGLRUCache", "SSMBlock",
           "SSMCache", "SSMLM", "block_ffn", "decoder_hidden",
           "decoder_inputs", "decoder_loss", "dispatch_quality",
           "dispatch_spec", "encdec_hidden", "encdec_loss", "encoder_apply",
           "hidden_fn", "hybrid_hidden", "hybrid_layer_kinds", "hybrid_loss",
           "init_model", "loss_fn",
           "init_rglru_cache", "init_ssm_cache", "mamba2_apply",
           "mamba2_decode", "model_from_tensors", "moe_apply",
           "rglru_block_apply", "rglru_block_decode", "rglru_scan",
           "ssd_forward", "ssm_hidden", "ssm_loss"]
