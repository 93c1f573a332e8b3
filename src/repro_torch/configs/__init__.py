"""Architecture configs (``get_config`` / ``get_smoke``).

Each module exports ``CONFIG`` (the full-scale config) and ``SMOKE`` (a
reduced config of the same family for CPU tests), verbatim from the JAX
package: the dense family (``llama3_8b``, the two sliding-window
``h2o_danube`` configs, ``command_r_plus_104b``), the MoE family
(``phi35_moe_42b``, ``grok_1_314b``), the encoder-decoder
(``whisper_medium``), the VLM (``qwen2_vl_72b``), the SSM family
(``mamba2_1_3b``) and the hybrid family (``recurrentgemma_2b``).
``SHAPES``, ``LONG_OK`` and ``cells()`` are the dry-run's shape cells
(``launch/dryrun.py``), the JAX package's registry.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

# the JAX package's order
ARCH_IDS = [
    "grok_1_314b",
    "phi35_moe_42b",
    "recurrentgemma_2b",
    "h2o_danube3_4b",
    "llama3_8b",
    "h2o_danube_1_8b",
    "command_r_plus_104b",
    "whisper_medium",
    "qwen2_vl_72b",
    "mamba2_1_3b",
]

# shape cells: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# long_500k only for the sub-quadratic attention archs
LONG_OK = {"recurrentgemma_2b", "h2o_danube3_4b", "h2o_danube_1_8b",
           "mamba2_1_3b"}


def cells():
    """All runnable (arch, shape) dry-run cells."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES
            if s != "long_500k" or a in LONG_OK]


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(f"architecture {arch!r}: one of {ARCH_IDS}")
    return importlib.import_module(f".{arch}", __name__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
