"""Architecture configs (``get_config`` / ``get_smoke``).

Each module exports ``CONFIG`` (the full-scale config) and ``SMOKE`` (a
reduced config of the same family for CPU tests), verbatim from the JAX
package.  The dense family (``llama3_8b``, the two sliding-window
``h2o_danube`` configs, ``command_r_plus_104b``) and the MoE family
(``phi35_moe_42b``, ``grok_1_314b``) are ported; the SSM, hybrid,
encoder-decoder and VLM architectures wait in ROADMAP.md.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

# the JAX package's order, less the architectures not ported yet
ARCH_IDS = [
    "grok_1_314b",
    "phi35_moe_42b",
    "h2o_danube3_4b",
    "llama3_8b",
    "h2o_danube_1_8b",
    "command_r_plus_104b",
]


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet (ported: {ARCH_IDS}; "
            "ROADMAP.md, queue 1, item 10 lists the rest)")
    return importlib.import_module(f".{arch}", __name__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
