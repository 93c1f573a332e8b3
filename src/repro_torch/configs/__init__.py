"""Architecture configs (``get_config`` / ``get_smoke``).

Each module exports ``CONFIG`` (the full-scale config) and ``SMOKE`` (a
reduced config of the same family for CPU tests), verbatim from the JAX
package.  Only ``llama3_8b`` (the dense family) is ported so far; the
other nine architectures wait in ROADMAP.md.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCH_IDS = ["llama3_8b"]


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
