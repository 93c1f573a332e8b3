"""Pieces of the benchmark found by name: ``bench/<kind>/<name>.py``,
loaded as a module.  A later cell, configuration, traffic mix or metric
brings its own file and edits none that is there."""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict

BENCH = Path(__file__).resolve().parent
_LOADED: Dict[Path, ModuleType] = {}


def path_of(kind: str, name: str) -> Path:
    return BENCH / kind / f"{name}.py"


def load(kind: str, name: str) -> ModuleType:
    path = path_of(kind, name)
    if path not in _LOADED:
        if not path.is_file():
            raise KeyError(f"no {kind} piece named {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
