"""Checkpoint save / restore with an async writer.  Counterpart of
``repro/train/checkpoint.py``, with its on-disk layout:

    <path>/step_XXXXXXXX/<key with '/' as '__'>.npy   one array a leaf
    <path>/step_XXXXXXXX/manifest.json   {"step", "arrays": {key: {file,
                                          axes, dtype}}, "extra"}
    <path>/latest                        "step_XXXXXXXX", replaced
                                         atomically after the step's
                                         files are written

Keys are the leaves' paths joined by '/': dict keys, tuple indices (an
``OptState`` is ``0`` step, ``1`` m, ``2`` v, as in the JAX package's
tree) and, under a model, its parameter names (``layers.0.attn.wq``).

A data-parallel run whose moments are sharded ZeRO-style
(``optimizer.zero_shards``) writes the same full layout
(``save_sharded``: each moment gathered leaf by leaf, rank 0 writes,
then a barrier), so any run can resume it; ``restore_sharded`` reads a
checkpoint onto a rank of a data group of any size, re-slicing the
moments (the reference's elastic restart onto another mesh).  On a model
axis the model-parallel leaves are this rank's slices: ``save_sharded``
all-gathers them, and their moments, over the model group too, and
``restore_sharded`` cuts each rank's slices, so a checkpoint moves
between any two ``(d, m)`` meshes.
The port's leaves carry no logical axes (``"axes": null``).  bfloat16
arrays are written as the JAX package writes them -- raw 2-byte words
with descr ``'<V2'`` -- and read back by the manifest's dtype, so no
bfloat16 numpy type is needed on either side.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..distributed.sharding import narrow, unslice
from .optimizer import (AdamWConfig, OptState, Shard, _local, gather_moment,
                        named)

_SEP = "/"
_BF16 = "bfloat16"


def _flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """The leaves of ``tree`` (dicts, lists, tuples, models; tensors,
    numpy arrays and Python numbers as leaves; None skipped) by path."""
    def key(k):
        return f"{prefix}{_SEP}{k}" if prefix else str(k)
    if isinstance(tree, torch.nn.Module):
        return {key(n): p for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(_flatten_with_paths(v, key(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten_with_paths(v, key(i)))
        return out
    if tree is None:
        return {}
    return {prefix: tree}


def _host(leaf) -> Any:
    """A leaf as a host copy: a CPU tensor (bf16 kept), or a numpy array
    (an int becomes int32, as the JAX package's step counter)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32)
    return np.array(leaf, copy=True)


def _write_npy(fname: str, leaf) -> str:
    """Write one host leaf; returns the manifest's dtype name."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        raw = leaf.contiguous().view(torch.int16).numpy()
        with open(fname, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": raw.shape})
            f.write(raw.tobytes())
        return _BF16
    arr = leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf
    np.save(fname, arr)
    return str(arr.dtype)


def _read_npy(fname: str, dtype: str) -> torch.Tensor:
    """One array of a checkpoint as a CPU tensor; ``dtype`` is the
    manifest's (bfloat16 files hold raw 2-byte words)."""
    arr = np.load(fname)
    if dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _write(path: str, step: int, flat: Dict[str, Any],
           extra: Optional[Dict]) -> None:
    d = os.path.join(path, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    manifest = {"step": step, "arrays": {}, "extra": extra or {}}
    for key, leaf in flat.items():
        fname = key.replace(_SEP, "__") + ".npy"
        dtype = _write_npy(os.path.join(d, fname), leaf)
        manifest["arrays"][key] = {"file": fname, "axes": None,
                                   "dtype": dtype}
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # atomic "latest" pointer
    with open(os.path.join(path, "latest.tmp"), "w") as f:
        f.write(f"step_{step:08d}")
    os.replace(os.path.join(path, "latest.tmp"), os.path.join(path, "latest"))


def save(path: str, step: int, tree, extra: Optional[Dict] = None) -> None:
    """Synchronous checkpoint write of ``tree`` as step ``step``."""
    _write(path, step, {k: _host(v) for k, v in
                        _flatten_with_paths(tree).items()}, extra)


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, write in a background
    thread (at most one write in flight)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def save_async(self, path: str, step: int, tree,
                   extra: Optional[Dict] = None) -> None:
        self.wait()
        snap = {k: _host(v) for k, v in _flatten_with_paths(tree).items()}
        self._thread = threading.Thread(
            target=_write, args=(path, step, snap, extra), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(path: str) -> Optional[int]:
    try:
        with open(os.path.join(path, "latest")) as f:
            return int(f.read().strip().split("_")[1])
    except (FileNotFoundError, IndexError, ValueError):
        return None


def read_checkpoint(path: str, step: Optional[int] = None
                    ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """(step, every array of the checkpoint by key as a CPU tensor);
    ``step=None`` reads the newest."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    return step, {k: _read_npy(os.path.join(d, m["file"]), m["dtype"])
                  for k, m in manifest["arrays"].items()}


def restore(path: str, step: Optional[int] = None, template=None
            ) -> Tuple[int, Any]:
    """Load a checkpoint: (step, the flat dict of CPU tensors) without
    ``template``; with one, the arrays poured into its structure -- a
    model's parameters and any tensor leaf are written in place (on
    their device, in their dtype), Python ints come back as ints, and
    dicts, lists and tuples (``OptState`` included) are rebuilt."""
    step, arrays = read_checkpoint(path, step)
    if template is None:
        return step, arrays
    missing = set(_flatten_with_paths(template)) - set(arrays)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}")

    def fill(prefix, node):
        def key(k):
            return f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(node, torch.nn.Module):
            with torch.no_grad():
                for n, p in node.named_parameters():
                    p.copy_(arrays[key(n)])
            return node
        if isinstance(node, dict):
            return {k: fill(key(k), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [fill(key(i), v) for i, v in enumerate(node)]
            return (type(node)(*vals) if hasattr(node, "_fields")
                    else type(node)(vals))
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            with torch.no_grad():
                node.copy_(arrays[prefix])
            return node
        if isinstance(node, (bool, int)):
            return int(arrays[prefix])
        return arrays[prefix].numpy()

    return step, fill("", template)


def save_sharded(path: str, step: int, lm: torch.nn.Module,
                 opt: OptState, ocfg: AdamWConfig,
                 shards: Optional[Dict[str, Shard]], data,
                 extra: Optional[Dict] = None, *, model=None,
                 slices: Optional[Dict] = None) -> None:
    """Checkpoint a data- and model-parallel run as ``save(path, step,
    {"params": lm, "opt": opt})`` of one rank would: each moment
    gathered whole over the data group (``shards``), one leaf at a time
    (so no rank holds every whole moment on its device), then each
    model-parallel leaf and its moments over the model group
    (``model``, ``slices``); the rank at data and model index 0 writes,
    then a barrier.  Every rank of the mesh calls it."""
    dt = getattr(torch, ocfg.adam_dtype)
    params = named(lm)
    slices = slices or {}
    lead = ((data is None or data.rank == 0)
            and (model is None or model.rank == 0))
    flat: Dict[str, Any] = {}
    for n, p in params.items():
        whole = unslice(p, slices.get(n), model)
        if lead:
            flat[f"params{_SEP}{n}"] = _host(whole)
    flat[f"opt{_SEP}0"] = _host(opt.step)
    for i, d in ((1, opt.m), (2, opt.v)):
        for n, p in params.items():
            local = (d[n] if shards is None
                     else gather_moment(d.get(n), p, shards[n], data, dt))
            whole = unslice(local, slices.get(n), model)
            if lead:
                flat[f"opt{_SEP}{i}{_SEP}{n}"] = _host(whole)
            del whole, local
    if lead:
        _write(path, step, flat, extra)
    # the model group first: then every rank of the data groups waits
    # for a rank that waited for the writer
    for group in (model, data):
        if group is not None:
            group.barrier()


def restore_sharded(path: str, lm: torch.nn.Module, ocfg: AdamWConfig,
                    shards: Optional[Dict[str, Shard]], rank: int,
                    step: Optional[int] = None, *,
                    slices: Optional[Dict] = None) -> Tuple[int, OptState]:
    """Load a checkpoint in the full layout onto data rank ``rank``: the
    model's parameters (whole, or this model rank's ``slices`` of them)
    in place, and this rank's part of each moment of those (``shards``,
    of any data group's size; None: whole), cut on the host.  Returns
    (step, this rank's ``OptState``)."""
    step, arrays = read_checkpoint(path, step)
    dt = getattr(torch, ocfg.adam_dtype)
    params = named(lm)
    slices = slices or {}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(narrow(arrays[f"params{_SEP}{n}"], slices.get(n)))
    shards = shards or {n: Shard() for n in params}
    parts = [{n: _local(narrow(arrays[f"opt{_SEP}{i}{_SEP}{n}"],
                               slices.get(n)), shards[n]).to(
                  p.device, dt).contiguous()
              for n, p in params.items() if shards[n].mine(rank)}
             for i in (1, 2)]
    return step, OptState(int(arrays[f"opt{_SEP}0"]), *parts)
