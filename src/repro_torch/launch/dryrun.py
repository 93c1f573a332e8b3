"""Production dry-run of every (arch x shape x mesh) cell.  Counterpart
of ``repro/launch/dryrun.py``.

The reference lowers each cell's step with XLA, without allocating, and
reads the lowering's cost analysis, the compiled module's memory
analysis and its post-SPMD HLO.  Here the counterpart of "lower without
allocating" is a step traced on the meta device: tensors with shapes and
types and no data, the model built with ``init_model(..., device=
"meta", slices=)``.  Per cell:

  A. **FLOPs and bytes** -- the unsharded step at the full global batch
     (the reference lowers it without the mesh) under
     ``torch.utils.flop_counter.FlopCounterMode`` and ``OpCounter``, a
     ``TorchDispatchMode`` that sums every op's input and output bytes
     (views excluded): ``flops_global`` and ``bytes_global_unfused``, the
     counterpart of XLA's unoptimised ``bytes accessed`` (every op reads
     its inputs and writes its output; nothing is fused).
     ``FlopCounterMode`` counts the matrix products and attention only,
     not the elementwise work XLA's cost analysis adds.
  B. **Memory and collectives of one device** -- rank 0's step on the
     production mesh (``launch.mesh.make_production_mesh``): the model
     rank's slices (``distributed.sharding.model_slices``), the ZeRO
     moments (``train.zero_shards``), the rank's rows of the batch, and
     ``distributed.DryComm`` data and model groups (16, or 32 with the
     pod axis, and 16 ranks) whose other ranks do not exist.  It gives
     ``memory_per_device`` (``argument_bytes``, ``output_bytes`` and
     ``alias_bytes`` from the rank's tensors; ``temp_bytes``, the peak of
     the bytes allocated within the step and still live, which
     ``OpCounter`` tracks), ``collective_bytes_per_device`` (the
     ``DryComm`` counters, by kind, with ``launch/hlo_analysis.py``'s
     result-shape accounting) and ``compiled_flops_per_device_u1``.

Every cell runs under the port's rules, adapted to the model axis of 16
(``launch.mesh.train_rules`` for train cells, ``launch.mesh.serve_rules``
for prefill and decode cells: the KV cache's sequence on "model").  A
prefill attends through the flash kernel (``cfg.use_pallas``), as
serving does: on the meta device a twin of the kernel returns its output
and counts its FLOPs (4 d per attended (query, key) pair and head) and
bytes itself, since the profiler cannot see inside a kernel.

``run_cell(..., device=None)`` (the card) then runs rank 0's step of the
cell on the H100 with loopback ``DryComm`` groups and records
``step_s`` (CUDA events) and ``peak_bytes`` (``max_memory_allocated``)
beside the prediction: the counterpart of the reference's compile proof
of fit.  ``device="meta"`` counts only.  Nothing here touches XLA or
JAX.

Usage (``--device meta`` on the CPU; the card by default):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device meta \\
        --arch llama3_8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device meta \\
        --all --out results/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import time
import traceback
import weakref
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_IDS, LONG_OK, SHAPES, get_config
from ..distributed import DryComm
from ..distributed.comm import KINDS
from ..distributed.sharding import model_slices
from ..models import ModelConfig, init_model, loss_fn
from ..models import layers as _layers
from ..serve import decode as serve_decode
from ..train import AdamWConfig, adamw_update, init_opt_state, zero_shards
from ..train.train_step import sum_grads
from .mesh import (ProductionMesh, make_production_mesh, serve_rules,
                   train_rules)
from .roofline import H100, Hardware

F32 = torch.float32


# ---------------------------------------------------------------------------
# input specs (shapes and types, never allocated)
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    """A model input's shape and type (the reference's
    ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def shape_of(shape_name) -> Tuple[int, int, str]:
    """(seq_len, global_batch, kind) of a ``SHAPES`` name, or the tuple
    itself (a cell cut to a size a test runs for real)."""
    return SHAPES[shape_name] if isinstance(shape_name, str) \
        else tuple(shape_name)


def input_specs(arch: str, shape_name, cfg: ModelConfig) -> Dict:
    """Model inputs of a cell at its global batch, as ``TensorSpec``s."""
    seq, gb, kind = shape_of(shape_name)
    i32 = torch.int32
    if kind in ("train", "prefill"):
        batch = {}
        s_text = seq
        if cfg.family == "vlm":
            n_p = cfg.vision_patches
            s_text = seq - n_p
            batch["patch_embeds"] = TensorSpec((gb, n_p, cfg.d_model),
                                               cfg.act_dtype)
        if cfg.family == "encdec":
            batch["frames"] = TensorSpec((gb, cfg.enc_seq, cfg.d_model),
                                         cfg.act_dtype)
        batch["tokens"] = TensorSpec((gb, s_text), i32)
        if kind == "train":
            batch["labels"] = TensorSpec((gb, s_text), i32)
        return batch
    return {"tokens": TensorSpec((gb, 1), i32)}


def make_inputs(specs: Dict, rows: int, device, vocab: int
                ) -> Dict[str, torch.Tensor]:
    """The first ``rows`` rows of each input: random tokens below
    ``vocab`` and normal embeddings from seed 0 (empty on meta)."""
    dev = torch.device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(0))
    out = {}
    for k, sp in specs.items():
        shape = (rows,) + tuple(sp.shape[1:])
        if gen is None:
            out[k] = torch.empty(shape, dtype=sp.dtype, device=dev)
        elif sp.dtype == torch.int32:
            out[k] = torch.randint(0, vocab, shape, generator=gen,
                                   device=dev, dtype=sp.dtype)
        else:
            out[k] = torch.randn(shape, generator=gen, device=dev,
                                 dtype=F32).to(sp.dtype)
    return out


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------

def _dryrun_cfg(cfg: ModelConfig, unroll: bool) -> ModelConfig:
    kw = dict(dtype="bfloat16", param_dtype="bfloat16", remat=True,
              scan_unroll=unroll, tp_shardmap=True,
              causal_blocked_attn=True)
    if cfg.n_experts > 0:
        kw["ep_shards"] = 16   # expert parallelism on the model axis
    return cfg.replace(**kw)


def cfg_accum(cfg: ModelConfig) -> int:
    """Gradient-accumulation depth for train cells: larger models need
    smaller live microbatches."""
    n = cfg.n_params()
    if n > 60e9:
        return 8
    if n > 3e9:
        return 4
    return 2


def adam_dtype(cfg: ModelConfig, hw: Hardware = H100) -> str:
    """The moments' type: the reference's rule (bf16 where 16 bytes a
    parameter exceed 80 % of a pod's 256 devices' memory) on the card's
    memory (``hw.hbm_bytes``)."""
    return "bfloat16" if cfg.n_params() * 16 > 256 * hw.hbm_bytes * 0.8 \
        else "float32"


class Cell(NamedTuple):
    """One cell's step, ready to run: ``step()`` runs it on ``args`` (the
    step's inputs, by name: ``params``, ``opt``, ``batch``, ``state``) and
    returns its outputs; ``aliased`` names the inputs it updates in
    place.  ``data`` / ``model``: the rank's ``DryComm`` groups (None for
    the unsharded step).  ``accum``: a train step's microbatches (1
    otherwise); ``step(micro=k, on_micro=f)`` runs only the first k of
    them (the update scaled as for all) and calls ``f(i)`` after each."""
    step: Callable
    args: Dict
    aliased: Tuple[str, ...]
    rules: Dict
    cfg: ModelConfig
    data: Optional[DryComm]
    model: Optional[DryComm]
    accum: int = 1


def _accumulated_grads(lm, params, batch, cfg, accum, data, model,
                       micro=None, on_micro=None):
    """Microbatched gradients of ``loss_fn``: float32 sums over ``accum``
    microbatches of this rank's rows, scaled by 1 / accum (the rank's
    own dtype for ``accum = 1``); ``micro``: only the first that many
    (``count_step``'s sample), ``on_micro(i)`` after each."""
    names, leaves = zip(*params.items())
    rows = next(iter(batch.values())).shape[0]
    if rows % accum:
        raise ValueError(f"{rows} rows do not split into {accum} "
                         "microbatches")
    per = rows // accum
    grads, loss = None, None
    with torch.enable_grad():
        for i in range(accum if micro is None else min(micro, accum)):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            li = loss_fn(lm, mb, cfg, data=data, model=model)
            gi = torch.autograd.grad(li, leaves)
            li = li.detach()
            if accum <= 1:
                return li, dict(zip(names, gi))
            if grads is None:
                grads = [g.to(F32) for g in gi]
                loss = li
            else:
                for a, g in zip(grads, gi):
                    a.add_(g.to(F32))
                loss = loss + li
            del gi
            if on_micro is not None:
                on_micro(i)
    for g in grads:
        g.mul_(1.0 / accum)
    return loss / accum, dict(zip(names, grads))


def build_cell(arch: str, shape_name, *, multi_pod: bool, unroll: bool,
               cfg_override: Optional[ModelConfig] = None,
               rules_override: Optional[Dict] = None,
               rank: Optional[int] = 0, device="meta",
               mesh: Optional[ProductionMesh] = None,
               comms: Optional[Tuple] = None,
               accum: Optional[int] = None) -> Cell:
    """The step of one cell: rank ``rank`` of the production mesh (its
    slices, moments and rows, ``DryComm`` groups), or with ``rank=None``
    the unsharded step at the global batch.  ``mesh`` replaces the
    production mesh and ``comms`` the ``DryComm``s with a real rank's
    (data, model) groups: a cell a test runs for real; ``accum`` replaces
    ``cfg_accum``'s depth."""
    base = cfg_override or get_config(arch)
    cfg = _dryrun_cfg(base, unroll)
    seq, gb, kind = shape_of(shape_name)
    if kind == "prefill":
        cfg = cfg.replace(use_pallas=True)      # the flash kernel
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    m_size = mesh.axis_size("model")
    d_size = mesh.size // m_size
    dev = torch.device(device)
    if rank is None:
        data = model = None
        m_size = d_size = 1
    elif comms is not None:
        data, model = comms
    else:
        # rank r at data index r // m and model index r % m (the pod axis
        # folds into the data groups: the batch is over (pod, data))
        data = DryComm(rank // m_size, d_size, device=dev)
        model = DryComm(rank % m_size, m_size, device=dev)
    if kind == "train":
        rules = dict(rules_override or train_rules(cfg, m_size))
    else:
        rules = dict(rules_override or serve_rules(
            cfg, m_size, multi_pod=multi_pod, batch=gb))
    slices = (None if model is None
              else model_slices(cfg, rules, m_size, model.rank))
    lm = init_model(cfg, seed=None if dev.type == "meta" else 0,
                    device=dev, slices=slices)
    split = frozenset(n for n, s in (slices or {}).items() if s is not None)
    specs = input_specs(arch, shape_name, cfg)
    batch_on_data = rules.get("batch") is not None and d_size > 1
    rows = gb // d_size if (data is not None and batch_on_data) else gb
    if data is not None and batch_on_data and gb % d_size:
        raise ValueError(f"{gb} rows do not split over {d_size} data ranks")
    batch = make_inputs(specs, rows, dev, cfg.vocab)
    params = dict(lm.named_parameters())
    mdl = {} if model is None else {"model": model, "slices": slices}

    if kind == "train":
        ocfg = AdamWConfig(adam_dtype=adam_dtype(cfg))
        shards = (None if data is None else
                  zero_shards(cfg, lm, rules, data.size, data.rank))
        opt = init_opt_state(lm, ocfg, shards,
                             0 if data is None else data.rank)
        accum = accum or cfg_accum(cfg)
        args = {"params": params, "opt": opt, "batch": batch}

        def train_step(micro=None, on_micro=None):
            lm.requires_grad_(True)
            loss, grads = _accumulated_grads(lm, params, batch, cfg, accum,
                                             data, model, micro, on_micro)
            lm.requires_grad_(False)
            if data is not None:
                sum_grads(grads, data)
                loss = data.psum(loss)
            new_opt, info = adamw_update(params, grads, args["opt"], ocfg,
                                         shards=shards, data=data,
                                         model=model, split=split)
            del grads
            args["opt"] = new_opt
            return {"loss": loss, **info}
        return Cell(train_step, args, ("params", "opt"), rules, cfg, data,
                    model, accum)

    if kind == "prefill":
        args = {"params": params, "batch": batch}

        def prefill_step():
            return serve_decode.prefill(lm, batch, cfg, max_seq=seq, **mdl)
        return Cell(prefill_step, args, (), rules, cfg, data, model)

    state = serve_decode.init_decode_state(cfg, rows, seq, device=dev,
                                           model=model)
    args = {"params": params, "state": state, "batch": batch}

    def serve_step():
        return serve_decode.decode_step(lm, state, batch["tokens"], cfg,
                                        **mdl)
    return Cell(serve_step, args, ("state",), rules, cfg, data, model)


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def nbytes(tree) -> int:
    """The bytes of the tensors of a tree (dicts, lists, tuples,
    dataclasses of tensors), each storage once."""
    seen, total = set(), 0
    for t in _tensors(tree):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


class OpCounter(TorchDispatchMode):
    """Counts every op dispatched within it: ``bytes`` sums each op's
    input and output bytes (view ops, which move nothing, excluded), and
    ``peak`` is the most bytes at once in storages an op created within
    the mode that are still alive (each storage once, however many views
    hold it) -- the step's temporary memory above its arguments.
    ``extra_flops`` collects the FLOPs of kernels the flop counter
    cannot see (the flash kernel's meta twin)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.extra_flops = 0
        self._refs: Dict[int, int] = {}
        self._size: Dict[int, int] = {}

    def _drop(self, key: int) -> None:
        self._refs[key] -= 1
        if self._refs[key] == 0:
            del self._refs[key]
            self.live -= self._size.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            key = t.untyped_storage()._cdata
            if key not in self._refs:
                if key in in_keys:      # an argument's storage, or a view
                    continue
                self._refs[key] = 0
                self._size[key] = t.untyped_storage().nbytes()
                self.live += self._size[key]
                self.peak = max(self.peak, self.live)
            self._refs[key] += 1
            weakref.finalize(t, self._drop, key)
        return out


def flash_pairs(sq: int, skv: int, causal: bool,
                window: Optional[int]) -> int:
    """The (query, key) pairs one head attends: all of them without a
    mask, else row i's keys ``max(0, i - window + 1) .. i``."""
    if not causal:
        return sq * skv
    w = sq if window is None else min(window, sq)
    # rows 0 .. w-1 attend i + 1 keys, the rest w each
    return w * (w + 1) // 2 + (sq - w) * w


@contextlib.contextmanager
def meta_flash(counter: OpCounter):
    """Within the block, ``models.layers``' flash kernel on meta tensors
    is a twin that returns the kernel's output and adds its FLOPs and
    bytes to ``counter`` (the profiler cannot see inside a kernel)."""
    real = _layers.flash_attention_op

    def twin(q, k, v, *, causal=True, window=None, use_pallas=None):
        if not q.is_meta:
            return real(q, k, v, causal=causal, window=window,
                        use_pallas=use_pallas)
        b, h, sq, d = q.shape
        # the output is the one buffer the kernel allocates
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        counter.extra_flops += 4 * b * h * d * flash_pairs(
            sq, k.shape[2], causal, window)
        counter.bytes += sum(t.numel() * t.element_size() for t in (q, k, v))
        return out
    _layers.flash_attention_op = twin
    try:
        yield
    finally:
        _layers.flash_attention_op = real


def _bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """``bmm``'s FLOPs, its ``out_dtype`` form included (the flop
    counter's own formula takes that argument for its output shape)."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[2]


def count_step(cell: Cell, sample: bool = True) -> Dict:
    """Run ``cell.step()`` (on meta) under the flop counter and
    ``OpCounter``: FLOPs, bytes accessed, peak temporary bytes, the
    argument / output / alias bytes and the ``DryComm`` bytes by kind.

    A train step's microbatches have one shape, so with ``sample`` only
    its first two run: the second's FLOPs, bytes and collective bytes
    stand for each of the ``accum - 2`` not run (the first creates the
    float32 gradient sums the others add to), and the peak, which the
    second reaches with the sums live, stands as it is (a later
    microbatch of a whole step keeps a few kB more alive: within 1 %)."""
    counter = OpCounter()
    flops = FlopCounterMode(display=False,
                            custom_mapping={torch.ops.aten.bmm: _bmm_flop})
    arg_bytes = nbytes(cell.args)
    by_name = {k: nbytes(v) for k, v in cell.args.items()}
    alias = nbytes([cell.args[k] for k in cell.aliased])
    groups = [g for g in (cell.data, cell.model) if g is not None]
    marks = []

    def mark(i):
        marks.append((flops.get_total_flops() + counter.extra_flops,
                      counter.bytes, [dict(g.bytes_by_kind) for g in groups]))
    skip = cell.accum - 2 if sample and cell.accum > 2 else 0
    with meta_flash(counter), flops, counter:
        out = cell.step(micro=2, on_micro=mark) if skip else cell.step()
    total = flops.get_total_flops() + counter.extra_flops
    moved = counter.bytes
    if skip:        # the second microbatch's counts, once for each skipped
        (f1, b1, c1), (f2, b2, c2) = marks
        total += skip * (f2 - f1)
        moved += skip * (b2 - b1)
        for g, before, after in zip(groups, c1, c2):
            for k in g.bytes_by_kind:
                g.bytes_by_kind[k] += skip * (after[k] - before[k])
    out_bytes = nbytes([out] + [cell.args[k] for k in cell.aliased])
    return {"flops": total,
            "bytes": moved,
            "argument_bytes_by_name": by_name,
            "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                       "temp_bytes": counter.peak, "alias_bytes": alias},
            "collectives": collective_counts(cell)}


def collective_counts(cell: Cell) -> Dict:
    """The rank's ``DryComm`` bytes by kind (data and model groups
    together) with ``total`` and ``n_while_loops`` (0: a traced step has
    no loops to correct), the reference's keys; ``by_group`` splits them
    per group."""
    groups = {n: g for n, g in (("data", cell.data), ("model", cell.model))
              if g is not None}
    out = {k: float(sum(g.bytes_by_kind[k] for g in groups.values()))
           for k in KINDS}
    out["total"] = float(sum(out[k] for k in KINDS))
    out["n_while_loops"] = 0
    out["by_group"] = {n: dict(g.bytes_by_kind) for n, g in groups.items()}
    return out


def reset_counts(cell: Cell) -> None:
    for g in (cell.data, cell.model):
        if g is not None:
            g.staged_bytes = g.all_to_all_bytes = g.reduce_bytes = 0
            g.reduce_s = 0.0
            g._zero_counts()


# ---------------------------------------------------------------------------
# cell runner: phase A (unsharded, global batch) + phase B (rank 0)
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name, *, multi_pod: bool,
             flops_phase: bool = True,
             cfg_override: Optional[ModelConfig] = None,
             rules_override: Optional[Dict] = None, device=None,
             mesh: Optional[ProductionMesh] = None,
             on_card: Optional[Callable] = None) -> Dict:
    """The record of one cell: phase A (single-pod cells) and phase B on
    meta; with ``device`` the card (None) it then runs rank 0's step
    there (``card_run``; ``on_card(cell, rec)``, if given, sees the
    built cell after it)."""
    seq, gb, kind = shape_of(shape_name)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec: Dict = {"arch": arch, "shape": shape_name, "kind": kind,
                 "multi_pod": multi_pod, "chips": mesh.size,
                 "seq": seq, "global_batch": gb,
                 "mesh": dict(zip(mesh.names, mesh.shape))}
    base = cfg_override or get_config(arch)
    rec["n_params"] = base.n_params()
    rec["n_active_params"] = base.n_active_params()

    if flops_phase and not multi_pod:
        t0 = time.perf_counter()
        cell = build_cell(arch, shape_name, multi_pod=False, unroll=True,
                          cfg_override=cfg_override,
                          rules_override=rules_override, rank=None,
                          mesh=mesh)
        got = count_step(cell)
        del cell
        rec["flops_global"] = float(got["flops"])
        rec["bytes_global_unfused"] = float(got["bytes"])
        rec["t_lower_unrolled_s"] = round(time.perf_counter() - t0, 2)

    t0 = time.perf_counter()
    cell = build_cell(arch, shape_name, multi_pod=multi_pod, unroll=False,
                      cfg_override=cfg_override,
                      rules_override=rules_override, mesh=mesh)
    rec["t_lower_s"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    got = count_step(cell)
    rec["t_compile_s"] = round(time.perf_counter() - t0, 2)
    rec["memory_per_device"] = got["memory"]
    rec["argument_bytes_by_name"] = got["argument_bytes_by_name"]
    coll = got["collectives"]
    rec["collective_bytes_by_group"] = coll.pop("by_group")
    rec["collective_bytes_per_device"] = coll
    rec["compiled_flops_per_device_u1"] = float(got["flops"])
    rec["rules"] = {k: v for k, v in sorted(cell.rules.items())}
    del cell
    if device is None or torch.device(device).type != "meta":
        card_run(arch, shape_name, rec, multi_pod=multi_pod,
                 cfg_override=cfg_override, rules_override=rules_override,
                 device="cuda" if device is None else device,
                 mesh=mesh, on_card=on_card)
    print(json.dumps(rec))
    return rec


def card_run(arch: str, shape_name, rec: Dict, *, multi_pod: bool,
             cfg_override=None, rules_override=None, device="cuda",
             mesh: Optional[ProductionMesh] = None, on_card=None) -> None:
    """Rank 0's step of the cell on ``device`` with loopback ``DryComm``
    groups and random weights from seed 0.  The first step runs with the
    allocator's peak reset, as the meta count's step does (its first
    call builds what later calls keep, such as the LM head's float32
    copy); then a second, timed with CUDA events.  ``rec`` gains
    ``step_s`` (the second step), ``peak_bytes``
    (``max_memory_allocated`` over the first step), ``base_bytes``
    (allocated before it: the cell's arguments and whatever else the
    process holds) and ``card_collectives`` (the second step's
    ``DryComm`` bytes by kind)."""
    dev = torch.device(device)
    cell = build_cell(arch, shape_name, multi_pod=multi_pod, unroll=False,
                      cfg_override=cfg_override,
                      rules_override=rules_override, device=dev,
                      mesh=mesh)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cell.step()
    torch.cuda.synchronize(dev)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    rec["base_bytes"] = base
    reset_counts(cell)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    cell.step()
    t1.record()
    torch.cuda.synchronize(dev)
    coll = collective_counts(cell)
    coll.pop("by_group")
    rec["card_collectives"] = coll
    rec["step_s"] = t0.elapsed_time(t1) / 1e3
    rec["device"] = torch.cuda.get_device_name(dev)
    if on_card is not None:
        on_card(cell, rec)
    del cell


def fix_flops(out_dir: str) -> None:
    """Recompute phase A (flops/bytes) for every existing single-pod
    record in out_dir (used after a phase-A methodology change)."""
    for path in sorted(glob.glob(os.path.join(out_dir, "*__sp.json"))):
        with open(path) as f:
            rec = json.load(f)
        t0 = time.perf_counter()
        got = count_step(build_cell(rec["arch"], rec["shape"],
                                    multi_pod=False, unroll=True, rank=None))
        rec["flops_global"] = float(got["flops"])
        rec["bytes_global_unfused"] = float(got["bytes"])
        rec["t_lower_unrolled_s"] = round(time.perf_counter() - t0, 2)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"fixed {os.path.basename(path)} "
              f"flops={rec['flops_global']:.3e}")


def all_cells(single_pod_only: bool = False, multi_pod_only: bool = False):
    """(arch, shape, multi_pod) of ``--all``: every ``configs.cells()``
    cell on each mesh asked for, the hybrid's last (as the reference
    orders them)."""
    order = [a for a in ARCH_IDS if a != "recurrentgemma_2b"] + \
        ["recurrentgemma_2b"]
    out = []
    for a in order:
        for s in SHAPES:
            if s == "long_500k" and a not in LONG_OK:
                continue
            if not multi_pod_only:
                out.append((a, s, False))
            if not single_pod_only:
                out.append((a, s, True))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--fix-flops", action="store_true",
                    help="recompute phase A for existing --out records")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default=None, help="directory for JSON records")
    ap.add_argument("--device", default=None,
                    help="'meta' counts only; default: also run rank 0's "
                         "step on the card")
    args = ap.parse_args(argv)

    if args.fix_flops:
        assert args.out
        fix_flops(args.out)
        return

    if args.all:
        cells = all_cells(args.single_pod_only, args.multi_pod_only)
    else:
        assert args.arch and args.shape
        if args.shape == "long_500k" and args.arch not in LONG_OK:
            raise SystemExit(f"{args.arch} is full-attention: long_500k "
                             "skipped by design")
        cells = [(args.arch, args.shape, args.multi_pod)]

    failures = []
    t_all = time.perf_counter()
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}.json"
        if args.out and args.skip_existing and \
                os.path.exists(os.path.join(args.out, tag)):
            continue
        try:
            rec = run_cell(arch, shape, multi_pod=mp, device=args.device)
        except Exception as e:
            traceback.print_exc()
            failures.append((arch, shape, mp, repr(e)))
            continue
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, tag), "w") as f:
                json.dump(rec, f, indent=1)
    if failures:
        print("FAILURES:", json.dumps(failures, indent=1))
        raise SystemExit(1)
    print(f"ALL CELLS OK ({len(cells)} cells, "
          f"{time.perf_counter() - t_all:.1f} s)")


if __name__ == "__main__":
    main()
