"""Collective accounting from a torch profiler trace.  Counterpart of
``repro/launch/hlo_analysis.py``, which reads post-SPMD HLO text; the
module keeps its name and ``collective_bytes``.

The input is a Chrome trace (``torch.profiler.profile(record_shapes=
True).export_chrome_trace``, as a path or its loaded dict).  Two kinds of
event describe a collective:

  * the c10d ops of a real process group (``c10d::allreduce_``,
    ``c10d::_allgather_base_``, ``c10d::_reduce_scatter_base_``,
    ``c10d::alltoall_base_``, ``c10d::broadcast_``) with their input
    dims.  An op that takes a tensor list records no type: the k-th such
    call of a process takes the type of its backend's k-th event of the
    same collective (``gloo:all_reduce``, ``gloo:broadcast``; nccl's
    ``record_param_comms``);
  * ``distributed.DryComm``'s spans, ``dry_comm::<kind> <type>[<dims>]``,
    which carry the result shape in their names.

Result-shape accounting, as the reference's: an all-gather counts its
gathered output, a reduce-scatter its scattered output, an all-reduce,
an all-to-all and a broadcast their buffer -- a consistent per-op proxy
for link traffic, and the accounting ``distributed.Comm.bytes_by_kind``
keeps, so the two agree.  An executed trace has no loops whose trip
count XLA hides, so ``n_while_loops`` is 0.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Union

from ..distributed.comm import COLLECTIVES

#: bytes of HLO's type names (``dry_comm`` spans)
_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
                "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8, "c64": 8, "c128": 16}
#: bytes of the profiler's type names (``Input type``; nccl's ``dtype``)
_TYPE_BYTES = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2,
               "int": 4, "long int": 8, "short int": 2, "signed char": 1,
               "unsigned char": 1, "bool": 1,
               "Float": 4, "Double": 8, "BFloat16": 2, "Half": 2, "Int": 4,
               "Long": 8, "Short": 2, "Char": 1, "Byte": 1, "Bool": 1}
#: c10d op -> (kind, the input whose dims are the counted shape, the
#: backend event that names a tensor list's type)
_C10D = {"c10d::allreduce_": ("all-reduce", 0, "all_reduce"),
         "c10d::_allgather_base_": ("all-gather", 0, "all_gather"),
         "c10d::_reduce_scatter_base_": ("reduce-scatter", 0,
                                         "reduce_scatter"),
         "c10d::alltoall_base_": ("all-to-all", 0, "all_to_all"),
         "c10d::broadcast_": ("broadcast", 0, "broadcast")}
_DRY = re.compile(r"^dry_comm::([a-z\-]+) ([a-z0-9]+)\[([\d,]*)\]$")


def _numel(dims) -> int:
    n = 1
    for d in dims:
        n *= int(d)
    return n


def _events(trace: Union[str, Dict]) -> List[Dict]:
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    return sorted((e for e in evs if e.get("ph") == "X"),
                  key=lambda e: (str(e.get("pid")), float(e.get("ts", 0))))


#: nccl's ``Collective name`` of the ops whose inputs are tensor lists
_NCCL_NAMES = {"allreduce": "all_reduce", "broadcast": "broadcast"}


def _list_types(events: List[Dict]) -> Dict:
    """Per process, the element bytes of each backend event that names a
    tensor-list collective's type (``gloo:all_reduce``, ``gloo:broadcast``,
    nccl's ``record_param_comms``), in order, by collective."""
    out: Dict = {}
    for e in events:
        args = e.get("args", {})
        if e["name"].startswith("gloo:"):
            op, typ = e["name"][5:], args.get("Input type", [None])[0]
        elif e["name"] == "record_param_comms":
            op = _NCCL_NAMES.get(args.get("Collective name"))
            typ = args.get("dtype")
        else:
            continue
        if op in ("all_reduce", "broadcast") and typ in _TYPE_BYTES:
            out.setdefault((str(e.get("pid")), op), []).append(_TYPE_BYTES[typ])
    return out


def collective_bytes(trace: Union[str, Dict]) -> Dict[str, float]:
    """Per-device collective bytes by kind (the reference's five kinds,
    ``broadcast``, ``total`` and ``n_while_loops``) of one rank's
    trace."""
    out = {k: 0.0 for k in COLLECTIVES + ("broadcast",)}
    events = _events(trace)
    # a tensor-list op's k-th call takes the k-th backend event's type
    types = _list_types(events)
    taken: Dict = {}
    for e in events:
        name = e["name"]
        m = _DRY.match(name)
        if m:
            kind, dtype, dims = m.groups()
            out[kind] += _numel(d for d in dims.split(",") if d) \
                * _DTYPE_BYTES[dtype]
            continue
        if name not in _C10D:
            continue
        kind, which, op = _C10D[name]
        args = e.get("args", {})
        dims = args["Input Dims"][which]
        typ = args["Input type"][which]
        if typ == "TensorList":
            key = (str(e.get("pid")), op)
            k = taken.get(key, 0)
            taken[key] = k + 1
            if k >= len(types.get(key, ())):
                raise ValueError(f"no backend event names the type of "
                                 f"{name} call {k}")
            out[kind] += sum(_numel(d) for d in dims) * types[key][k]
        else:
            out[kind] += _numel(dims) * _TYPE_BYTES[typ]
    out["total"] = sum(out.values())
    out["n_while_loops"] = 0
    return out
