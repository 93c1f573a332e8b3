"""Serving: prefill / decode, state slots, continuous batching with
load-balanced request groups (every family: dense, MoE, VLM, SSM,
hybrid and the encoder-decoder),
on one device or over a process group of one rank per group with
slot migration.

Build a ``ServeSpec`` and hand it with a model to ``ServeSession``
(``ServeEngine`` is the deprecated old constructor);
``repro_torch.serve.trace`` gives seeded bursty arrival traces and the
open-loop latency run (``run_trace``).
"""
from .decode import (EncDecState, HybridState, KVCache, SSMState,
                     decode_step, init_decode_state, init_kv_cache,
                     init_serve_state, packed_prefill, prefill, reset_slot)
from .engine import Request, ServeEngine, ServeSession
from .slots import (SlotMigrator, check_serve_world, make_paged_insert,
                    make_sharded_decode, n_slots_of, slot_axes, slot_nbytes,
                    write_slot)
from .spec import (ServeSpec, get_serve_stage, register_serve_stage,
                   resolve_serve_variants, serve_stage_variants)
from .trace import TraceRequest, bursty_trace, run_trace

__all__ = [
    "EncDecState", "HybridState", "KVCache", "Request", "SSMState",
    "ServeEngine", "ServeSession", "ServeSpec", "SlotMigrator",
    "TraceRequest", "bursty_trace", "check_serve_world", "decode_step",
    "get_serve_stage", "init_decode_state", "init_kv_cache",
    "init_serve_state", "make_paged_insert", "make_sharded_decode",
    "n_slots_of", "packed_prefill", "prefill", "register_serve_stage",
    "reset_slot", "resolve_serve_variants", "run_trace",
    "serve_stage_variants", "slot_axes", "slot_nbytes", "write_slot",
]
