"""Slot-based continuous-batching serving engine with load-balanced request
groups and KV-cache migration.  Counterpart of ``repro/serve/engine.py``.

The serving analogue of the paper's adaptive loop: requests arrive and
finish continuously, so the KV load of each device group drifts like mesh
load under refinement.  Every ``rebalance_every`` steps the engine weighs
each active request by its live KV footprint (prompt + generated tokens),
partitions the requests over the groups with the 1-D partitioner
(requests linearized by arrival id), and applies the Oliker--Biswas remap
so that surviving requests keep their group; with ``rebalance='kv'`` each
moved request's KV slot then ships to its new group
(``slots.SlotMigrator``, the serving twin of the FEM element migration).

``ServeSession`` resolves a ``ServeSpec`` into the registered stages
``prefill -> insert -> generate -> rebalance``.  On one device it runs
prefill 'cheap' | 'full' | 'packed', insert 'slot', generate
'replicated', rebalance 'tags' | 'never'.  With ``decode='sharded'`` it
runs on a process group of one rank per request group (``comm=``, a
``distributed.Comm``): every rank runs the same host loop in lockstep and
holds only its group's KV slots; decode is one call per rank per step,
joined by one all_gather of the argmax tokens; ``rebalance='kv'``
migrates KV slots between the ranks.  The old single-device simulation
survives as the stage variants ``prefill='cheap'`` /
``decode='replicated'`` / ``rebalance='tags'`` and behind the deprecated
``ServeEngine`` constructor shim.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import deprecation, telemetry
from ..core import Balancer, BalanceSpec
from ..data.packing import first_fit_pack
from ..device import resolve_device
from ..models.config import ModelConfig
from .decode import (decode_step, init_decode_state, init_serve_state,
                     packed_prefill, prefill, reset_slot)
from .slots import (SlotMigrator, check_serve_world, make_paged_insert,
                    make_sharded_decode, slot_axes, slot_nbytes, write_slot)
from .spec import (ServeSpec, get_serve_stage, register_serve_stage,
                   resolve_serve_variants)

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (s,) token ids
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    group: int = 0                  # device group currently hosting the slot
    slot: Optional[int] = None      # global slot id while active
    migrations: int = 0             # inter-group KV migrations survived
    # wall-clock stamps for ``run_trace`` (TTFT / ITL percentiles)
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    t_tokens: List[float] = dataclasses.field(default_factory=list)

    def kv_weight(self) -> float:
        """Live KV footprint proxy: prompt + generated tokens."""
        return float(len(self.out) + len(self.prompt))


# ---------------------------------------------------------------------------
# Stage implementations
# ---------------------------------------------------------------------------

@register_serve_stage("prefill", "cheap")
def _prefill_cheap(session: "ServeSession", req: Request):
    """Seed only the last prompt token over an empty KV row: no prompt
    forward, so the first output token comes from the first decode step."""
    return int(req.prompt[-1]), None, None


@register_serve_stage("prefill", "full")
def _prefill_full(session: "ServeSession", req: Request):
    """Forward the prompt; emit the first output token and the batch-1
    cache the insert stage writes into the slot.  Over a group only the
    rank that holds the slot calls it."""
    tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                             device=session.device)[None]
    logits, row = session._prefill_fn(session.model, tokens)
    session._observe([req], logits, None)
    tok = int(torch.argmax(logits[0]))
    return tok, row, tok


@register_serve_stage("prefill", "packed")
def _prefill_packed(session: "ServeSession", admissions):
    """Batched admission: one forward over all admitted prompts.

    ``admissions``: the host-planned seating, ``(req, slot, group,
    offset)`` with offsets page-aligned in the ``prefill_capacity``
    buffer.  Builds the buffer (tokens, segment ids, within-segment
    positions, last-token indices), runs the segment-masked packed
    forward, scatters the K/V into the admitted slots page by page and
    seeds each slot's next decode token.  Returns the first output token
    of each admission.

    Over a group every rank forwards the same buffer and keeps the pages
    and tokens of its own slots, as the reference computes the buffer
    once and lets each group drop the pages of the others."""
    spec = session.spec
    C, ps = spec.prefill_capacity, spec.page_size
    tokens = np.zeros(C, np.int64)
    seg = np.full(C, -1, np.int32)
    pos = np.zeros(C, np.int32)
    last_idx = np.zeros(spec.max_packed_requests, np.int64)
    page_slot = np.full(spec.prefill_pages, -1, np.int32)
    page_dst = np.zeros(spec.prefill_pages, np.int32)
    written = np.zeros(spec.total_slots, bool)
    slen = np.zeros(spec.total_slots, np.int32)
    for sid, (req, slot, _, off) in enumerate(admissions):
        s = len(req.prompt)
        tokens[off:off + s] = np.asarray(req.prompt)
        seg[off:off + s] = sid
        pos[off:off + s] = np.arange(s)
        last_idx[sid] = off + s - 1
        npages = -(-s // ps)
        page_slot[off // ps:off // ps + npages] = slot
        page_dst[off // ps:off // ps + npages] = np.arange(npages)
        written[slot] = True
        slen[slot] = s
    dev = session.device
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    logits, ks, vs = session._packed_prefill_fn(
        session.model, t(tokens), t(seg), t(pos), t(last_idx))
    session._paged_insert(session.state, ks, vs, t(page_slot), t(page_dst),
                          t(written), t(slen))
    session._observe([a[0] for a in admissions], logits[:len(admissions)],
                     seg)
    first = torch.argmax(logits[:len(admissions)], dim=-1)
    held = [(i, slot - session._base) for i, (_, slot, _, _)
            in enumerate(admissions) if slot in session._rows]
    if held:
        idx, rows = zip(*held)
        session.tokens[list(rows), 0] = first[list(idx)]
    return [int(x) for x in first.tolist()]


@register_serve_stage("insert", "slot")
def _insert_slot(session: "ServeSession", req: Request, slot: int,
                 seed_tok: int, row) -> None:
    """Reset the freed slot, then merge the prefill cache (if any) and
    seed the next decode token (on the rank that holds the slot)."""
    i = slot - session._base
    reset_slot(session.state, i, session.cfg, wound_to=session._wound_to)
    if row is not None:
        write_slot(session.state, row, i, session.axes)
    session.tokens[i, 0] = seed_tok


@register_serve_stage("generate", "replicated")
def _generate_replicated(session: "ServeSession") -> torch.Tensor:
    """One decode call over every slot."""
    logits, session.state = decode_step(session.model, session.state,
                                        session.tokens, session.cfg)
    session._observe_decode(logits)
    next_tok = torch.argmax(logits[:, -1], dim=-1)
    session.tokens = next_tok[:, None]
    return next_tok


@register_serve_stage("generate", "sharded")
def _generate_sharded(session: "ServeSession") -> torch.Tensor:
    """One decode call per rank: each group advances its own slots with
    the replicated weights, and one all_gather of the argmax tokens gives
    every rank the tokens of all slots."""
    logits, next_tok = session._decode(session.model, session.state,
                                       session.tokens)
    session._observe_decode(logits)
    session.tokens = next_tok[session._base:session._base + session.spg,
                              None]
    return next_tok


@register_serve_stage("rebalance", "tags")
def _rebalance_tags(session: "ServeSession") -> Optional[Dict]:
    """Repartition and update the group labels only (no KV bytes move)."""
    live = session._live()
    if len(live) < 2:
        return None
    res = session._balance(live)
    for (_, r), g in zip(live, res.parts.tolist()):
        r.group = int(g)
    return session._log_entry(res, moved_kv_bytes=0, n_moved=0, deferred=0,
                              deferred_retries=0)


@register_serve_stage("rebalance", "kv")
def _rebalance_kv(session: "ServeSession") -> Optional[Dict]:
    """Repartition, then migrate each moved request's KV slot between
    groups with the all_to_all executor.  Movers deferred by the previous
    rebalance (destination full) are retried first this round;
    ``deferred_retries`` counts the ones that landed."""
    live = session._live()
    if len(live) < 2:
        return None
    res = session._balance(live)
    moves, deferred, retried = session._plan_moves(live, res.parts.tolist())
    stats = session._apply_moves(moves)
    return session._log_entry(
        res, moved_kv_bytes=int(stats["moved_bytes"]), n_moved=len(moves),
        deferred=len(deferred), deferred_retries=retried)


# ---------------------------------------------------------------------------
# ServeSession
# ---------------------------------------------------------------------------

class ServeSession:
    """Resolve a ``ServeSpec`` into a running slot-based engine.

    ``model``: an LM of ``cfg``'s family (``models.init_model``) on the
    session's device.  Global slot s
    belongs to group ``s // spg``; a request's ``group`` is its slot's
    group.  Admission fills the least-loaded group's lowest free slot;
    the rebalance stage re-labels the groups of the live requests
    ('tags') or migrates their KV slots ('kv').

    On one device (``device``, default CUDA; ``decode='replicated'``) the
    decode state is the family's state (``serve.decode``: a ``KVCache``,
    an ``SSMState``, a ``HybridState`` or an ``EncDecState``, whose
    family only 'cheap' prefill seats) over all ``spec.total_slots``
    slots.  ``kv_slot_bytes`` is one slot's bytes in the state as it is
    built, as the reference counts them: a conv window counts in
    ``act_dtype``, though decode turns it float32.
    With ``decode='sharded'``, ``comm`` is a ``distributed.Comm`` of
    ``spec.groups`` ranks and the session runs on ``comm.device``: rank r
    holds group r's slots ``[r*spg, (r+1)*spg)`` as its state's rows.
    Every rank builds its session from the same weights and spec, submits
    the same requests and steps in lockstep: every decision is taken from
    values that are equal on all ranks (integer KV weights, gathered
    tokens), and each rank's requests, tokens and ``migration_log`` are
    the same.  'full' prefill runs on the rank that holds the slot, and
    the first tokens of an admission wave reach the other ranks in one
    collective after it.

    ``on_logits``, if given, sees every batch of logits the session turns
    into tokens: ``on_logits(requests, logits, seg)`` with one float32
    row per request, in the order given, and ``seg`` the packed buffer's
    segment ids (numpy) for a packed admission, else None.  Over a group
    a rank sees the rows it computes: its own slots' decode and full
    prefill rows, and every packed admission.
    """

    def __init__(self, model: torch.nn.Module, cfg: ModelConfig,
                 spec: ServeSpec,
                 *, device=None, tracer=None, on_logits=None, comm=None):
        self.model, self.cfg, self.spec = model, cfg, spec
        self.on_logits = on_logits
        sharded = spec.decode == "sharded"
        if sharded or spec.rebalance == "kv":
            check_serve_world(spec.groups, comm)
        if not sharded and spec.rebalance == "kv":
            raise ValueError("rebalance='kv' moves KV slots between the "
                             "ranks that hold them: it needs "
                             "decode='sharded'")
        if comm is not None and not sharded:
            raise ValueError("comm= runs decode='sharded' (one rank per "
                             "group); decode='replicated' runs on one device")
        if comm is not None and device is not None:
            raise ValueError("pass device= or comm=, not both: a sharded "
                             "session runs on comm.device")
        self.comm = comm
        self.device = resolve_device(device if comm is None else comm.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if spec.interpret:
            raise ValueError("interpret=True names the Pallas interpreter; "
                             "the CUDA kernels have none (CPU tensors run "
                             "the plain versions)")
        params = {p.device for p in model.parameters()}
        if params != {self.device}:
            raise ValueError(f"the model's parameters are on {params}, the "
                             f"session runs on {self.device}")
        # explicit per-session tracer; None follows the active
        # telemetry.tracing() scope at call time
        self.tracer = tracer
        self._variants = resolve_serve_variants(spec)
        total = spec.total_slots
        # the global slots this session holds, as its state's rows
        self._base = comm.rank * self.spg if sharded else 0
        self._rows = range(self._base,
                           self._base + (self.spg if sharded else total))
        n_rows = len(self._rows)
        if spec.prefill in ("full", "packed"):
            self.state = init_serve_state(cfg, n_rows, spec.max_seq,
                                          device=self.device)
            self._wound_to = None
        else:
            # the reference's cheap oracle starts from the dry-run state
            # (positions pre-wound, zero K/V); freed slots return to it
            self.state = init_decode_state(cfg, n_rows, spec.max_seq,
                                           device=self.device)
            self._wound_to = spec.max_seq
        self.axes = slot_axes(cfg)
        self.kv_slot_bytes = slot_nbytes(self.state, self.axes)
        # the next decode input of this session's rows, and the last
        # tokens of every slot (a mover's pending token is read there)
        self.tokens = torch.zeros((n_rows, 1), dtype=torch.int64,
                                  device=self.device)
        self._last_tokens: List[int] = [0] * total
        self.active: List[Optional[Request]] = [None] * total
        self.queue: List[Request] = []
        self.step_count = 0
        self.migration_log: List[Dict] = []
        self.balancer = self._build_balancer(spec.balance)
        self._decode = self._migrator = None
        if sharded:
            self._decode = make_sharded_decode(cfg, comm)
            self._migrator = SlotMigrator(cfg, comm, self.axes, self.state)
        self._prefill_fn = lambda m, t: prefill(m, {"tokens": t}, cfg,
                                                max_seq=spec.max_seq)
        self._packed_prefill_fn = None
        self._paged_insert = None
        if spec.prefill == "packed":
            if cfg.family not in ("dense", "moe", "vlm"):
                raise ValueError(
                    f"prefill='packed' needs a KV-cache family (dense/moe/"
                    f"vlm), got {cfg.family!r}: recurrent state cannot be "
                    "segment-masked inside one packed forward")
            if cfg.mrope_sections is not None:
                raise ValueError(
                    "prefill='packed' does not support mrope models (the "
                    "packed buffer carries 1-D within-segment positions)")
            S = spec.max_seq if cfg.window is None \
                else min(cfg.window, spec.max_seq)
            if S != spec.max_seq:
                raise ValueError(
                    f"prefill='packed' needs cache S == max_seq, got ring "
                    f"S={S} (SWA window {cfg.window}): pages address "
                    "absolute positions")
            self._packed_prefill_fn = (
                lambda m, t, sg, ps, li: packed_prefill(
                    m, t, sg, ps, li, cfg, use_pallas=spec.use_pallas))
            self._paged_insert = make_paged_insert(
                cfg, comm, total_slots=total, page_size=spec.page_size,
                capacity=spec.prefill_capacity)
        # admission accounting: calls = prefill forwards, requests =
        # admitted, tokens = real prompt tokens, buffer_tokens = buffer
        # footprint (= tokens for per-request modes, capacity per call for
        # packed; tokens / buffer_tokens is the packed fill fraction)
        self.prefill_stats: Dict[str, int] = {
            "calls": 0, "requests": 0, "tokens": 0, "buffer_tokens": 0}
        self._deferred_moves: Dict[int, int] = {}
        self._prefill = get_serve_stage("prefill", self._variants["prefill"])
        self._insert = get_serve_stage("insert", self._variants["insert"])
        self._generate = get_serve_stage("generate",
                                         self._variants["generate"])
        self._rebalance = (
            get_serve_stage("rebalance", self._variants["rebalance"])
            if self._variants["rebalance"] is not None else None)

    # -- bookkeeping helpers -------------------------------------------------
    def _tr(self):
        return self.tracer if self.tracer is not None \
            else telemetry.get_tracer()

    @property
    def spg(self) -> int:
        return self.spec.slots_per_group

    def _observe(self, reqs, logits, seg) -> None:
        if self.on_logits is not None:
            self.on_logits(reqs, logits, seg)

    def _observe_decode(self, logits: torch.Tensor) -> None:
        """``on_logits`` for the live requests of this session's rows."""
        if self.on_logits is not None:
            live = [(i, r) for i, r in self._live() if i in self._rows]
            self.on_logits([r for _, r in live],
                           logits[[i - self._base for i, _ in live], -1],
                           None)

    def _live(self) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.active) if r is not None]

    def _group_load(self, g: int) -> float:
        return sum(r.kv_weight() for i, r in self._live() if r.group == g)

    def _free_slots(self, g: int) -> List[int]:
        return [s for s in self.spec.usable_slots(g)
                if self.active[s] is None]

    # -- admission -----------------------------------------------------------
    def _build_balancer(self, bspec: BalanceSpec) -> Balancer:
        """The rebalance stage's balancer, on the session's device."""
        return Balancer(bspec, device=self.device)

    def submit(self, req: Request) -> None:
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _admit(self) -> None:
        if self._variants["prefill"] == "packed":
            while self._admit_packed_once():
                pass
            return
        full = self._variants["prefill"] == "full"
        wave = []           # (request, first token or 0 where not held)
        while self.queue:
            # least-loaded group with a free usable slot (lowest id ties)
            cands = [(self._group_load(g), g, free[0])
                     for g in range(self.spec.groups)
                     if (free := self._free_slots(g))]
            if not cands:
                break
            _, g, slot = min(cands)
            req = self.queue.pop(0)
            if full and len(req.prompt) + req.max_new > self.spec.max_seq:
                raise ValueError(
                    f"request {req.rid}: prompt ({len(req.prompt)}) + "
                    f"max_new ({req.max_new}) exceeds max_seq "
                    f"({self.spec.max_seq})")
            first_tok = None
            with self._tr().span("serve/prefill", block=True, rid=req.rid,
                                 variant=self._variants["prefill"]) as sp:
                if slot in self._rows:
                    seed_tok, row, first_tok = self._prefill(self, req)
                    self._insert(self, req, slot, seed_tok, row)
                sp.block_on(self.tokens)
            self.prefill_stats["calls"] += 1
            self.prefill_stats["requests"] += 1
            self.prefill_stats["tokens"] += len(req.prompt)
            self.prefill_stats["buffer_tokens"] += len(req.prompt)
            req.slot, req.group = slot, g
            if full:                        # full prefill emits token 1
                now = time.perf_counter()
                wave.append((req, 0 if first_tok is None else first_tok))
                req.out.append(wave[-1][1])
                req.t_first = now
                req.t_tokens.append(now)
            if len(req.out) >= req.max_new:
                req.done, req.t_done = True, time.perf_counter()
                req.slot = None
                continue                    # slot stays free
            self.active[slot] = req
        if wave and self.comm is not None:
            # the holders' first tokens on every rank; seating above read
            # only len(out), so no decision waited for them
            got = self.comm.psum(torch.as_tensor(
                [t for _, t in wave], dtype=torch.int64, device=self.device))
            for (req, _), tok in zip(wave, got.tolist()):
                req.out[0] = tok

    def _admit_packed_once(self) -> bool:
        """Pack one buffer's worth of queued requests and admit them in one
        prefill call.  Returns True if anything was admitted (the caller
        loops while slots are free)."""
        if not self.queue:
            return False
        spec = self.spec
        cap, ps = spec.prefill_capacity, spec.page_size
        for req in self.queue:              # un-admittable = caller error
            s = len(req.prompt)
            if s + req.max_new > spec.max_seq:
                raise ValueError(
                    f"request {req.rid}: prompt ({s}) + max_new "
                    f"({req.max_new}) exceeds max_seq ({spec.max_seq})")
            if -(-s // ps) * ps > cap:
                raise ValueError(
                    f"request {req.rid}: prompt ({s}, page-aligned "
                    f"{-(-s // ps) * ps}) exceeds prefill_capacity ({cap})")
        free = {g: self._free_slots(g) for g in range(spec.groups)}
        n_free = sum(len(f) for f in free.values())
        if n_free == 0:
            return False
        chosen, offsets, _ = first_fit_pack(
            [len(r.prompt) for r in self.queue], cap, align=ps,
            max_items=min(n_free, spec.max_packed_requests))
        if not chosen:
            return False
        # seat each packed request: least-loaded group with a free slot,
        # load tracked across the round so one burst spreads out
        load = {g: self._group_load(g) for g in range(spec.groups)}
        admissions = []
        for idx, off in zip(chosen, offsets):
            req = self.queue[idx]
            _, g = min((load[g], g) for g in range(spec.groups) if free[g])
            slot = free[g].pop(0)
            load[g] += req.kv_weight()
            admissions.append((req, slot, g, off))
        with self._tr().span("serve/prefill", block=True, variant="packed",
                             n=len(admissions)) as sp:
            first = self._prefill(self, admissions)
            sp.block_on(self.tokens)
        for idx in sorted(chosen, reverse=True):
            self.queue.pop(idx)
        now = time.perf_counter()
        for (req, slot, g, _), tok in zip(admissions, first):
            req.slot, req.group = slot, g
            req.out.append(tok)
            req.t_first = now
            req.t_tokens.append(now)
            if len(req.out) >= req.max_new:
                req.done, req.t_done = True, now
                req.slot = None             # slot stays free
            else:
                self.active[slot] = req
        n_tok = sum(len(r.prompt) for r, _, _, _ in admissions)
        self.prefill_stats["calls"] += 1
        self.prefill_stats["requests"] += len(admissions)
        self.prefill_stats["tokens"] += n_tok
        self.prefill_stats["buffer_tokens"] += cap
        tr = self._tr()
        if tr.enabled:
            tr.metrics.counter(
                "prefill_tokens_packed", unit="tokens",
                help="prompt tokens admitted through the packed prefill "
                     "buffer").inc(n_tok)
            tr.metrics.gauge(
                "prefill_fill_frac",
                help="fill fraction of the last packed prefill buffer "
                     "(prompt tokens / prefill_capacity)").set(n_tok / cap)
        return True

    # -- rebalancing ---------------------------------------------------------
    def _balance(self, live):
        w = torch.as_tensor([r.kv_weight() for _, r in live],
                            dtype=torch.float32)
        coords = torch.zeros((len(live), 3), dtype=torch.float32)
        coords[:, 0] = torch.as_tensor([float(r.rid) for _, r in live])
        old = torch.as_tensor([r.group for _, r in live], dtype=torch.int64)
        return self.balancer.balance(w, coords=coords, old_parts=old)

    def _log_entry(self, res, **extra) -> Dict:
        entry = {"step": self.step_count,
                 "TotalV": float(res.total_v),
                 "imbalance": float(res.imbalance),
                 "retained": float(res.retained)}
        entry.update(extra)
        return entry

    def _plan_moves(self, live, parts
                    ) -> Tuple[List[Tuple[int, int]], Dict[int, int], int]:
        """Greedy move plan: heaviest movers first, a vacated source slot
        re-enters its group's free pool so chains resolve in one round.
        Movers whose destination group has no free slot are deferred to
        the next rebalance: they are recorded in ``_deferred_moves`` and
        get first pick of destination slots when they still need to move
        next round (never silently dropped).  Returns ``(moves, deferred,
        retried)``: the executed plan, this round's new deferral map (rid
        -> wanted group), and how many previously deferred movers landed
        this round."""
        free = {g: self._free_slots(g) for g in range(self.spec.groups)}
        movers = [(slot, r, int(g)) for (slot, r), g in zip(live, parts)
                  if int(g) != r.group]
        retry = self._deferred_moves
        movers.sort(key=lambda t: (0 if t[1].rid in retry else 1,
                                   -t[1].kv_weight(), t[1].rid))
        moves: List[Tuple[int, int]] = []
        deferred: Dict[int, int] = {}
        retried = 0
        for slot, req, g in movers:
            if free[g]:
                dst = free[g].pop(0)
                moves.append((slot, dst))
                if req.rid in retry:
                    retried += 1
                free[req.group].append(slot)
                free[req.group].sort()
            else:
                deferred[req.rid] = g
        self._deferred_moves = deferred
        return moves, deferred, retried

    def _apply_moves(self, moves: List[Tuple[int, int]]) -> Dict[str, float]:
        """Execute a move plan: ship the KV slot rows through the
        all_to_all executor, carry each mover's pending decode token (read
        from the last gathered tokens) into its destination rank's
        tokens, and rewire the host-side slot bookkeeping."""
        if not moves:
            return {"moved_bytes": 0.0, "n_moved": 0}
        self.state, stats = self._migrator(self.state, moves)
        pending = [self._last_tokens[s] for s, _ in moves]
        held = [(d - self._base, t) for (_, d), t in zip(moves, pending)
                if d in self._rows]
        if held:
            rows, toks = zip(*held)
            self.tokens[list(rows), 0] = torch.as_tensor(
                toks, dtype=torch.int64, device=self.device)
        moving = {s: self.active[s] for s, _ in moves}
        for s, _ in moves:
            self.active[s] = None
        for (s, d), t in zip(moves, pending):
            self._last_tokens[d] = t
            req = moving[s]
            self.active[d] = req
            req.slot, req.group = d, d // self.spg
            req.migrations += 1
        # host-exact byte count next to the executor's float scalars
        stats["moved_kv_bytes"] = len(moves) * self.kv_slot_bytes
        return stats

    def migrate_request(self, rid: int, dst_group: int) -> Dict[str, float]:
        """Force one request's KV slot to a free slot of ``dst_group`` (the
        rebalance stage's move machinery on a single request; every rank
        calls it alike).  Logs the move like a rebalance would."""
        if self._migrator is None:
            raise ValueError("migrate_request moves KV slots between ranks: "
                             "it needs decode='sharded'")
        live = {r.rid: (s, r) for s, r in self._live()}
        if rid not in live:
            raise ValueError(f"request {rid} is not active")
        slot, req = live[rid]
        if dst_group == req.group:
            return {"moved_bytes": 0.0, "n_moved": 0}
        free = self._free_slots(dst_group)
        if not free:
            raise ValueError(f"no free slot in group {dst_group}")
        stats = self._apply_moves([(slot, free[0])])
        self.migration_log.append(
            {"step": self.step_count, "TotalV": req.kv_weight(),
             "imbalance": float("nan"), "retained": 0.0,
             "moved_kv_bytes": int(stats["moved_kv_bytes"]),
             "n_moved": 1, "deferred": 0, "deferred_retries": 0,
             "forced": True})
        return stats

    def compile_count(self) -> int:
        """The reference counts XLA traces (its packed prefill's claim is
        O(1) compiles per spec); the port runs eagerly and compiles no
        program, so this is always 0.  ``prefill_stats`` carries the
        batching claim."""
        return 0

    # -- the engine step -----------------------------------------------------
    @torch.no_grad()
    def step(self) -> None:
        tr = self._tr()
        self._admit()
        with tr.span("serve/decode", block=True, step=self.step_count,
                     variant=self._variants["generate"]) as sp:
            next_tok = sp.block_on(self._generate(self))
        toks = next_tok.tolist()
        self._last_tokens = toks
        now = time.perf_counter()
        for i, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(toks[i]))
            if req.t_first is None:
                req.t_first = now
            req.t_tokens.append(now)
            if len(req.out) >= req.max_new:
                req.done, req.t_done = True, now
                req.slot = None
                self.active[i] = None
        self.step_count += 1
        if (self._rebalance is not None
                and self.step_count % self.spec.rebalance_every == 0):
            with tr.span("serve/rebalance", step=self.step_count,
                         variant=self._variants["rebalance"]):
                entry = self._rebalance(self)
            if entry is not None:
                self.migration_log.append(entry)
                if tr.enabled:
                    tr.metrics.counter(
                        "moved_kv_bytes", unit="bytes",
                        help="KV-cache bytes physically migrated between "
                             "groups by rebalances").inc(
                                 int(entry.get("moved_kv_bytes", 0)))
                    tr.metrics.counter(
                        "deferred_retries",
                        help="previously deferred KV migrations that "
                             "landed on a later rebalance").inc(
                                 int(entry.get("deferred_retries", 0)))
                    tr.tick(self.step_count)

    def run(self, max_steps: int = 512) -> None:
        while (any(r is not None for r in self.active) or self.queue) \
                and max_steps > 0:
            self.step()
            max_steps -= 1


# ---------------------------------------------------------------------------
# Deprecated shim: the old ServeEngine constructor
# ---------------------------------------------------------------------------

_DEPRECATION_KEY = "ServeEngine"


def _warn_deprecated_once() -> None:
    """Emit the legacy-API DeprecationWarning once per process."""
    deprecation.warn_once(
        _DEPRECATION_KEY,
        "ServeEngine(slots=..., n_groups=...) is deprecated; build a "
        "repro_torch.serve.ServeSpec and use ServeSession(model, cfg, spec) "
        "instead")


def _reset_deprecation_warning() -> None:
    """Testing hook: allow the once-per-process warning to fire again."""
    deprecation.reset(_DEPRECATION_KEY)


class ServeEngine(ServeSession):
    """DEPRECATED shim over ``ServeSession`` (old kwargs map 1:1).

    Keeps the old engine's semantics: cheap prefill, single-device
    replicated decode, and tag-only rebalancing (group labels move, KV
    stays put).  Migration guide::

        ServeEngine(model, cfg, slots=8, n_groups=4, ...)
            -> ServeSession(model, cfg,
                            ServeSpec(slots=8, groups=4, ...))

    The engine runs on ``device`` (default CUDA).  ``comm`` is the group
    of a sharded balancer (``backend='sharded'``, or a ``balance_spec``
    with that backend): ``n_groups`` ranks, each of which runs the same
    engine on ``comm.device`` and balances its shard of the requests."""

    def __init__(self, model: torch.nn.Module, cfg: ModelConfig, *,
                 slots: int = 8, max_seq: int = 256, n_groups: int = 4,
                 rebalance_every: int = 16, backend: str = "host",
                 balance_spec: Optional[BalanceSpec] = None, device=None,
                 comm=None):
        _warn_deprecated_once()
        if balance_spec is None:
            balance_spec = BalanceSpec(p=n_groups, method="linear",
                                       oneD="ksection", warm_start=True,
                                       backend=backend)
        if comm is not None and balance_spec.backend != "sharded":
            raise ValueError("comm= is the group of a sharded balancer "
                             "(backend='sharded'); the engine itself runs "
                             "on one device")
        spec = ServeSpec(slots=slots, groups=n_groups, max_seq=max_seq,
                         rebalance_every=rebalance_every, prefill="cheap",
                         decode="replicated", rebalance="tags",
                         balance=balance_spec)
        self._balance_comm = comm
        if device is None and comm is not None:
            device = comm.device
        super().__init__(model, cfg, spec, device=device)

    def _build_balancer(self, bspec: BalanceSpec) -> Balancer:
        return Balancer(bspec, device=self.device, comm=self._balance_comm)
