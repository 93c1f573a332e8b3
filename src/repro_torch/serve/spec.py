"""Declarative serving API: ``ServeSpec`` + serve-stage registry.

Counterpart of ``repro/serve/spec.py``: the same fields, defaults,
validation and ``to_dict`` / ``from_dict`` round trip (the nested
``BalanceSpec`` included), so ``ServeSpec.from_dict(repro_spec.to_dict())``
carries a spec across.  The engine's step is the fixed pipeline
``prefill -> insert -> generate -> rebalance``; each stage is a
registered ``(stage, variant)`` function:

    prefill   'full' (per-request prompt forward seeding the KV slot) |
              'cheap' (seed only the last prompt token, the fast oracle) |
              'packed' (all requests admitted in a step concatenated into
              one fixed-capacity buffer, one segment-masked prefill call,
              KV scattered into slot pages)
    insert    'slot' (reset the freed slot, write the prefill cache)
    generate  'replicated' (one decode call over every slot) | 'sharded'
    rebalance 'tags' (repartition updates group labels only) | 'kv' |
              'never'

``ServeSession`` (``repro_torch.serve.engine``) registers the variants;
'sharded' decode and 'kv' rebalance run on a process group of one rank
per group (``comm=``) and refuse to run without one.

Stage signatures:

    prefill(session, req)                 -> (seed_token, row_state,
                                              first_token_or_None)
    prefill 'packed'(session, admissions) -> [first_token, ...] with
                                             admissions a list of
                                             (req, slot, group, offset)
    insert(session, req, slot, seed, row) -> None   (mutates session)
    generate(session)                     -> next tokens (total_slots,)
    rebalance(session)                    -> log-entry dict or None
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, Mapping, Optional, Tuple

from ..core.spec import BalanceSpec, Spec

SERVE_STAGES = ("prefill", "insert", "generate", "rebalance")
PREFILL_MODES = ("full", "cheap", "packed")
DECODE_BACKENDS = ("sharded", "replicated")
REBALANCE_MODES = ("kv", "tags", "never")


# ---------------------------------------------------------------------------
# ServeSpec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeSpec(Spec):
    """Declarative description of one slot-based serving engine.

    slots              logical decode slots (concurrent requests), spread
                       over the groups as evenly as possible: group g
                       gets ``slots // groups`` (+1 for the first
                       ``slots % groups`` groups); the physical slot axis
                       is padded to ``groups * slots_per_group``
    groups             device groups (balancer parts) the slots belong to
    max_seq            per-slot KV context budget (prompt + generated)
    rebalance_every    run the rebalance stage every N engine steps
    prefill            'full' | 'cheap' | 'packed' (module docstring)
    prefill_capacity   'packed' only: token capacity of the packed buffer,
                       0 = auto (max_seq); a page_size multiple
    page_size          'packed' only: KV pages are addressed (slot, page)
                       in page_size-token units; each packed request
                       starts on a page boundary.  Divides max_seq and
                       prefill_capacity
    use_pallas         'packed' only: the hand-written packed-attention
                       kernel.  None = on CUDA tensors (the plain version
                       on CPU ones), True = the kernel, False = the plain
                       version
    interpret          the reference's Pallas-interpreter switch; kept for
                       the dict round trip.  The CUDA kernels have no
                       interpreter, so a session refuses True
    decode             'sharded' | 'replicated' generate-stage variant
    rebalance          'kv' | 'tags' | 'never' rebalance-stage variant
    balance            nested ``BalanceSpec`` driving the repartition;
                       None = requests linearized by arrival id,
                       warm-started k-section over ``groups`` parts.  Its
                       ``p`` must equal ``groups``
    """
    slots: int = 8
    groups: int = 4
    max_seq: int = 256
    rebalance_every: int = 16
    prefill: str = "full"
    prefill_capacity: int = 0
    page_size: int = 8
    use_pallas: Optional[bool] = None
    interpret: bool = False
    decode: str = "sharded"
    rebalance: str = "kv"
    balance: Optional[BalanceSpec] = None

    _NESTED_SPECS: ClassVar[Mapping[str, type]] = {"balance": BalanceSpec}

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.groups < 1:
            raise ValueError(f"groups must be >= 1, got {self.groups}")
        if self.max_seq < 2:
            raise ValueError(f"max_seq must be >= 2, got {self.max_seq}")
        if self.rebalance_every < 1:
            raise ValueError("rebalance_every must be >= 1 (use "
                             "rebalance='never' to disable rebalancing)")
        if self.prefill not in PREFILL_MODES:
            raise ValueError(f"unknown prefill mode {self.prefill!r}; "
                             f"choose from {PREFILL_MODES}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.prefill_capacity < 0:
            raise ValueError("prefill_capacity must be >= 0 (0 = auto), "
                             f"got {self.prefill_capacity}")
        if self.use_pallas not in (None, True, False):
            raise ValueError("use_pallas must be None (auto), True or "
                             f"False, got {self.use_pallas!r}")
        if self.prefill == "packed":
            if self.prefill_capacity == 0:
                object.__setattr__(self, "prefill_capacity", self.max_seq)
            if self.max_seq % self.page_size:
                raise ValueError(
                    f"max_seq ({self.max_seq}) must be a multiple of "
                    f"page_size ({self.page_size}): KV pages address "
                    "(group, slot, page)")
            if (self.prefill_capacity < self.page_size
                    or self.prefill_capacity % self.page_size):
                raise ValueError(
                    f"prefill_capacity ({self.prefill_capacity}) must be a "
                    f"positive multiple of page_size ({self.page_size})")
        if self.decode not in DECODE_BACKENDS:
            raise ValueError(f"unknown decode backend {self.decode!r}; "
                             f"choose from {DECODE_BACKENDS}")
        if self.rebalance not in REBALANCE_MODES:
            raise ValueError(f"unknown rebalance mode {self.rebalance!r}; "
                             f"choose from {REBALANCE_MODES}")
        if self.balance is None:
            object.__setattr__(
                self, "balance",
                BalanceSpec(p=self.groups, method="linear", oneD="ksection",
                            warm_start=True))
        if not isinstance(self.balance, BalanceSpec):
            raise ValueError("balance must be a BalanceSpec (got "
                             f"{type(self.balance).__name__})")
        if self.balance.p != self.groups:
            raise ValueError(
                f"balance.p ({self.balance.p}) must equal groups "
                f"({self.groups}): the repartition assigns one part per "
                "device group")

    # -- physical slot topology --------------------------------------------
    @property
    def slots_per_group(self) -> int:
        """Physical slots per group (slot axis padded to a multiple)."""
        return -(-self.slots // self.groups)

    @property
    def total_slots(self) -> int:
        """Physical slot-axis length: ``groups * slots_per_group``."""
        return self.groups * self.slots_per_group

    def group_quota(self, g: int) -> int:
        """Usable (logical) slots in group ``g`` -- the first ``quota``
        local slots; the remainder up to ``slots_per_group`` is padding
        that the admission policy never fills."""
        return self.slots // self.groups + (1 if g < self.slots % self.groups
                                            else 0)

    def usable_slots(self, g: int):
        """Global ids of the usable slots of group ``g``."""
        base = g * self.slots_per_group
        return range(base, base + self.group_quota(g))

    # -- packed-prefill page topology ---------------------------------------
    @property
    def prefill_pages(self) -> int:
        """Pages in the packed prefill buffer (capacity / page_size)."""
        return self.prefill_capacity // self.page_size

    @property
    def max_packed_requests(self) -> int:
        """Most requests one pack can hold (each occupies >= 1 page)."""
        return self.prefill_pages


# ---------------------------------------------------------------------------
# Stage registry (mirrors core.spec's and fem.adapt's)
# ---------------------------------------------------------------------------

_SERVE_REGISTRY: Dict[Tuple[str, str], Callable] = {}


def register_serve_stage(stage: str, variant: str) -> Callable:
    """Decorator: register an engine-stage function under
    ``(stage, variant)`` (signatures in the module docstring)."""
    if stage not in SERVE_STAGES:
        raise ValueError(f"unknown serve stage {stage!r}; "
                         f"choose from {SERVE_STAGES}")

    def deco(fn):
        _SERVE_REGISTRY[(stage, variant)] = fn
        return fn
    return deco


def get_serve_stage(stage: str, variant: str) -> Callable:
    try:
        return _SERVE_REGISTRY[(stage, variant)]
    except KeyError:
        avail = serve_stage_variants(stage)
        raise ValueError(
            f"no {stage!r} stage variant {variant!r} registered; "
            f"available: {avail}") from None


def serve_stage_variants(stage: str):
    """Registered variant names for an engine stage."""
    return sorted(v for (s, v) in _SERVE_REGISTRY if s == stage)


def resolve_serve_variants(spec: ServeSpec) -> Dict[str, Optional[str]]:
    """Map a spec to the stage variants its engine uses.

    ``rebalance`` is ``None`` when the spec disables it entirely."""
    return {
        "prefill": spec.prefill,
        "insert": "slot",
        "generate": spec.decode,
        "rebalance": None if spec.rebalance == "never" else spec.rebalance,
    }
