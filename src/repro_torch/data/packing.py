"""Load-balanced sequence packing -- the paper's technique in the data
path.  Counterpart of ``repro/data/packing.py``.

Documents of varying length are packed into (batch) rows of fixed
seq_len.  The load of a row is its token count (or a quadratic
attention-cost model); imbalanced rows waste accelerator time exactly as
imbalanced sub-meshes do.  ``balanced_pack`` linearizes the documents
by arrival order ('linear' keys), splits them into per-row intervals of
near-equal cost with the weighted 1-D partitioner, and keeps documents
on the row that already holds them with the Oliker--Biswas remap when
the pool changes.  Its ``Balancer`` runs on the caller's device (CUDA
unless the CPU is asked for), so on the card every packed batch launches
the ``prefix_scan`` kernel ('sorted') or the ``ksection_hist`` kernel
('ksection').  ``greedy_pack`` is the first-fit-decreasing baseline;
``first_fit_pack`` fills the serving engine's packed prefill buffer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import Balancer, BalanceSpec
from ..device import resolve_device


def attention_cost(lengths: np.ndarray, window: Optional[int] = None
                   ) -> np.ndarray:
    """Per-document cost model: linear + attention term."""
    L = lengths.astype(np.float64)
    if window is None:
        return L + L * L / 4096.0
    return L + L * np.minimum(L, window) / 4096.0


# one pipeline per (n_rows, oneD, device): documents linearized by arrival
# order ('linear' keys), weighted 1-D partition, Oliker--Biswas remap
_BALANCERS: Dict[Tuple[int, str, torch.device], Balancer] = {}


def _packer(n_rows: int, oneD: str, device: torch.device) -> Balancer:
    key = (n_rows, oneD, device)
    if key not in _BALANCERS:
        _BALANCERS[key] = Balancer(BalanceSpec(
            p=n_rows, method="linear", oneD=oneD, backend="host"),
            device=device)
    return _BALANCERS[key]


def balanced_pack(lengths: np.ndarray, n_rows: int, *,
                  cost: Optional[np.ndarray] = None,
                  old_rows: Optional[np.ndarray] = None,
                  method: str = "sorted", device=None
                  ) -> Tuple[np.ndarray, Dict]:
    """Assign each document to a row: (row ids, info), info holding the
    rows' ``imbalance`` and, with ``old_rows``, the remap's ``TotalV``,
    ``MaxV`` and ``retained``.  The balancer runs on ``device`` (default
    CUDA)."""
    dev = resolve_device(device)
    w = np.asarray(cost if cost is not None else lengths, np.float32)
    oneD = "sorted" if method == "sorted" else "ksection"
    old = None if old_rows is None else np.asarray(old_rows, np.int32)
    res = _packer(n_rows, oneD, dev).balance(w, old_parts=old)
    info: Dict = {}
    if old_rows is not None:
        info.update(TotalV=float(res.total_v), MaxV=float(res.max_v),
                    retained=float(res.retained))
    info["imbalance"] = float(res.imbalance)
    return res.parts.cpu().numpy(), info


def greedy_pack(lengths: np.ndarray, n_rows: int,
                cost: Optional[np.ndarray] = None) -> Tuple[np.ndarray, Dict]:
    """First-fit-decreasing baseline."""
    w = np.asarray(cost if cost is not None else lengths, np.float64)
    order = np.argsort(-w)
    rows = np.zeros(len(w), np.int64)
    loads = np.zeros(n_rows)
    for i in order:
        j = int(np.argmin(loads))
        rows[i] = j
        loads[j] += w[i]
    return rows, {"imbalance": float(loads.max() / max(loads.mean(), 1e-9))}


def first_fit_pack(lengths: np.ndarray, capacity: int, *, align: int = 1,
                   max_items: Optional[int] = None
                   ) -> Tuple[List[int], List[int], int]:
    """First-fit one fixed-capacity buffer; never splits an item.

    Scan ``lengths`` in order and admit every item whose ``align``-rounded
    length still fits in the remaining capacity (skipped items do NOT
    block later smaller ones -- first-fit, not first-blocked).  Items
    start at ``align`` boundaries; the serving engine uses KV-page
    alignment so every packed request's pages map to exactly one slot.

    Returns ``(chosen, offsets, used)``: indices into ``lengths`` of the
    admitted items, their start offsets in the buffer, and total tokens
    consumed (<= capacity, an ``align`` multiple when all offsets are).
    """
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    chosen: List[int] = []
    offsets: List[int] = []
    used = 0
    for i, ln in enumerate(np.asarray(lengths, np.int64)):
        ln = int(ln)
        if ln < 1:
            raise ValueError(f"item {i} has non-positive length {ln}")
        padded = -(-ln // align) * align
        if used + padded > capacity:
            continue
        if max_items is not None and len(chosen) >= max_items:
            break
        chosen.append(i)
        offsets.append(used)
        used += padded
    return chosen, offsets, used


@dataclass
class SyntheticCorpus:
    """Deterministic synthetic token stream with lognormal doc lengths."""
    vocab: int
    seed: int = 0
    mean_len: float = 350.0
    sigma: float = 0.8

    def documents(self, n: int) -> List[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        lens = np.maximum(
            8, rng.lognormal(np.log(self.mean_len), self.sigma, n)
        ).astype(np.int64)
        return [rng.integers(1, self.vocab, size=l).astype(np.int32)
                for l in lens]


def random_batch(cfg, b: int = 2, s: int = 64, *, seed: int = 0,
                 ignore: float = 0.2) -> Dict[str, np.ndarray]:
    """A numpy-seeded batch of ``s`` positions a row for ``cfg``'s family
    (random weights' counterpart for data): uniform tokens and labels, a
    share ``ignore`` of the labels -1; the VLM's ``vision_patches`` patch
    embeddings take that many of the ``s`` positions; whisper's frames
    are ``enc_seq`` standard-normal stub embeddings."""
    rng = np.random.default_rng(seed)
    s_text = s - cfg.vision_patches if cfg.family == "vlm" else s
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s_text)).astype(np.int32)}
    labels = rng.integers(0, cfg.vocab, (b, s_text)).astype(np.int32)
    labels[rng.random((b, s_text)) < ignore] = -1
    out["labels"] = labels
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def pack_batches(docs: List[np.ndarray], batch: int, seq_len: int, *,
                 vocab: int, balanced: bool = True, device=None
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Pack documents into (batch, seq_len) int32 token / label arrays.

    Rows are filled from the balanced row assignment (its balancer on
    ``device``, default CUDA); overflow is cut.  Labels are next-token
    with -1 at padding and document boundaries."""
    i = 0
    while i < len(docs):
        chunk: List[np.ndarray] = []
        total = 0
        while i < len(docs) and total < batch * seq_len:
            chunk.append(docs[i])
            total += len(docs[i])
            i += 1
        lengths = np.asarray([len(d) for d in chunk])
        if balanced:
            rows, _ = balanced_pack(lengths, batch, old_rows=None,
                                    device=device)
        else:
            rows, _ = greedy_pack(lengths, batch)
        tokens = np.zeros((batch, seq_len), np.int32)
        labels = np.full((batch, seq_len), -1, np.int32)
        fill = np.zeros(batch, np.int64)
        for d, r in zip(chunk, rows):
            r = int(r)
            take = min(len(d), seq_len - fill[r])
            if take <= 1:
                continue
            tokens[r, fill[r]:fill[r] + take] = d[:take]
            labels[r, fill[r]:fill[r] + take - 1] = d[1:take]
            fill[r] += take
        yield {"tokens": tokens, "labels": labels}
