"""Seeded bursty arrival traces + the open-loop serving run.

The DLB paper's experiments drive the partitioner with adaptation traces;
the serving engine's analogue is a request-arrival trace.  Real serving
load is bursty and heavy-tailed, which is exactly what makes periodic KV
rebalancing matter: a burst fills whichever groups have free slots, and
as long requests outlive short ones the per-group KV bytes skew.

``bursty_trace``   -- deterministic (seeded) open-loop arrival process:
  a Poisson base rate that switches into a burst rate for geometric-length
  episodes, with heavy-tailed (Lomax/Pareto-II) prompt and output lengths
  snapped to a small set of buckets (bounds prefill retraces).
``run_trace``      -- drives a ``ServeSession`` open-loop (arrivals are
  submitted at their trace step regardless of engine backlog) and reports
  throughput, p50/p99 TTFT and ITL, and the per-rebalance migration log.

Copied from ``repro/serve/trace.py``: ``bursty_trace`` draws from the same
numpy generator in the same order, so one seed gives one trace in both
packages.  ``run_trace`` keeps the reference's keys; the compile counts
are 0 (the port compiles no programs, ``ServeSession.compile_count``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .engine import Request, ServeSession


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    rid: int
    arrival: int            # engine step at which the request is submitted
    prompt: np.ndarray      # (s,) int32 token ids
    max_new: int


def _heavy_tail(rng: np.random.Generator, n: int, alpha: float,
                scale: float) -> np.ndarray:
    """Lomax (Pareto-II) samples: mostly small, occasionally huge."""
    return scale * (rng.pareto(alpha, n) + 1.0)


def _snap(x: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    """Snap each value UP to the nearest bucket (clip to the largest)."""
    b = np.asarray(sorted(buckets))
    idx = np.minimum(np.searchsorted(b, x, side="left"), len(b) - 1)
    return b[idx]


def bursty_trace(n_requests: int, *, seed: int = 0, vocab: int = 256,
                 base_rate: float = 0.5, burst_rate: float = 4.0,
                 burst_prob: float = 0.05, burst_len: float = 8.0,
                 prompt_buckets: Sequence[int] = (4, 8, 16),
                 alpha: float = 1.5, new_scale: float = 6.0,
                 max_new_cap: int = 48) -> List[TraceRequest]:
    """Seeded bursty open-loop arrival trace of ``n_requests`` requests.

    Arrivals per engine step are Poisson(base_rate); with probability
    ``burst_prob`` a step starts a burst episode whose length is
    geometric with mean ``burst_len`` and whose rate is ``burst_rate``.
    Prompt lengths are heavy-tailed snapped to ``prompt_buckets``
    (bounding distinct prefill compile shapes); output lengths are
    heavy-tailed capped at ``max_new_cap``.  Same seed -> same trace.
    """
    rng = np.random.default_rng(seed)
    reqs: List[TraceRequest] = []
    step, burst_left = 0, 0
    while len(reqs) < n_requests:
        if burst_left > 0:
            rate, burst_left = burst_rate, burst_left - 1
        else:
            rate = base_rate
            if rng.random() < burst_prob:
                burst_left = rng.geometric(1.0 / burst_len)
                rate = burst_rate
        k = rng.poisson(rate)
        for _ in range(int(k)):
            if len(reqs) >= n_requests:
                break
            s = int(_snap(_heavy_tail(rng, 1, alpha, 2.0),
                          prompt_buckets)[0])
            max_new = int(np.clip(_heavy_tail(rng, 1, alpha, new_scale)[0],
                                  1, max_new_cap))
            prompt = rng.integers(0, vocab, size=s).astype(np.int32)
            reqs.append(TraceRequest(rid=len(reqs), arrival=step,
                                     prompt=prompt, max_new=max_new))
        step += 1
    return reqs


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else float("nan")


def run_trace(session: ServeSession, trace: Sequence[TraceRequest], *,
              max_steps: Optional[int] = None) -> Dict:
    """Drive ``session`` with ``trace`` open-loop and report latency stats.

    Requests are submitted at their trace ``arrival`` step (never held
    back by backlog -- that is the queue's job), then the engine steps
    until every request finishes.  A sharded session's ranks each call it
    with the same trace and step in lockstep (the loop reads only the
    step count, the queue and the slots, equal on every rank); the
    wall-clock numbers are each rank's own, and a caller reports rank
    0's.  Returns a metrics dict:

      throughput_tok_s   generated tokens / wall seconds
      ttft_p50/p99       submit -> first output token (seconds)
      itl_p50/p99        inter-token latency within a request (seconds)
      steps, tokens      engine steps run / tokens generated
      rebalances         migration-log entries (incl. per-entry
                         ``moved_kv_bytes`` / ``deferred_retries``),
                         totals alongside
      compiles           ``session.compile_count()`` after the trace
                         (compiles_delta = new ones during it, compile_log
                         = (step, count) where it changed): always 0 here
      admission_tok_s    prompt tokens prefilled / wall seconds (the
                         admission throughput the packed buffer speeds
                         up); prefill_fill_frac is tokens over traced
                         buffer footprint (1.0 for per-request modes)
    """
    if max_steps is None:
        max_steps = 64 * len(trace) + 256
    pending = sorted(trace, key=lambda r: (r.arrival, r.rid))
    requests: List[Request] = []
    tracer = session._tr()
    if tracer.enabled:
        # register up front so the counter exists (at 0) even when no
        # rebalance fires within the trace
        tracer.metrics.counter(
            "moved_kv_bytes", unit="bytes",
            help="KV-cache bytes physically migrated between groups by "
                 "rebalances")
    compiles0 = session.compile_count()
    n_compiles = compiles0
    compile_log: List[Dict] = []
    i, t0 = 0, time.perf_counter()
    with tracer.span("serve/run_trace", requests=len(trace)) as sp:
        for _ in range(max_steps):
            while (i < len(pending)
                   and pending[i].arrival <= session.step_count):
                tr = pending[i]
                req = Request(rid=tr.rid, prompt=tr.prompt,
                              max_new=tr.max_new)
                requests.append(req)
                session.submit(req)
                i += 1
            session.step()
            c = session.compile_count()
            if c != n_compiles:
                compile_log.append({"step": session.step_count,
                                    "compiles": c})
                n_compiles = c
            if (i == len(pending) and not session.queue
                    and all(r is None for r in session.active)):
                break
        sp.set(steps=session.step_count, compiles=n_compiles)
    wall = time.perf_counter() - t0

    done = [r for r in requests if r.done]
    ttft = [r.t_first - r.t_submit for r in done if r.t_first is not None]
    itl = [dt for r in done
           for dt in np.diff(np.asarray(r.t_tokens)).tolist()]
    tokens = sum(len(r.out) for r in requests)
    moved = sum(e.get("moved_kv_bytes", 0) for e in session.migration_log)
    return {
        "requests": len(requests),
        "completed": len(done),
        "steps": session.step_count,
        "tokens": tokens,
        "wall_s": wall,
        "throughput_tok_s": tokens / wall if wall > 0 else float("nan"),
        "ttft_p50_s": _pct(ttft, 50), "ttft_p99_s": _pct(ttft, 99),
        "itl_p50_s": _pct(itl, 50), "itl_p99_s": _pct(itl, 99),
        "rebalances": len(session.migration_log),
        "moved_kv_bytes_total": int(moved),
        "deferred_retries_total": sum(
            e.get("deferred_retries", 0) for e in session.migration_log),
        "migrated_requests": sum(r.migrations for r in requests),
        "migration_log": list(session.migration_log),
        "compiles": n_compiles,
        "compiles_delta": n_compiles - compiles0,
        "compile_log": compile_log,
        "prefill_calls": session.prefill_stats["calls"],
        "admitted": session.prefill_stats["requests"],
        "admission_tok_s": (session.prefill_stats["tokens"] / wall
                            if wall > 0 else float("nan")),
        "prefill_fill_frac": (
            session.prefill_stats["tokens"]
            / max(session.prefill_stats["buffer_tokens"], 1)),
    }
