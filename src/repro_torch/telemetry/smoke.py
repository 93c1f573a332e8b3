"""Telemetry smoke: one command, one trace covering adapt + serve.
Counterpart of ``repro/telemetry/smoke.py``.

    PYTHONPATH=src python -m repro_torch.telemetry.smoke --out DIR
    PYTHONPATH=src python -m repro_torch.telemetry.smoke --out DIR \\
        --device cpu

Runs, on each of 4 ranks (``distributed.run_world``, gloo; all on cuda:0
by default, CPU processes with ``--device cpu``) under a tracer of its
own, a 3-step sharded adaptive session (owned vertices, ``hsfc``) and a
16-request sharded serve trace (``decode="sharded"``,
``rebalance="kv"``, the balancer's ``oneD="ksection"``).  Then writes
``DIR/trace.json`` (Chrome trace: every rank's spans and counters under
its rank as pid; load it in Perfetto) and ``DIR/counters.jsonl`` (rank
0's event log), validates both against their schemas, and asserts that
every rank's trace holds a span of every registered stage and rank 0's
a counter of each of the paper's quality metrics.  Exits non-zero on any
missing span or counter or schema violation; without a card the default
device raises, and nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, List, Tuple

# spans expected from the adaptive session + balancer and from the serve
# engine (the reference's sets)
REQUIRED_SPANS = {
    "adapt/solve", "adapt/estimate", "adapt/mark", "adapt/adapt_mesh",
    "adapt/balance", "balance",
    "serve/prefill", "serve/decode", "serve/rebalance", "serve/run_trace",
}
REQUIRED_COUNTERS = {
    "imbalance", "cut", "migration_total_v", "migration_retained",
    "comm_halo_bytes", "comm_psum_bytes", "moved_kv_bytes",
}
RANKS = 4


def _run_adaptive(comm) -> None:
    from ..core import BalanceSpec
    from ..fem import AdaptiveSession, AdaptSpec, cylinder_mesh
    spec = AdaptSpec(
        problem="helmholtz", max_steps=3, max_tets=3000,
        backend="sharded", vertex_layout="owned",
        balance=BalanceSpec(p=comm.size, method="hsfc", backend="sharded"))
    mesh = cylinder_mesh(6, 2, length=3.0, radius=0.5)
    AdaptiveSession(spec, comm=comm).run(mesh)


def _run_serve(comm) -> None:
    from ..configs import get_smoke
    from ..core import BalanceSpec
    from ..models import init_model
    from ..serve import ServeSession, ServeSpec, bursty_trace, run_trace
    cfg = get_smoke("llama3_8b").replace(n_layers=2, d_model=128, n_heads=4,
                                         n_kv_heads=2, head_dim=32, d_ff=256)
    model = init_model(cfg, seed=0, device=comm.device)
    groups = comm.size
    spec = ServeSpec(
        slots=2 * groups, groups=groups, max_seq=64, rebalance_every=4,
        prefill="full", decode="sharded", rebalance="kv",
        balance=BalanceSpec(p=groups, method="linear", oneD="ksection",
                            warm_start=True))
    session = ServeSession(model, cfg, spec, comm=comm)
    trace = bursty_trace(16, seed=0, vocab=cfg.vocab,
                         prompt_buckets=(4, 8, 16), max_new_cap=16)
    run_trace(session, trace, max_steps=200)


def rank_run(comm) -> Dict:
    """One rank's smoke: both workloads under a tracer of its own; its
    Chrome-trace document (pid = rank), its JSONL lines, the names of
    its spans and its counter totals."""
    from . import chrome_trace, jsonl_events, tracing
    with tracing() as tr:
        _run_adaptive(comm)
        _run_serve(comm)
    return {"trace": chrome_trace(tr, pid=comm.rank),
            "jsonl": jsonl_events(tr),
            "spans": sorted({ev.name for ev in tr.events}),
            "n_spans": len(tr.events),
            "totals": tr.metrics.summary()["totals"]}


def report(ranks: List[Dict], out: str) -> Tuple[bool, Dict]:
    """Write and validate ``out/trace.json`` (every rank's spans) and
    ``out/counters.jsonl`` (rank 0's) from the ranks' ``rank_run``
    results, and check the required spans (on every rank) and counters
    (rank 0's totals).  Returns (ok, summary)."""
    from . import merge_chrome_traces, validate_jsonl, write_chrome_trace
    os.makedirs(out, exist_ok=True)
    trace_path = os.path.join(out, "trace.json")
    jsonl_path = os.path.join(out, "counters.jsonl")
    # both are validated before they are written
    write_chrome_trace(merge_chrome_traces([r["trace"] for r in ranks]),
                       trace_path)
    lines = ranks[0]["jsonl"]
    validate_jsonl(lines)
    with open(jsonl_path, "w") as f:
        for line in lines:
            f.write(json.dumps(line, sort_keys=True) + "\n")
    missing_spans = {r: sorted(REQUIRED_SPANS - set(x["spans"]))
                     for r, x in enumerate(ranks)}
    missing_spans = {r: m for r, m in missing_spans.items() if m}
    totals = ranks[0]["totals"]
    missing_counters = sorted(REQUIRED_COUNTERS - set(totals))
    summary = {"trace": trace_path, "jsonl": jsonl_path,
               "spans": [r["n_spans"] for r in ranks], "totals": totals,
               "missing_spans": missing_spans,
               "missing_counters": missing_counters}
    return not missing_spans and not missing_counters, summary


def run(out: str, device=None) -> Tuple[bool, Dict]:
    """``rank_run`` on RANKS ranks (on cuda:0 by default; ``device="cpu"``:
    CPU processes), then ``report``."""
    from ..device import resolve_device
    from ..distributed import run_world
    dev = resolve_device(device)
    devices = [str(dev)] * RANKS if dev.type == "cpu" else None
    with tempfile.TemporaryDirectory() as tmp:
        results = run_world(rank_run, RANKS,
                            init_file=os.path.join(tmp, "rendezvous"),
                            devices=devices, timeout_s=300.0, join_s=1200.0)
    return report(results, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="telemetry_smoke",
                    help="output directory for trace.json/counters.jsonl")
    ap.add_argument("--device", default=None,
                    help="the ranks' device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    ok, summary = run(args.out, args.device)
    print(f"wrote {summary['trace']} ({sum(summary['spans'])} spans over "
          f"{len(summary['spans'])} ranks) and {summary['jsonl']}")
    totals = summary["totals"]
    print("counter totals (rank 0):", {k: totals[k] for k in sorted(totals)})
    if summary["missing_spans"]:
        print(f"MISSING SPANS (by rank): {summary['missing_spans']}",
              file=sys.stderr)
    if summary["missing_counters"]:
        print(f"MISSING COUNTERS: {summary['missing_counters']}",
              file=sys.stderr)
    if ok:
        print("telemetry smoke OK")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
