"""End-to-end serving driver on the PyTorch port: sharded slots, KV
migration, bursty trace.

Decodes real tokens from a (small, randomly initialized) llama-family
model under a seeded bursty arrival trace.  The engine is declared as a
``ServeSpec``: KV slots sharded over 4 request groups (one rank each of
a ``torch.distributed`` group), real prefill, and every N steps a
repartition of live requests using the paper's machinery (requests
linearized by arrival id -> weighted 1-D k-section -> Oliker--Biswas
remap) followed by PHYSICAL KV-slot migration between the ranks through
the all_to_all executor -- per-rebalance moved bytes are reported next
to TotalV / imbalance.

    PYTHONPATH=src python examples/torch/serve_continuous.py [--device cpu]

The ranks go on the card by default (4 ranks on cuda:0 over gloo), on
4 CPU processes with ``--device cpu``.  ``serve_rank(comm, device)`` is
one rank's body; the groups are ``min(4, comm.size)``, so a world of
one rank runs the k-section with p = 1, which fails at the first
warm-started rebalance in this port as in the JAX package.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_smoke
from repro_torch.core import BalanceSpec
from repro_torch.distributed import run_world
from repro_torch.models import init_model
from repro_torch.serve import ServeSession, ServeSpec, bursty_trace, run_trace

RANKS = 4


def serve_rank(comm, device, echo=True):
    """One rank of the sharded session over the trace.  Rank 0 prints
    (with ``echo``); every rank returns its lines, the trace's metrics
    and the tokens of each request."""
    lines = []

    def say(msg):
        lines.append(msg)
        if echo and comm.rank == 0:
            print(msg, flush=True)

    cfg = get_smoke("llama3_8b").replace(n_layers=4, d_model=256, n_heads=8,
                                         n_kv_heads=4, head_dim=32, d_ff=512)
    model = init_model(cfg, seed=0, device=device)
    groups = min(4, comm.size)
    spec = ServeSpec(
        slots=8, groups=groups, max_seq=128, rebalance_every=8,
        prefill="full", decode="sharded", rebalance="kv",
        balance=BalanceSpec(p=groups, method="linear", oneD="ksection",
                            warm_start=True))
    sess = ServeSession(model, cfg, spec, comm=comm)
    reqs, submit = [], sess.submit
    sess.submit = lambda r: (reqs.append(r), submit(r))[1]

    trace = bursty_trace(24, seed=0, vocab=cfg.vocab,
                         prompt_buckets=(4, 8, 16, 24), max_new_cap=48)
    m = run_trace(sess, trace, max_steps=600)

    say(f"completed {m['completed']}/{m['requests']} requests, "
        f"{m['tokens']} tokens in {m['steps']} engine steps "
        f"({m['throughput_tok_s']:.1f} tok/s)")
    say(f"TTFT p50/p99: {m['ttft_p50_s'] * 1e3:.1f}/"
        f"{m['ttft_p99_s'] * 1e3:.1f} ms   "
        f"ITL p50/p99: {m['itl_p50_s'] * 1e3:.1f}/"
        f"{m['itl_p99_s'] * 1e3:.1f} ms")
    say(f"KV migrated: {m['moved_kv_bytes_total']} bytes across "
        f"{m['migrated_requests']} request moves")
    say("rebalance log (paper technique live):")
    for e in m["migration_log"]:
        say(f"  step {e['step']:4d}: imbalance={e['imbalance']:.3f} "
            f"TotalV={e['TotalV']:.0f} retained={e['retained']:.0f} "
            f"moved_kv_bytes={e['moved_kv_bytes']}")
    return {"lines": lines, "completed": m["completed"],
            "requests": m["requests"], "tokens": m["tokens"],
            "steps": m["steps"], "migration_log": m["migration_log"],
            "outputs": {r.rid: list(r.out) for r in reqs}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    on_cpu = torch.device(args.device).type == "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        return run_world(serve_rank, RANKS, args.device,
                         init_file=os.path.join(tmp, "rendezvous"),
                         devices=[args.device] * RANKS if on_cpu else None,
                         join_s=600.0)


if __name__ == "__main__":
    main()
