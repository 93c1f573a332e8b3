"""Roofline rows from dry-run records (``launch/dryrun.py``).
Counterpart of ``repro/launch/roofline.py``, against the H100's own
constants.

Hardware model: a ``Hardware`` record, by default ``H100`` (NVIDIA H100
80GB HBM3 SXM at its 700 W power limit, dense rates from NVIDIA's data
sheet): 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM,
80 GB of it, and NVLink at 450 GB/s each way to the other cards of its
host.  A card set below 700 W runs slower than these.

Three terms per (arch x shape), in seconds a step:

    compute term     = FLOPs / (chips * peak)
    memory term      = the analytic floor / HBM bandwidth
    collective term  = collective bytes of a device / link bandwidth

FLOPs come from phase A (the unsharded step's ``FlopCounterMode`` count,
divided by the chips); the collective bytes are phase B's, a device's
already.  The memory term is the analytic floor: every byte a device
holds as an argument read once and every output written once.  The
unfused upper bound (phase A's bytes of every op's inputs and outputs,
divided by the chips) is reported beside it, not folded in: no fusion
factor is assumed.

MODEL_FLOPS = 6 N D (train) / 2 N D (inference) with N the active
parameters; MODEL_FLOPS / counted FLOPs shows how much of the counted
compute is "useful" (remat's recompute is not).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, NamedTuple, Optional


class Hardware(NamedTuple):
    """One device's peak rates: ``peak_flops`` (FLOP/s, bf16 dense),
    ``hbm_bw`` and ``link_bw`` (bytes/s), ``hbm_bytes``; ``name`` says
    which card and power limit they hold for."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    hbm_bytes: float


H100 = Hardware(name="NVIDIA H100 80GB HBM3, 700 W", peak_flops=989e12,
                hbm_bw=3.35e12, link_bw=450e9, hbm_bytes=80e9)


def model_flops(rec: Dict) -> float:
    """Useful FLOPs per step for the whole job."""
    n = rec["n_active_params"]
    if rec["kind"] == "train":
        tokens = rec["seq"] * rec["global_batch"]
        return 6.0 * n * tokens
    if rec["kind"] == "prefill":
        tokens = rec["seq"] * rec["global_batch"]
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * rec["global_batch"]


def analytic_memory_bytes(rec: Dict) -> float:
    """Per-device HBM traffic lower bound: every resident byte touched
    once (params+opt+cache read, grads/cache written)."""
    m = rec["memory_per_device"]
    args = m.get("argument_bytes") or 0
    outs = m.get("output_bytes") or 0
    return float(args + outs)


def roofline_row(rec: Dict, hw: Hardware = H100) -> Dict:
    chips = rec["chips"]
    flops_dev = rec.get("flops_global", 0.0) / chips
    bytes_dev_unfused = rec.get("bytes_global_unfused", 0.0) / chips
    coll = rec["collective_bytes_per_device"]["total"]

    t_compute = flops_dev / hw.peak_flops
    t_mem_raw = bytes_dev_unfused / hw.hbm_bw
    t_mem = analytic_memory_bytes(rec) / hw.hbm_bw
    t_coll = coll / hw.link_bw

    mf = model_flops(rec)
    useful_ratio = mf / max(rec.get("flops_global", 0.0), 1.0)
    terms = {"compute": t_compute, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    step_time = max(terms.values())
    mfu = (mf / chips / hw.peak_flops) / step_time if step_time > 0 else 0.0
    row = {
        "arch": rec["arch"], "shape": rec["shape"], "kind": rec["kind"],
        "chips": chips, "hardware": hw.name,
        "t_compute_s": t_compute,
        "t_memory_s": t_mem,
        "t_memory_raw_unfused_s": t_mem_raw,
        "t_collective_s": t_coll,
        "bottleneck": bottleneck,
        "model_flops": mf,
        "hlo_flops_global": rec.get("flops_global"),
        "useful_flop_ratio": useful_ratio,
        "roofline_fraction": mfu,   # MODEL_FLOPS-based MFU at roofline step
        "mem_per_dev_gb": (rec["memory_per_device"].get("argument_bytes") or 0)
        / 1e9,
        "temp_per_dev_gb": (rec["memory_per_device"].get("temp_bytes") or 0)
        / 1e9,
    }
    if rec.get("step_s"):       # a card run of rank 0's step beside it
        row["measured_step_s"] = rec["step_s"]
    return row


def load_records(dirpath: str, multi_pod: Optional[bool] = False
                 ) -> List[Dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if multi_pod is not None and r.get("multi_pod") != multi_pod:
            continue
        recs.append(r)
    return recs


def fmt_table(rows: List[Dict]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'comp(s)':>9s} {'mem(s)':>9s} "
           f"{'unfused':>9s} {'coll(s)':>9s} {'bound':>6s} {'useful':>7s} "
           f"{'RL-frac':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:22s} {r['shape']:12s} {r['t_compute_s']:9.4f} "
            f"{r['t_memory_s']:9.4f} {r['t_memory_raw_unfused_s']:9.4f} "
            f"{r['t_collective_s']:9.4f} "
            f"{r['bottleneck'][:6]:>6s} {r['useful_flop_ratio']:7.2f} "
            f"{r['roofline_fraction']:8.3f}")
    return "\n".join(lines)


def fmt_markdown(recs: List[Dict], hw: Hardware = H100) -> str:
    """One markdown row a record: parameters and moments a device (GB),
    counted FLOPs a device, collective bytes a device by kind, the
    bottleneck and the roofline fraction under ``hw``."""
    lines = ["| cell | params GB | moments GB | FLOPs a device | all-reduce B "
             "| all-gather B | reduce-scatter B | broadcast B | bound | "
             "RL-frac |", "|" + " --- |" * 10]
    for rec in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        r = roofline_row(rec, hw)
        args = rec.get("argument_bytes_by_name", {})
        c = rec["collective_bytes_per_device"]
        lines.append(
            f"| {rec['arch']} {rec['shape']} | {args.get('params', 0) / 1e9:.3f}"
            f" | {args.get('opt', 0) / 1e9:.3f} | "
            f"{rec['compiled_flops_per_device_u1']:.3e} | "
            f"{c['all-reduce']:.3e} | {c['all-gather']:.3e} | "
            f"{c['reduce-scatter']:.3e} | {c.get('broadcast', 0):.3e} | "
            f"{r['bottleneck']} | {r['roofline_fraction']:.4f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--markdown", action="store_true",
                    help="the per-device counts and roofline of each cell "
                         "as a markdown table")
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    rows = [roofline_row(r) for r in recs]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    if args.json:
        print(json.dumps(rows, indent=1))
    elif args.markdown:
        print(fmt_markdown(recs))
    else:
        print(f"# {H100.name}: {H100.peak_flops / 1e12:g} TFLOP/s bf16, "
              f"{H100.hbm_bw / 1e12:g} TB/s HBM, "
              f"{H100.link_bw / 1e9:g} GB/s NVLink each way")
        print(fmt_table(rows))


if __name__ == "__main__":
    main()
