"""MoE expert load balancing = the paper's 1-D partition problem, live,
on the PyTorch port.

Shows the balanced dispatch (Algorithm 1 prefix sums over expert-sorted
items) keeping drop rates low under skewed routing, vs a naive
fixed-stride dispatch, and the aux-loss imbalance metric.  Runs on the
card by default, on the CPU with ``--device cpu``.

    PYTHONPATH=src python examples/torch/moe_balance.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig
from repro_torch.models.moe import (MoE, _dispatch_indices, dispatch_quality,
                                    dispatch_spec, moe_apply)


def main(argv=None, out=print):
    """Run the example; returns its numbers (imbalance and drop rate per
    skew and capacity factor, the two aux losses)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    e, k, s = 8, 2, 512
    result = {"dispatch": []}

    out("== dispatch under skewed routing (zipf expert popularity) ==")
    for skew in [0.0, 0.5, 1.0]:
        probs = np.exp(-skew * np.arange(e))
        probs /= probs.sum()
        items = torch.as_tensor(rng.choice(e, size=s * k, p=probs)
                                .astype(np.int32), device=dev)
        # the routing decision scored with the shared core metric (the
        # paper's imbalance on the token->expert 1-D partition)
        q = dispatch_quality(items, e)
        for cf in [1.0, 1.25, 2.0]:
            cap = max(int(cf * s * k / e), 1)
            slot, keep = _dispatch_indices(items, e, cap)
            drop = 1.0 - float(keep.float().mean())
            out(f"  skew={skew:.1f} capacity_factor={cf:4.2f} "
                f"imbalance={float(q.imbalance):5.2f} "
                f"-> drop_rate={drop:6.2%}")
            result["dispatch"].append((skew, cf, float(q.imbalance), drop))

    out("\n== aux loss tracks imbalance (Switch f*P) ==")
    cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
                      n_experts=e, top_k=k, dtype="float32",
                      param_dtype="float32")
    out(f"  dispatch as a BalanceSpec: {dispatch_spec(cfg).to_dict()}")
    with torch.no_grad():
        moe = MoE(cfg, dev, torch.Generator(device=dev).manual_seed(0))
        x = torch.as_tensor(rng.standard_normal((4, s, 64))
                            .astype(np.float32), device=dev)
        _, aux = moe_apply(moe, x, cfg)
        out(f"  fresh router: aux={float(aux):.4f} (1.0 = perfectly "
            "uniform)")
        # skew the router deliberately
        moe.router[:, 0] += 3.0
        _, aux2 = moe_apply(moe, x, cfg)
    out(f"  skewed router: aux={float(aux2):.4f} (> 1: imbalance penalty "
        "the optimizer pushes back on)")
    result["aux"] = (float(aux), float(aux2))
    return result


if __name__ == "__main__":
    main()
