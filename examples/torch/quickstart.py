"""Quickstart on the PyTorch port: the paper in one page.

Adaptive FEM solve of the Helmholtz problem (paper Example 3.1) on a
high-aspect-ratio cylinder, with dynamic load balancing each adaptive
step.  The whole loop is declarative: an ``AdaptSpec`` describes the
solve->estimate->mark->refine->balance pipeline (with a nested
``BalanceSpec`` for the balance stage) and ``AdaptiveSession`` runs it
on one device: the card by default (the SFC-key, k-section histogram,
prefix-scan and element-matvec kernels), or the CPU with
``--device cpu`` (their plain versions).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Set ``QUICKSTART_SMOKE=1`` for the reduced configuration (2 methods,
2 adaptive steps).
"""
import argparse
import os

import numpy as np
import torch

from repro_torch.core import Balancer, BalanceSpec
from repro_torch.fem import AdaptSpec, AdaptiveSession, cylinder_mesh


def main(argv=None, out=print):
    """Run the example; returns its numbers (per method: the last step's
    tets, err and imbalance and the repartition count; the standalone
    DLB's two imbalances)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    smoke = bool(os.environ.get("QUICKSTART_SMOKE"))
    methods = ["rtk", "hsfc"] if smoke else \
        ["rtk", "hsfc", "msfc", "hsfc_zoltan", "rcb"]
    max_steps = 2 if smoke else 5
    max_tets = 6000 if smoke else 30000
    result = {"methods": {}}
    out("== paper Example 3.1 (reduced): adaptive Helmholtz on a "
        "cylinder, p=16 simulated processes ==")
    for method in methods:
        # one declarative description of the whole adaptive loop; specs
        # serialize to plain dicts, so launchers can ship them around
        spec = AdaptSpec.for_problem(
            "helmholtz", max_steps=max_steps, max_tets=max_tets, tol=1e-6,
            balance=BalanceSpec(p=16, method=method))
        res = AdaptiveSession(spec, device=dev).run(
            cylinder_mesh(8, 2, length=4.0, radius=0.5))
        last = res.stats[-1]
        t_bal = sum(s.t_balance for s in res.stats)
        mig = sum(s.migration_totalv for s in res.stats)
        out(f"{method:12s} tets={last.n_tets:6d} err={last.err_l2:.3e} "
            f"imb={last.imbalance:.3f} repartitions={res.n_repartitions} "
            f"balance_time={t_bal:.2f}s migrated={mig:.0f}")
        result["methods"][method] = dict(
            tets=last.n_tets, err=last.err_l2, imbalance=last.imbalance,
            repartitions=res.n_repartitions, migrated=mig)

    out("\n== standalone DLB step on random points ==")
    rng = np.random.default_rng(0)
    n = 10_000 if smoke else 50_000
    coords = torch.as_tensor(
        (rng.random((n, 3)) * np.array([10.0, 1.0, 1.0])).astype(np.float32),
        device=dev)
    w = torch.as_tensor((rng.random(n) + 0.1).astype(np.float32), device=dev)

    # declare the pipeline once; the spec is a plain-dict-serializable
    # dataclass, so configs and launchers can ship it around
    spec = BalanceSpec(p=128, method="hsfc", oneD="sorted")
    out(f"spec: {spec.to_dict()}")
    bal = Balancer.from_spec(spec, device=dev)
    r, t = bal.balance_timed(w, coords=coords)
    out(f"hsfc on {n//1000}k pts -> 128 parts: "
        f"imbalance={float(r.imbalance):.4f} t={t['t_balance']*1e3:.0f}ms")

    # the same declaration with the paper's k-section histogram search
    rk = Balancer.from_spec(spec.replace(oneD="ksection"),
                            device=dev).balance(w, coords=coords)
    out(f"ksection variant: imbalance={float(rk.imbalance):.4f}")
    result["dlb"] = dict(sorted=float(r.imbalance),
                         ksection=float(rk.imbalance),
                         parts_sorted=r.parts.cpu().numpy(),
                         parts_ksection=rk.parts.cpu().numpy())
    return result


if __name__ == "__main__":
    main()
