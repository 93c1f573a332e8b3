"""Record the refinement levels that the port's adaptive loop reaches on
the paper's two examples, as the tables ``bench/levels/<config>.json``.

    PYTHONPATH=src python bench/levels/record.py

Runs ``repro_torch.fem.AdaptiveSession`` on the CPU with each problem's
registered settings: Helmholtz until its 200,000-tet cap; the parabolic
problem for 100 steps of dt = 0.01 (four turns of the peak; the
registered 20 steps end while the mesh still grows).  For each step a
configuration keeps, a table gives the volume-weighted distribution of
the leaves' bisection depths within bins of equal volume of the
configuration's feature (``bench/features/<name>.py``).  The benchmark
only reads the tables; nothing it runs imports this file.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parents[1]
RECORDINGS = {
    "phg_ex31_cylinder": {
        "problem": "helmholtz", "overrides": {"max_steps": 40},
        # steps whose mesh has 100 leaves or more a process (p = 256)
        "min_tets": 25_600, "feature": "uniform", "bins": 1, "lags": [0.0]},
    "phg_ex32_cube": {
        "problem": "parabolic", "overrides": {"n_steps": 100},
        # the last turn of the peak, t = 0.76 ... 1.00, mesh settled
        "last": 25, "feature": "peak_distance", "bins": 32,
        "lags": [0.0, 0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.07, 0.08]},
}


def depths(mesh) -> np.ndarray:
    """Bisection depth of every leaf below its root."""
    f = mesh.forest
    d = np.zeros(f.n_nodes, np.int64)
    for i in range(f.n_roots, f.n_nodes):    # children follow parents
        d[i] = d[f.parent[i]] + 1
    return d[mesh.leaf_nodes]


def session_steps(problem: str, overrides: dict):
    """(t, leaf barycentres, depths, volumes) after every step."""
    from repro_torch.core.spec import BalanceSpec
    from repro_torch.fem.adapt import AdaptSpec, AdaptiveSession
    out = []

    def keep(stats, state):
        m = state.mesh
        out.append((float(state.t), m.barycenters(), depths(m),
                    m.volumes()))
    spec = AdaptSpec.for_problem(problem, balance=BalanceSpec(p=16),
                                 **overrides)
    AdaptiveSession(spec, device="cpu", on_step=keep).run()
    return out


def table(f: np.ndarray, level: np.ndarray, vol: np.ndarray,
          bins: int) -> dict:
    """Bins of equal volume over the feature, and in each the cumulative
    volume share of every level from the lowest present."""
    base, top = int(level.min()), int(level.max())
    order = np.argsort(f, kind="stable")
    cum = np.cumsum(vol[order]) / vol.sum()
    at = [min(int(np.searchsorted(cum, k / bins, side="right")), len(f) - 1)
          for k in range(1, bins)]
    interior = [float(f[order][i]) for i in at]
    b = np.searchsorted(np.asarray(interior), f, side="right")
    cdf = []
    for k in range(bins):
        v = np.bincount(level[b == k] - base, weights=vol[b == k],
                        minlength=top - base + 1)
        c = np.cumsum(v) / max(v.sum(), 1e-300)
        c[-1] = 1.0
        cdf.append([round(float(x), 6) for x in c])
    return {"base_level": base, "edges": interior, "cdf": cdf}


def explained(f, level, vol, tab) -> float:
    """Volume-weighted share of the levels' variance the bins explain."""
    b = np.searchsorted(np.asarray(tab["edges"]), f, side="right")
    mean = np.zeros(len(tab["cdf"]))
    for k in range(len(mean)):
        if (b == k).any():
            mean[k] = np.average(level[b == k], weights=vol[b == k])
    var = np.average((level - np.average(level, weights=vol)) ** 2,
                     weights=vol)
    return 1.0 - np.average((level - mean[b]) ** 2, weights=vol) / var


def record(rec: dict) -> dict:
    from bench import plugins
    steps = session_steps(rec["problem"], rec["overrides"])
    if "last" in rec:
        steps = steps[-rec["last"]:]
    else:
        steps = [s for s in steps if len(s[2]) >= rec["min_tets"]]
    # a step that left the mesh as it was calls for no repartition
    steps = [s for i, s in enumerate(steps) if i == 0
             or not np.array_equal(s[1], steps[i - 1][1])]
    feat = plugins.load("features", rec["feature"]).feature
    best = None
    for lag in rec["lags"]:
        params = {"lag": lag} if lag else {}
        tabs, r2 = [], []
        for t, x, level, vol in steps:
            f = feat(torch.from_numpy(x), t, params).double().numpy()
            tab = table(f, level, vol, rec["bins"])
            r2.append(explained(f, level, vol, tab) if rec["bins"] > 1
                      else 0.0)
            counts = np.bincount(level - tab["base_level"])
            tabs.append(dict(t=round(t, 6), n_tets=int(len(level)),
                             leaves_by_level=counts.tolist(), **tab))
        if best is None or np.mean(r2) > best[0]:
            best = (float(np.mean(r2)), params, tabs)
    return {
        "recorded_with": (
            f"repro_torch.fem.AdaptiveSession(AdaptSpec.for_problem("
            f"{rec['problem']!r}, **{rec['overrides']!r}), device='cpu'), "
            "bench/levels/record.py"),
        "feature": rec["feature"], "feature_params": best[1],
        "explained": round(best[0], 4), "steps": best[2]}


def main() -> None:
    sys.path[:0] = [str(BENCH.parent / "src"), str(BENCH.parent)]
    torch.set_num_threads(4)
    for name, rec in RECORDINGS.items():
        out = record(rec)
        path = BENCH / "levels" / f"{name}.json"
        path.write_text(json.dumps(out, separators=(",", ":")) + "\n")
        print(name, len(out["steps"]), "steps, explained",
              out["explained"], out["feature_params"], path.stat().st_size)


if __name__ == "__main__":
    main()
