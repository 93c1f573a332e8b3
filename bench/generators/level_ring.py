"""A ring of weight fields, one for each adaptive step that the
configuration's level table recorded (``bench/levels/<config>.json``).

An element is a point of the fine mesh that the configuration's domain
(``bench/domains/<kind>.py``) places uniformly in its volume, and its
weight is the density of the adaptive mesh's leaves there: 2^(level -
base), level the bisection depth of the leaf that holds the point and
base the step's lowest.  The table gives, within bins of equal volume
of the configuration's feature (``bench/features/<name>.py``), the
volume share of each level; an element takes the level at its own
quantile, drawn once, so that it keeps its rank from step to step.

The points and the quantiles come from the configuration's
``mesh_seed``: one mesh, as one PHG run has.  ``--seed`` draws the
order, a permutation of the elements (how the solver happens to hold
them): every seed partitions the same elements with the same weights,
in another order, from the ring's first step.  The start stays fixed
because the program's state after a lap (its warm splitters, the
labels the remap carries) depends on where the run entered the ring,
and so does its time.

Traffic keys: ``steps``, a [start, stop) slice of the table's steps
(all of them where absent), and ``fresh``: each repartition a run's
first (a new ``Balancer``, no old parts) instead of following the last.
"""
from __future__ import annotations

import json

import torch

from bench import plugins
from bench.generator import Inputs


def make_inputs(config: dict, traffic: dict, seed: int, device) -> Inputs:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config["mesh_seed"]))
    n = int(config["n"])
    domain = config["domain"]
    coords = plugins.load("domains", domain["kind"]).points(domain, n, gen,
                                                            device)
    quantile = torch.rand(n, generator=gen, device=device)
    table = json.loads(
        (plugins.BENCH.parent / config["levels"]).read_text())
    feature = plugins.load("features", table["feature"]).feature
    steps = table["steps"][slice(*traffic.get("steps", [None]))]
    order = torch.Generator(device=device)
    order.manual_seed(int(seed) % (1 << 63))
    perm = torch.randperm(n, generator=order, device=device)
    fields = []
    for step in steps:
        f = feature(coords, step["t"], table["feature_params"]).contiguous()
        edges = torch.tensor(step["edges"], dtype=f.dtype, device=device)
        b = torch.searchsorted(edges, f, right=True)
        cdf = torch.tensor(step["cdf"], dtype=torch.float32, device=device)
        level = torch.zeros(n, dtype=torch.float32, device=device)
        for k in range(cdf.shape[1] - 1):
            level += (cdf[:, k][b] < quantile).float()
        fields.append(torch.exp2(level)[perm])
        del f, b, level
    return Inputs(coords[perm], fields, 0, bool(traffic.get("fresh", False)))
