"""The comparison that decides ``correct``: the program's repartitions
held against the plain reference (``bench.reference``), with exact sums.

For one repartition the judge reads the inputs the benchmark made (the
coordinates, the weight field, the old parts) and what the program
returned, and gives up to five numbers; each has a limit of its own in
``limits/<cell>.json``.

* ``parts_mismatch``: items whose part differs from the one the
  program's own splitters and permutation give to the reference's key
  (``perm[#{splitters <= key}]``), plus splitters out of order.  Holds
  the keys, the final 1-D assignment and the relabelling.
* ``part_weight_gap``: the largest gap between a returned part weight
  and the exact sum of the weights the returned parts hold.
* ``imbalance_gap``: the returned imbalance against the exact one of
  the returned parts, relative.
* ``imbalance_excess``: the exact imbalance of the returned parts over
  that of the exact 1-D partition of the reference's keys at the exact
  targets W j / p, less 1.  Holds the splitters (the k-section search).
* ``migration_gap``: the returned TotalV, MaxV and retained weight
  against the exact ones of the reference's relabelling (greedy on the
  exact similarity of the old parts and the program's parts before its
  relabelling, guarded by the identity), the largest relative gap.
  Holds the remap's choice and the migration stage's sums.  Only with
  old parts: without them there is nothing to relabel or migrate.

Exact sums: the weights are whole numbers (2^level), so float64 holds
every partial sum of a field (W < 2^53) exactly, and the ideal parts are
found in int64.  A cell compares the numbers its limits file names.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .reference import dlb

#: the numbers compared, in the order they are printed
NUMBERS = ("parts_mismatch", "part_weight_gap", "imbalance_gap",
           "imbalance_excess", "migration_gap")


def _scalar(x) -> float:
    return float(torch.as_tensor(x).double().cpu())


class Judge:
    """Reference keys of one set of coordinates, computed once, and the
    comparison of any number of repartitions over them."""

    def __init__(self, coords: torch.Tensor, p: int, bits: int = dlb.BITS):
        self.p = p
        keys = dlb.hilbert_keys(dlb.box_grid(coords.float(), bits), bits)
        self.kf = keys.to(torch.float32)
        del keys
        self.order = torch.argsort(self.kf, stable=True)
        ks = self.kf[self.order]
        # atoms: runs of equal float keys, which no splitter can part
        start = torch.ones_like(ks, dtype=torch.bool)
        start[1:] = ks[1:] != ks[:-1]
        self.atom = torch.cumsum(start.to(torch.int64), 0) - 1
        last = torch.ones_like(start)
        last[:-1] = start[1:]
        self.atom_last = torch.nonzero(last).flatten()

    def ideal_part_weights(self, w64: torch.Tensor) -> torch.Tensor:
        """Part weights of the exact 1-D partition: an atom goes to part
        #{j in 1..p-1 : W j / p < F(atom)}, F the weight up to and with
        the atom, in int64."""
        F = torch.cumsum(w64[self.order], 0).round().to(torch.int64)
        W = int(F[-1])
        f_atom = F[self.atom_last][self.atom]
        part = torch.clamp(torch.div(f_atom * self.p - 1, max(W, 1),
                                     rounding_mode="floor"), 0, self.p - 1)
        return torch.zeros(self.p, dtype=torch.float64,
                           device=w64.device).index_add_(
                               0, part, w64[self.order])

    def judge(self, weights: torch.Tensor, old_parts: Optional[torch.Tensor],
              res) -> Dict[str, float]:
        p = self.p
        dev = self.kf.device
        w64 = weights.to(torch.float64)
        W = float(w64.sum())
        parts = torch.as_tensor(res.parts, device=dev).long()
        perm = torch.as_tensor(res.remap_perm, device=dev).long()
        spl = torch.as_tensor(res.splitters, device=dev).float()
        n = self.kf.shape[0]
        out: Dict[str, float] = {}

        is_perm = (perm.shape == (p,) and bool(
            (torch.sort(perm).values == torch.arange(p, device=dev)).all()))
        # the parts before the relabelling, from the program's splitters
        q = torch.searchsorted(spl.contiguous(), self.kf, right=True)
        if parts.shape != (n,) or not is_perm or spl.shape != (p - 1,):
            out["parts_mismatch"] = float(n)
        else:
            out["parts_mismatch"] = float(
                (parts != perm[q]).sum() + (spl[1:] < spl[:-1]).sum())

        ok_parts = parts.shape == (n,) and bool(
            ((parts >= 0) & (parts < p)).all())
        safe = parts if ok_parts else torch.clamp(parts, 0, p - 1)
        pw = torch.zeros(p, dtype=torch.float64, device=dev).index_add_(
            0, safe, w64)
        got_pw = torch.as_tensor(res.part_weights, device=dev).double()
        out["part_weight_gap"] = (float((got_pw - pw).abs().max())
                                  if got_pw.shape == (p,) and ok_parts
                                  else float("inf"))
        imb = float(pw.max() / pw.mean())
        out["imbalance_gap"] = abs(_scalar(res.imbalance) - imb) / imb
        ideal = self.ideal_part_weights(w64)
        out["imbalance_excess"] = imb / float(ideal.max() / ideal.mean()) - 1

        if old_parts is not None:
            old = old_parts.to(dev).long()
            qs = torch.clamp(q, 0, p - 1)
            S = torch.zeros(p * p, dtype=torch.float64, device=dev).index_add_(
                0, old * p + qs, w64).reshape(p, p).cpu().numpy()
            greedy = dlb.greedy_perm(S)
            ar = np.arange(p)
            ref = (greedy if dlb.retained_of(S, greedy)
                   >= dlb.retained_of(S, ar) else ar)
            new = torch.as_tensor(ref, device=dev)[qs]
            moved_w = torch.where(old != new, w64, 0.0)
            out_w = torch.zeros(p, dtype=torch.float64, device=dev
                                ).index_add_(0, old, moved_w)
            in_w = torch.zeros(p, dtype=torch.float64, device=dev
                               ).index_add_(0, new, moved_w)
            total_v = float(moved_w.sum())
            exact = (total_v, float(torch.maximum(out_w.max(), in_w.max())),
                     W - total_v)
            got = (_scalar(res.total_v), _scalar(res.max_v),
                   _scalar(res.retained))
            out["migration_gap"] = max(abs(g - e) / max(abs(e), 1.0)
                                       for g, e in zip(got, exact))
        return out

