"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 bench/control.py --workload <cell> --program-seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 2

On the card, in one process, at the cell's own size and load: for each
program seed one short run of the cell (the program timed as in
``run.py``), and for each control seed the same run with the reference
put in the program's place in bfloat16, one precision below the
configuration's float32.  Prints one JSON line a run with the numbers
compared; the largest over the program's seeds is the lower reading of
each number, the smallest over the control's the upper one.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


class ControlBalancer:
    """The reference in the program's place: ``balance`` as the
    program's ``Balancer`` is called, every float in ``dtype``, the
    previous call's splitters kept for a warm start as the spec says."""

    def __init__(self, spec, device, dtype):
        self.spec, self.dtype, self.warm = spec, dtype, None

    def balance(self, weights, *, coords, old_parts=None):
        from bench.reference import dlb
        res = dlb.balance(coords, weights, old_parts, self.spec.p,
                          k=self.spec.k, iters=self.spec.iters,
                          warm=self.warm if self.spec.warm_start else None,
                          dtype=self.dtype)
        self.warm = res.splitters
        return res


def control_factory(dtype):
    return lambda spec, device: ControlBalancer(spec, device, dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    cell = harness.find_cell(harness.load_benchmark(ROOT), args.workload,
                             ROOT)
    runs = [("program", int(s), {}) for s in args.program_seeds.split(",")
            if s]
    runs += [("control", int(s),
              {"balancer": control_factory(torch.bfloat16), "warmup": 1,
               "min_reps": harness.SAMPLES})
             for s in args.control_seeds.split(",") if s]
    for kind, seed, kw in runs:
        t0 = time.perf_counter()
        try:
            out = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                                   T_PROCESS, **kw)
            line = {"kind": kind, "seed": seed, "correct": out["correct"],
                    "attempted": out["attempted"],
                    "numbers": {k: v["value"]
                                for k, v in out["checks"].items()}}
        except Exception as e:  # a control that crashes sets no reading
            line = {"kind": kind, "seed": seed, "error": repr(e)}
        line["s"] = round(time.perf_counter() - t0, 3)
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
