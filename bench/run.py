"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout with a CUDA card.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and
``checks`` last: each number compared with its limit); the last lines of
standard error repeat the checks.  Without a card, without the program
beside ``bench/``, or with JAX loaded once the window has closed, it
exits with a code other than 0 and prints no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(*lines):
    for line in lines:
        print(line, file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"card: nvidia-smi failed ({e})"
    return "card: " + (out.stdout.strip().splitlines() or ["?"])[0]


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        say(f"no program at {ROOT / 'src' / 'repro_torch'}: nothing to measure")
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, args.workload, ROOT)
    if not torch.cuda.is_available():
        say("no CUDA device: the benchmark measures only on the card")
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        say(f"{args.workload} needs {cell['chips']} CUDA devices, "
            f"{torch.cuda.device_count()} found")
        return 3
    torch.set_num_threads(1)
    try:
        out = harness.run_cell(
            cell, args.seed, args.seconds, bool(args.trace), "cuda",
            T_PROCESS, metrics=harness.metrics_of(bench, args.workload,
                                                  bool(args.trace)))
    except Exception:
        say(traceback.format_exc())
        return 1
    found = harness.forbidden_modules()
    if found:
        say(f"loaded in this process: {', '.join(found)}; the benchmark "
            "runs the port alone")
        return 4
    say(card())
    say(*(f"check {k}: {v['value']!r} (limit {v['limit']!r})"
          for k, v in out["checks"].items()))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
