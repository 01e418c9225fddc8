"""Runs a cell's control on the card: the program with a lossy quality
path in its place (gbench/control.py), one short window a seed, checked
as a run checks its window.  Prints one JSON line a seed with the numbers
compared and the verdict, which has to be false.

    python3 gpubench/check_control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

from gbench import control, registry, window  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("check_control: no CUDA device is visible", file=sys.stderr)
        return 1
    cell = registry.Cell(registry.load_benchmark(ROOT), a.workload, ROOT)
    for seed in a.seeds:
        run = window.Run(cell, seed, a.seconds, False, time.perf_counter())
        try:
            run.setup()
            control.install(run)
            run.window()
            checks = run.check()
        finally:
            run.cleanup()
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": "qualities binned to 8 levels",
                          "correct": window.verdict(checks, run.trips),
                          "round_trips": len(run.trips),
                          "checks": checks,
                          "first_errors": run.ref_errors[:2]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
