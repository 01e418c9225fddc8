"""The port's benchmark: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the repository's root.  Prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device, with
--trace 1 breakdown, and last the numbers compared with their limits
(also the last lines of standard error).  Exits 1 without a result when
no CUDA device is visible, when the cell asks for more devices than
there are, when the program is missing, or when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

from gbench import registry, tracing, window  # noqa: E402


def fail(msg: str) -> None:
    print(f"gpubench: {msg}", file=sys.stderr)
    sys.exit(1)


def end_to_end(run) -> dict:
    trips = run.trips
    enc_s = sum(t.enc_s for t in trips)
    dec_s = sum(t.dec_s for t in trips)
    return {
        "encode_MBps": (sum(t.in_bytes for t in trips) / window.MB / enc_s
                        if enc_s else None, "MB/s"),
        "decode_MBps": (sum(t.out_bytes for t in trips) / window.MB / dec_s
                        if dec_s else None, "MB/s"),
        "archive_pct": (100.0 * sum(len(t.archive) for t in trips)
                        / sum(t.in_bytes for t in trips), "%"),
        "setup_s": (run.setup_s, "s"),
    }


class Trace:
    """What a traced run hands each per-layer metric's reader."""

    def __init__(self, run):
        self.trips = run.trips
        self.launches = run.launches
        self.device, self.spans = tracing.reduce_profile(run.prof)
        self.merged = tracing.merge((a, b) for _, a, b in self.device)

    def spans_of(self, kind: str) -> list[tuple[float, float]]:
        return [(a, b) for name, a, b in self.spans if name == kind]

    def kernel_us(self, kind: str) -> float:
        """Device time of the program's kernels that started in a span."""
        spans = self.spans_of(kind)
        return sum(b - a for name, a, b in self.device
                   if tracing.is_port_kernel(name)
                   and any(x <= a < y for x, y in spans))


def breakdown(tr: Trace) -> dict:
    per = {}
    for name, a, b in tr.device:
        per[name] = per.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    gaps = [(kind, g / 1e6) for kind, a, b in tr.spans
            for g in tracing.gaps_in(tr.merged, a, b)]
    gaps.sort(key=lambda kv: -kv[1])
    return {"device_ops": [list(o) for o in ops],
            "idle_gaps": [list(g) for g in gaps[:10]]}


def power_limit() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    cell = registry.Cell(registry.load_benchmark(ROOT), a.workload, ROOT)
    if a.trace:
        # the program reads its link/device counters' switch at import
        os.environ["FQZ5_DEVTIME"] = "1"
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} devices, "
             f"{torch.cuda.device_count()} visible")
    try:
        import fqzcomp5_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program is missing: {e}")

    run = window.Run(cell, a.seed, a.seconds, bool(a.trace), STARTED)
    try:
        run.setup()
        run.window()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        checks = run.check()
        print(f"gpubench: window {run.window_s:.1f} s, check "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
        if a.trace:
            run.tally()
    finally:
        run.cleanup()
    found = window.forbidden_modules()
    if found:
        fail("loaded in this process: " + ", ".join(found))

    if a.trace:
        tr = Trace(run)
        metrics = {}
        for m in cell.per_layer:
            v = registry.reader(cell.metrics_dir, m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = end_to_end(run)
        metrics = {m["name"]: {"value": e2e[m["name"]][0],
                               "unit": m["unit"]}
                   for m in cell.end_to_end
                   if e2e[m["name"]][0] is not None}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": run.peak,
              "power_limit_w": power_limit()}
    if a.trace:
        device["busy_s"] = sum(b - a_ for a_, b in tr.merged) / 1e6
        device["window_s"] = run.window_s
    correct = window.verdict(checks, run.trips)
    result = {"correct": correct, "attempted": len(run.trips),
              "failed": sum(t.failed for t in run.trips),
              "metrics": metrics, "device": device}
    if a.trace:
        result["breakdown"] = breakdown(tr)
    result["checks"] = checks
    for e in [t.error for t in run.trips if t.error][:3] + run.ref_errors[:3]:
        print(f"gpubench: {e}", file=sys.stderr)
    print("gpubench: round trips (encode s, decode s): " + ", ".join(
        f"({t.enc_s:.3f}, {t.dec_s:.3f})" for t in run.trips),
        file=sys.stderr)
    for name, c in checks.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
