"""What a traced run (``--trace 1``) records, and how a device trace
becomes numbers.

``Launches`` wraps the program's kernel wrappers (roofline.WRAPPERS) for
one round trip after the window (window.Run.tally): each call goes to
the wrapper unchanged, and its work (roofline.work) is kept with the
span it ran in.  The wrappers' own ``.launches`` counters carry over to
the wrappers in place and back.

``reduce_profile`` turns torch.profiler's events into device intervals
and the benchmark's spans (``encode``, ``decode``: record_function
ranges around each call); ``merge``, ``busy_in`` and ``gaps_in`` work on
them.  Times are in microseconds on the profiler's clock.
"""

from __future__ import annotations

import importlib

from gbench import roofline

PORT_KERNEL_PREFIX = "(anonymous namespace)::"   # csrc/*.cu's kernels
SPANS = ("encode", "decode")                       # the benchmark's spans


class Launches:
    def __init__(self):
        self.span = None          # "encode" or "decode", set by round_trip
        self.seen = []            # (walk, span, symbols, bytes)
        self.saved = []

    def __enter__(self):
        for walk, (modname, attr) in roofline.WRAPPERS.items():
            mod = importlib.import_module(modname)
            fn = getattr(mod, attr)

            def shim(*a, _fn=fn, _walk=walk, **kw):
                res = _fn(*a, **kw)
                self.seen.append((_walk, self.span,
                                  *roofline.work(_walk, a, res)))
                return res
            shim.launches = fn.launches
            setattr(mod, attr, shim)
            self.saved.append((mod, attr, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            fn.launches = getattr(mod, attr).launches
            setattr(mod, attr, fn)
        self.saved = []
        return False

    def totals(self, per_symbol: dict) -> list[dict]:
        """Per launch: walk, span, symbols, bytes and least seconds; a
        decode reads per_symbol[order] compressed bytes a symbol (a decode
        of an order the dict lacks is left out)."""
        out = []
        for walk, span, syms, other in self.seen:
            syms = int(syms)
            if other is None:
                order = roofline.DECODE_ORDER[walk]
                if order not in per_symbol:
                    continue
                other = round(per_symbol[order] * syms)
            other = int(other)
            out.append({"walk": walk, "span": span, "symbols": syms,
                        "bytes": syms + other,
                        "least_s": roofline.least_seconds(
                            syms, syms + other, walk)})
        return out


def launch_count() -> int:
    """The program's kernel launches so far (its wrappers' counters)."""
    total = 0
    for modname, attr in roofline.WRAPPERS.values():
        total += getattr(importlib.import_module(modname), attr).launches
    return total


def reduce_profile(prof) -> tuple[list, list]:
    """(device events [(name, start_us, end_us)], spans [(name, start_us,
    end_us)]) of a finished torch.profiler run."""
    from torch.autograd import DeviceType

    dev, spans = [], []
    for e in prof.events():
        if e.name in SPANS:
            # the spans show on the device's timeline too: not device work
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name, e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CUDA:
            dev.append((e.name, e.time_range.start, e.time_range.end))
    return dev, spans


def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint sorted ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_in(merged, a: float, b: float) -> float:
    """Microseconds of [a, b] that the merged intervals cover."""
    return sum(max(0.0, min(y, b) - max(x, a)) for x, y in merged)


def gaps_in(merged, a: float, b: float) -> list[float]:
    """Lengths (us) of the idle stretches of [a, b] between merged
    intervals."""
    gaps, t = [], a
    for x, y in merged:
        if y <= a or x >= b:
            continue
        if x > t:
            gaps.append(x - t)
        t = max(t, y)
    if b > t:
        gaps.append(b - t)
    return gaps


def is_port_kernel(name: str) -> bool:
    return name.removeprefix("void ").startswith(PORT_KERNEL_PREFIX)
