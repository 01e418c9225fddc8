"""The program's own spans placed on the profiler's clock, and the card's
idle time in each benchmark span put down to the span the host was in.

Under FQZ5_DEVTIME the program keeps a log of its host spans in memory
(``fqzcomp5_tpu_torch.ops.devtimer.spans()``: request, id, parent,
thread, name, t0_ns, t1_ns, counts), stamped with ``time.time_ns()``;
it opens no torch.profiler range, so the device's timeline holds only
its kernels and copies.  The profiler's times are microseconds from the
start of its trace, so the two clocks differ by one offset.

``window(trace)`` finds it: the window's benchmark spans (``trace.spans``,
in order) are matched one for one with a contiguous run of the log's
roots (``encode``, ``decode``) of the same names.  The run's offset is
the median of its offsets (benchmark span end less root end); every
root, moved by it, lies inside its benchmark span, give or take TOL_US;
and all but at most a quarter of the pairs are tight: end and start
each within TOL_US of the offset.  A loose pair is a request in which
the host stood still between the benchmark's range and the program's
root (a stall of the machine, a page fault storm in the harness's copy
of the archive): its benchmark span is longer than its root, and that
time, no span's, goes to the root's own name.  Of several such runs,
the one with the fewest loose pairs, then whose tight offsets agree
best.  Warm-up and tally roots lie outside the run.  The first span may
start up to FIRST_US before its root and still be tight: the profiler
stamps its first range's start milliseconds before the range returns
to the caller (5 ms on a CPU build of torch), and that time is no
program's.  Where no run matches (a program that keeps no spans, a log
that lost the window's first records, one that disagrees with the
profile in more than a quarter of the requests), it returns None, and
every reader returns None.

``Window.idle_us(merged, kind)``: each idle instant of a benchmark span
of that kind (the stretches between ``trace.merged``'s device
intervals, whose lengths are ``tracing.gaps_in``'s) goes to the
innermost program span open then on its root's thread; an instant
under no span below the root goes to the root's own name, the unnamed
rest.  So the shares of the layers, of ``link/`` and ``kernel/``, and
the rest add up to ``device_idle_pct`` of that kind.
"""

from __future__ import annotations

TOL_US = 2000.0    # the largest disagreement of a duration or an offset
# how much longer than its root the profile's first range may be: the
# profiler takes milliseconds to enter its first record_function
FIRST_US = 50_000.0
ROOTS = ("encode", "decode")


def program_log():
    """The program's span log, or None where it keeps none."""
    try:
        from fqzcomp5_tpu_torch.ops import devtimer
    except ImportError:
        return None
    spans = getattr(devtimer, "spans", None)
    return spans() if spans is not None else None


class Window:
    """The window's benchmark spans, each with its program root, and the
    program's records on the profiler's clock (us)."""

    def __init__(self, pairs, offset_us: float, log):
        self.pairs = pairs            # [(kind, start_us, end_us, root)]
        self.offset = offset_us
        self.records = {}             # request id -> its records
        for r in log:
            self.records.setdefault(r.request, []).append(r)

    def roots(self, kind: str) -> list:
        return [r for k, _, _, r in self.pairs if k == kind]

    def segments(self, root) -> list[tuple[float, float, str]]:
        """The root's wall as disjoint (start_us, end_us, name) pieces,
        each named by the innermost span open on the root's thread."""
        off = self.offset
        spans = [(r.t0_ns / 1e3 + off, r.t1_ns / 1e3 + off, r.name)
                 for r in self.records.get(root.id, ())
                 if r.thread == root.thread]
        return innermost(spans)

    def idle_us(self, merged, kind: str) -> tuple[float, dict]:
        """(wall us, {span name: idle us}) of the benchmark spans of this
        kind."""
        wall, idle = 0.0, {}
        for k, a, b, root in self.pairs:
            if k != kind:
                continue
            wall += b - a
            for x, y, name in label(idle_stretches(merged, a, b),
                                    self.segments(root), root.name):
                idle[name] = idle.get(name, 0.0) + (y - x)
        return wall, idle


def innermost(spans) -> list[tuple[float, float, str]]:
    """spans: (start, end, name) nested as one thread's are: the disjoint
    pieces of their union, each named by the innermost span over it."""
    out, stack, t = [], [], None

    def close():
        nonlocal t
        end, name = stack[-1][1], stack[-1][2]
        stack.pop()
        if end > t:
            out.append((t, end, name))
            t = end

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            close()
        if stack and s > t:
            out.append((t, s, stack[-1][2]))
        t = s if t is None else max(t, s)
        stack.append((s, e, name))
    while stack:
        close()
    return out


def idle_stretches(merged, a: float, b: float) -> list[tuple[float, float]]:
    """The idle stretches of [a, b] between the merged device intervals
    (tracing.gaps_in's, as intervals)."""
    out, t = [], a
    for x, y in merged:
        if y <= a or x >= b:
            continue
        if x > t:
            out.append((t, x))
        t = max(t, y)
    if b > t:
        out.append((t, b))
    return out


def label(stretches, segments, rest: str) -> list[tuple[float, float, str]]:
    """(start, end, name): the sorted disjoint stretches cut by the sorted
    disjoint named segments; what no segment covers is named rest."""
    out, i = [], 0
    for x, y in stretches:
        while i < len(segments) and segments[i][1] <= x:
            i += 1
        t, j = x, i
        while j < len(segments) and segments[j][0] < y:
            p, q, name = segments[j]
            if p > t:
                out.append((t, p, rest))
            out.append((max(p, t), min(q, y), name))
            t = min(q, y)
            j += 1
        if y > t:
            out.append((t, y, rest))
    return out


def match(bench, log):
    """The Window of bench spans [(name, start_us, end_us)] in the log, or
    None."""
    bench = sorted(bench, key=lambda s: s[1])
    roots = sorted((r for r in log if r.parent is None and r.name in ROOTS),
                   key=lambda r: r.t0_ns)
    n = len(bench)
    best = None           # (loose pairs, tight offsets' spread, k, offset)
    for k in range(len(roots) - n + 1) if n else ():
        run = roots[k:k + n]
        if any(r.name != name for (name, _, _), r in zip(bench, run)):
            continue
        ends = [b - r.t1_ns / 1e3 for (_, _, b), r in zip(bench, run)]
        off = sorted(ends)[n // 2]
        tight, inside = [], True
        for j, ((_, a, b), r) in enumerate(zip(bench, run)):
            early = r.t0_ns / 1e3 + off - a    # bench start before root's
            late = ends[j] - off               # bench end after root's
            inside &= early >= -TOL_US and late >= -TOL_US
            if abs(late) <= TOL_US and -TOL_US <= early <= (
                    FIRST_US if j == 0 else TOL_US):
                tight.append(ends[j])
        loose = n - len(tight)
        if not inside or 4 * loose > n:
            continue
        cand = (loose, max(tight) - min(tight), k, off)
        if best is None or cand[:2] < best[:2]:
            best = cand
    if best is None:
        return None
    _, _, k, off = best
    if not any(r.t1_ns < roots[k].t0_ns for r in log):
        return None               # the log no longer holds all of it
    pairs = [(name, a, b, r) for (name, a, b), r in zip(bench, roots[k:k + n])]
    return Window(pairs, off, log)


def window(trace) -> Window | None:
    """The traced run's Window (computed once a trace)."""
    if not hasattr(trace, "_program_window"):
        log = program_log()
        trace._program_window = (match(trace.spans, log)
                                 if log is not None else None)
    return trace._program_window


def idle_pct(trace, kind: str, prefix: str) -> float | None:
    """100 x the device-idle us of the kind's benchmark spans that fell
    under program spans named prefix..., over their wall."""
    w = window(trace)
    if w is None:
        return None
    wall, idle = w.idle_us(trace.merged, kind)
    if not wall:
        return None
    return 100.0 * sum(us for name, us in idle.items()
                       if name.startswith(prefix)) / wall
