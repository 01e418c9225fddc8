"""Share of the encode calls' wall during which no kernel or copy ran on
the card (torch.profiler: the union of device intervals inside the
benchmark's encode spans)."""

from gbench import tracing


def read(trace):
    spans = trace.spans_of("encode")
    wall = sum(b - a for a, b in spans)
    if not wall:
        return None
    busy = sum(tracing.busy_in(trace.merged, a, b) for a, b in spans)
    return 100.0 * (1.0 - busy / wall)
