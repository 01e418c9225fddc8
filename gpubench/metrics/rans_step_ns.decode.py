"""Nanoseconds of rANS walking per serial chain step of the decodes: the
union of the device intervals of the rANS decode walks' kernels
(decode_o0_kernel, decode_o1_kernel, decode_bnd_o0_kernel,
decode_dense_o1_kernel) that started inside the benchmark's decode
spans, over the summed walk_steps/ counters of those walks in the
window's decode requests (the program's FQZ5_DEVTIME counters: each walk
launch's steps a lane, its T, counted on the host).

A lane's steps are a chain that no amount of width shortens, so this is
the time a step of the chain costs the card, launch overhead included.
It reads lower for a faster step, for a shorter chain in the same time
(fewer launches' overhead a step), and for walks that overlap (an
order-0 and an order-1 walk on two streams), since the union counts time
they share once.  None where the program counts no steps (a program
without the counters) or the trace holds no walk."""

from gbench import program_spans, tracing

KIND = "decode"
KERNELS = ("decode_o0_kernel", "decode_o1_kernel", "decode_bnd_o0_kernel",
           "decode_dense_o1_kernel")
WALKS = ("decode_o0", "decode_o1", "decode_bnd_o0", "decode_dense_o1")


def kernel(name: str) -> str:
    """A profiler kernel name without its namespace, template and
    parameters."""
    name = name.removeprefix("void ").removeprefix(tracing.PORT_KERNEL_PREFIX)
    return name.split("(")[0].split("<")[0]


def read(trace):
    w = program_spans.window(trace)
    if w is None:
        return None
    steps = sum(r.counts.get("walk_steps/" + walk) or 0
                for r in w.roots(KIND) for walk in WALKS)
    spans = trace.spans_of(KIND)
    walking = tracing.merge(
        (a, b) for name, a, b in trace.device
        if kernel(name) in KERNELS and any(x <= a < y for x, y in spans))
    if not steps or not walking:
        return None
    return 1e3 * sum(b - a for a, b in walking) / steps
