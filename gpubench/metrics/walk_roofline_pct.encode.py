"""The encode launches' least time over their device time: the sum of
each launch's least time (gbench.roofline: symbols and compressed bytes
over the memory rate, or its integer operations over the integer rate,
whichever is longer) over the profiler's time of the program's kernels
that started inside the encode spans."""


def read(trace):
    least = sum(x["least_s"] for x in trace.launches if x["span"] == "encode")
    kernel_s = trace.kernel_us("encode") / 1e6
    if not kernel_s or not least:
        return None
    return 100.0 * least / kernel_s
