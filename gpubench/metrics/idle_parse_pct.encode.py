"""Share of the encode calls' wall during which the card was idle while
the program's host was under a parse/ span (the FASTQ parser, the
container's header and index): the program's FQZ5_DEVTIME spans on the
profiler's clock (gbench.program_spans), over device_idle_pct.encode's
wall."""

from gbench import program_spans


def read(trace):
    return program_spans.idle_pct(trace, "encode", "parse/")
