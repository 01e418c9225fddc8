"""Share of the encode calls' wall during which the card was idle while
the program's host was under a prep/ span (the rANS candidates' table
prep, planes, PACK and STRIPE splits and payload assembly): the
program's FQZ5_DEVTIME spans on the profiler's clock
(gbench.program_spans), over device_idle_pct.encode's wall."""

from gbench import program_spans


def read(trace):
    return program_spans.idle_pct(trace, "encode", "prep/")
