"""Share of the encode calls' wall during which the card was idle while
the program's host was under an adaptive/ span (the SEQ and FQZ codecs'
pass 1, pass-2 grouping, the rest of pass 2's host side, the range
coder's chunks): the program's FQZ5_DEVTIME spans on the profiler's
clock (gbench.program_spans), over device_idle_pct.encode's wall."""

from gbench import program_spans


def read(trace):
    return program_spans.idle_pct(trace, "encode", "adaptive/")
