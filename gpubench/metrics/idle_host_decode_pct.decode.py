"""Share of the decode calls' wall during which the card was idle while
the program's host was under a decode/ span (section parsing, unpacking
and unstriping the device's output, the host's block decode and the
writes): the program's FQZ5_DEVTIME spans on the profiler's clock
(gbench.program_spans), over device_idle_pct.decode's wall."""

from gbench import program_spans


def read(trace):
    return program_spans.idle_pct(trace, "decode", "decode/")
