"""Input bytes of every candidate encoding the wave driver tried (each
rANS walk's streams, the host's rANS of small sections, LZP3, each
adaptive job, each name method), summed over the window's encodes (the
program's FQZ5_DEVTIME counter candidate_bytes of each encode request),
per byte of input FASTQ."""

from gbench import program_spans


def read(trace):
    w = program_spans.window(trace)
    nbytes = sum(t.in_bytes for t in trace.trips)
    if w is None or not nbytes:
        return None
    counts = [r.counts.get("candidate_bytes") for r in w.roots("encode")]
    if all(c is None for c in counts):
        return None
    return sum(c or 0 for c in counts) / nbytes
