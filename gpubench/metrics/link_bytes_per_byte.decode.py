"""Bytes the decodes moved between host and card (the program's
FQZ5_DEVTIME counters, reset before each decode) per byte of FASTQ
decoded."""


def read(trace):
    trips = [t for t in trace.trips if not t.error]
    nbytes = sum(t.out_bytes for t in trips)
    if not nbytes:
        return None
    return sum(t.dec_link for t in trips) / nbytes
