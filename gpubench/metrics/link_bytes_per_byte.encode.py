"""Bytes the encodes moved between host and card (the program's
FQZ5_DEVTIME counters, devtimer.snapshot()["link_bytes"], reset before
each encode) per byte of input FASTQ."""


def read(trace):
    trips = [t for t in trace.trips if not t.error]
    nbytes = sum(t.in_bytes for t in trips)
    if not nbytes:
        return None
    return sum(t.enc_link for t in trips) / nbytes
