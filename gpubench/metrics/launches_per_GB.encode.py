"""Kernel launches of the encodes (the program's kernel wrappers'
``.launches`` counters) per GB (10^9 bytes) of input FASTQ."""


def read(trace):
    nbytes = sum(t.in_bytes for t in trace.trips if not t.error)
    if not nbytes:
        return None
    return sum(t.enc_launches for t in trace.trips if not t.error) / (
        nbytes / 1e9)
