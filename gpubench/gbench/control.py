"""The control of the correctness check: a program that breaks the one
guarantee the configurations state, lossless round trips.

``BinnedPort`` is the program with a lossy quality path in front of it,
the step that would tempt a later change: it encodes the input with its
qualities binned to Illumina's eight levels.  Every number ``Run.check``
compares has to come out above its limit for it.
"""

from __future__ import annotations

import numpy as np

from gbench import traffic, window
from gbench.ref_archive import Reads

# Illumina's 8-level binning of Phred values (upper bound -> level)
BINS = ((1, 0), (9, 6), (19, 15), (24, 22), (29, 27), (34, 33), (39, 37),
        (93, 40))


def bin_quals(qual: np.ndarray) -> np.ndarray:
    """Phred+33 qualities mapped to their bins' levels (a plane of reads
    of any lengths: each read keeps its length)."""
    q = qual.astype(np.int16) - 33
    out = np.empty_like(q)
    lo = -1
    for hi, level in BINS:
        out[(q > lo) & (q <= hi)] = level
        lo = hi
    return (out + 33).astype(np.uint8)


class BinnedPort(window.Port):
    """Encodes the file at binned_path in place of the one it is given."""

    def __init__(self, preset: str, binned_path: str):
        super().__init__(preset)
        self.binned_path = binned_path

    def encode(self, path: str) -> bytes:
        return super().encode(self.binned_path)


def install(run: window.Run) -> None:
    """Put the control in the program's place for the run's window (after
    its set-up)."""
    r = run.reads
    binned = Reads(r.names, r.seq, bin_quals(r.qual), r.lens)
    path = run.path + ".binned"
    with open(path, "wb") as fp:
        fp.write(traffic.fastq(binned))
    run.extra_paths.append(path)
    run.port = BinnedPort(run.cell.config["preset"], path)
