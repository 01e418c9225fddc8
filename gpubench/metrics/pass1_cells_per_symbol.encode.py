"""Cells of the planes pass 1 walks (records x the longest record, for
every FQZ and SEQ job), per symbol they hold (the records' summed
lengths), over the window's encodes (the program's FQZ5_DEVTIME counters
pass1_cells and pass1_symbols of each encode request): 1 for reads of
one length, the longest read over the mean for reads of varying length."""

from gbench import program_spans


def read(trace):
    w = program_spans.window(trace)
    if w is None:
        return None
    roots = w.roots("encode")
    cells = [r.counts.get("pass1_cells") for r in roots]
    symbols = sum(r.counts.get("pass1_symbols") or 0 for r in roots)
    if all(c is None for c in cells) or not symbols:
        return None
    return sum(c or 0 for c in cells) / symbols
