"""The numpy path of pass 2 that the port's device-resident pass 2
(``adaptive_batch._evolve_families``) is held against.

The JAX package's host bucketing (``fqz_model_jax.evolve_grouped``):
each family grouped by ``group_stream`` on the host, each power-of-4
count bucket's uint8 plane built in numpy and uploaded, walked by the
port's wrappers on `device`, and each event's triple put in event order
on the host through its plane cell.  Imports no JAX, so the card's tests
use it too.
"""

import numpy as np
import torch

from fqzcomp5_tpu_torch.ops import model_cuda
from fqzcomp5_tpu_torch.ops.adaptive_batch import (F_N128, F_T2, F_T4,
                                                   F_W256, JOB_OFF,
                                                   _row_alphabets)
from fqzcomp5_tpu_torch.ops.fqz_model_torch import group_stream


def concat_arange(seg: np.ndarray) -> np.ndarray:
    """[0..seg[0]), [0..seg[1]), ... concatenated."""
    total = int(seg.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    return (np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(seg) - seg, seg))


def evolve_grouped_np(g, run, device, rows, posmap, out):
    """Bucket g's `rows` by count, build each plane in numpy, walk it on
    `device` with run(plane, counts, rows), and write the triples to
    out = (cf, tot) at posmap[stream position]."""
    uniq, counts, starts, order, ssorted = g
    cnt = counts[rows]
    maxc = int(cnt.max()) if len(cnt) else 0
    done = np.zeros(len(rows), bool)
    tb = 16
    while True:
        tbe = min(tb, max(maxc, 1))
        sel = np.flatnonzero(~done & (cnt <= tbe))
        if len(sel):
            r = rows[sel]
            seg = cnt[sel]
            src = np.repeat(starts[r], seg) + concat_arange(seg)
            cell = (np.repeat(np.arange(len(sel), dtype=np.int64) * tbe,
                              seg) + concat_arange(seg))
            vals = ssorted[src]
            if vals.size and int(vals.max()) > 255:
                raise ValueError("model symbols exceed a byte")
            sp = np.zeros(len(sel) * tbe, np.uint8)
            sp[cell] = vals
            cf, tt = run(torch.from_numpy(sp.reshape(len(sel), tbe)).to(
                device), torch.from_numpy(seg.astype(np.int32)).to(device),
                r)
            posn = posmap[order[src]]
            out[0][posn] = cf.reshape(-1).cpu().numpy()[cell]
            out[1][posn] = tt.reshape(-1).cpu().numpy()[cell]
            done[sel] = True
        if tbe >= maxc or done.all():
            break
        tb *= 4


def pass2_np(preps, device):
    """The batch's pass 2 by the numpy path: preps are _prep_job tuples
    (header, fam, mid, sym, enc, meta).  Returns (cf, tot) int32 arrays
    in event order, as DevTriples holds them."""
    n_ev = [len(p[2]) for p in preps]
    jobvec = np.repeat(np.arange(len(preps), dtype=np.int64), n_ev)
    fam = np.concatenate([p[1] for p in preps])
    gmid = jobvec * JOB_OFF + np.concatenate([p[2] for p in preps])
    sym = np.concatenate([p[3] for p in preps])
    out = (np.zeros(len(fam), np.int32), np.zeros(len(fam), np.int32))

    def walk(fn, ms=None):
        def run(sp, ct, r):
            if ms is None:
                return fn(sp, ct)
            return fn(sp, ct, torch.from_numpy(ms[r]).to(sp.device))
        return run

    for F in (F_T4, F_T2, F_N128, F_W256):
        sel = np.flatnonzero(fam == F)
        if not len(sel):
            continue
        g = group_stream(gmid[sel], sym[sel])
        rows = np.arange(len(g[0]), dtype=np.int64)
        if F in (F_T4, F_T2):
            nsym = 4 if F == F_T4 else 2
            runs = [(walk(lambda sp, ct, _n=nsym:
                          model_cuda.tiny_evolve(sp, ct, _n)), rows)]
        elif F == F_W256:
            runs = [(walk(model_cuda.evolve_256,
                          np.full(len(rows), 256, np.int32)), rows)]
        else:
            ms = _row_alphabets(g[0], [p[5] for p in preps])
            runs = [(walk(model_cuda.evolve_256, ms), rows[ms > 128]),
                    (walk(model_cuda.evolve_128, ms), rows[ms <= 128])]
        for run, rr in runs:
            if len(rr):
                evolve_grouped_np(g, run, device, rr, sel, out)
    return out
