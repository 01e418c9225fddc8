"""Pass 2 of the adaptive-codec encode: per-context model evolution.

A port of the JAX package's ``ops/fqz_model_jax.py``.  Every model
context is an independent AdaptiveModel (native/rc.h; fqz-qual's qual,
selector, duplicate and length-byte models, the SEQ codec's run-length
and literal models) or TinyModel (the SEQ codec's k-mer and state
models).  Grouping the event stream by context turns the encode's
serial model updates into one walk per context; the walk emits, for
every occurrence, the (cum, freq, tot) the range coder needs, packed
as ``cf = cum << 16 | freq`` and ``tot`` (int32 planes, zero past each
context's count).

``evolve_ref`` and ``tiny_evolve_ref`` are the plain PyTorch versions
of the walks: the references the CUDA kernels (``model_cuda``,
``csrc/fqz_evolve.cu``) are held against, and the route the wrappers
take for tensors on the CPU.  They loop over occurrences with every
context of the batch vectorised.  ``group_stream`` is the JAX package's
numpy grouping, kept as the reference of ``group_stream_torch``, which
does its work with a stable device sort.  From the sort to the triples
the events stay on the device (``group_resident``, ``evolve_grouped``,
``DevTriples``): the host buckets rows by their counts, one entry a
context, and each bucket's plane is built, and its triples are
scattered to event order, on the grouping's device.  The JAX package's
pow2 padding of plane rows is gone: it bounded XLA compiles, and torch
compiles nothing per shape.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fqzcomp5_tpu_torch.mesh import Mesh, first_device, split_rows
from fqzcomp5_tpu_torch.ops import devtimer

K_MAX_FREQ = (1 << 16) - 17   # AdaptiveModel normalisation bound
NLEVELS = 15                  # pass 2's count buckets: 16 .. 2^32 (past
                              # any int32 count; the bounds below fit it)
TINY_MAX = 255                # TinyModel: halve at pre-bump tot >= 255


def evolve_ref(symplane: torch.Tensor, counts: torch.Tensor,
               max_sym: torch.Tensor, cap: int, step_inc: int = 16):
    """Evolve C independent AdaptiveModels of ``cap`` slots (128 or 256).

    symplane: (C, T) integer tensor, context c's t-th symbol; counts:
    (C,) occurrences per context (steps at or past it leave the model
    as it is); max_sym: (C,) initial alphabet size (slot j holds symbol
    j, with frequency 1 for j < max_sym and 0 above; tot = max_sym).

    Each step mirrors c_simple_model.h:63-171 (fqz_model_jax.evolve):
    emit (cum of the frequencies before the symbol's slot, its
    frequency, tot); bump the frequency and tot by step_inc; when tot
    passes K_MAX_FREQ halve every frequency (f -= f >> 1, zeros stay
    zero) and re-sum tot; then swap the slot with the one before it when
    the bumped frequency is now larger.  A symbol >= cap is in no slot:
    it emits (0, 0, tot) and bumps only tot, as the JAX scan does.

    Returns (cf, tot): (C, T) int32, ``cum << 16 | freq`` and tot, zero
    past counts[c]."""
    C, T = symplane.shape
    dev = symplane.device
    i32 = torch.int32
    slots = torch.arange(cap, device=dev, dtype=i32)
    freq = (slots[None, :] < max_sym.to(i32)[:, None]).to(i32)
    sym = slots.repeat(C, 1)          # slot -> symbol
    inv = slots.repeat(C, 1)          # symbol -> slot
    tot = max_sym.to(i32).clone()
    S = symplane.to(torch.int64)
    act_all = torch.arange(T, device=dev)[None, :] < counts.to(
        torch.int64)[:, None]
    out_cf = torch.zeros((C, T), dtype=i32, device=dev)
    out_tot = torch.zeros((C, T), dtype=i32, device=dev)
    for t in range(T):
        s = S[:, t]
        act = act_all[:, t]
        found = s < cap
        pos = inv.gather(1, s.clamp(max=cap - 1)[:, None]).to(torch.int64)
        f = freq.gather(1, pos)[:, 0]
        cum = freq.cumsum(1, dtype=i32).gather(1, pos)[:, 0] - f
        f = torch.where(found, f, 0)
        cum = torch.where(found, cum, 0)
        out_cf[:, t] = torch.where(act, (cum << 16) | f, 0)
        out_tot[:, t] = torch.where(act, tot, 0)
        # bump
        freq.scatter_add_(1, pos, ((act & found).to(i32) * step_inc)[:, None])
        tot = tot + act.to(i32) * step_inc
        # normalise on overflow (zeros stay zero)
        over = act & (tot > K_MAX_FREQ)
        if bool(over.any()):
            fo = freq[over]
            fo = fo - (fo >> 1)
            freq[over] = fo
            tot[over] = fo.sum(1, dtype=i32)
        # bubble: swap pos-1 <-> pos when freq[pos] > freq[pos-1]
        prev = (pos - 1).clamp(min=0)
        fval = freq.gather(1, pos)[:, 0]
        fprev = freq.gather(1, prev)[:, 0]
        do = act & found & (pos[:, 0] > 0) & (fval > fprev)
        if bool(do.any()):
            r = do.nonzero()[:, 0]
            p, pp = pos[r, 0], prev[r, 0]
            sp, sv = sym[r, pp], s[r].to(i32)
            freq[r, p] = fprev[r]
            freq[r, pp] = fval[r]
            sym[r, p] = sp
            sym[r, pp] = sv
            inv[r, sp.to(torch.int64)] = p.to(i32)
            inv[r, sv.to(torch.int64)] = pp.to(i32)
    return out_cf, out_tot


def evolve_prefix_mirror(symplane, counts, max_sym, cap: int,
                         step_inc: int = 16):
    """numpy mirror of csrc/fqz_evolve.cu's warp layout (evolve_kernel):
    per context, 32 lanes of K = cap/32 slots, each slot's symbol,
    frequency and cu (the frequencies of every slot before it), updated
    step by step as the kernel updates them: the bump adds step_inc to
    the owner's slot and to cu of every later slot, a halving sums the
    prefixes anew, a swap inside a lane rewrites two entries, and a swap
    across a lane boundary goes through the one value each side sends.

    At cap 256, as in the kernel, the slot-0 run window: each window of
    32 steps marks the steps whose symbol is the one in slot 0; its
    leading run of r marked steps is emitted in closed form (cum 0, f0 +
    step_inc * j, tot0 + step_inc * j for j < r), cut before the bump
    that would take tot past K_MAX_FREQ, and every other slot's cu moves
    by step_inc * r; the window's other steps are walked one by one.
    Same arguments and results as evolve_ref, as numpy int32 arrays."""
    sp = np.asarray(symplane).astype(np.int64)
    C, T = sp.shape
    K = cap // 32
    out_cf = np.zeros((C, T), np.int64)
    out_tot = np.zeros((C, T), np.int64)
    for c in range(C):
        ms = int(max_sym[c])
        sy = np.arange(cap, dtype=np.int64).reshape(32, K)
        fr = (sy < ms).astype(np.int64)
        cu = np.minimum(sy, ms)
        tot = ms
        n = min(int(counts[c]), T)
        for t0 in range(0, n, 32):
            win = sp[c, t0:min(t0 + 32, n)]
            r = 0
            if cap == 256:
                r = int(np.argmin(np.append(win == sy[0, 0], False)))
                if tot + step_inc * r > K_MAX_FREQ:
                    r = (K_MAX_FREQ - tot) // step_inc
                d = step_inc * np.arange(r)
                out_cf[c, t0:t0 + r] = fr[0, 0] + d
                out_tot[c, t0:t0 + r] = tot + d
                cu += step_inc * r
                cu[0, 0] = 0
                fr[0, 0] += step_inc * r
                tot += step_inc * r
            for i in range(r, len(win)):
                s = int(win[i])
                hit = np.argwhere(sy == s)
                found = len(hit) > 0
                o, kl = (int(hit[0, 0]), int(hit[0, 1])) if found else (32, -1)
                t = t0 + i
                if found:
                    out_cf[c, t] = int(cu[o, kl]) << 16 | int(fr[o, kl])
                    fr[o, kl] += step_inc
                    cu[o, kl + 1:] += step_inc
                    cu[o + 1:] += step_inc
                out_tot[c, t] = tot
                tot += step_inc
                if tot > K_MAX_FREQ:
                    fr -= fr >> 1
                    flat = fr.reshape(-1)
                    cu = (np.cumsum(flat) - flat).reshape(32, K)
                    tot = int(flat.sum())
                if found and kl > 0 and fr[o, kl] > fr[o, kl - 1]:
                    fv, fp = fr[o, kl], fr[o, kl - 1]
                    sy[o, kl], sy[o, kl - 1] = sy[o, kl - 1], s
                    fr[o, kl], fr[o, kl - 1] = fp, fv
                    cu[o, kl] = cu[o, kl - 1] + fv
                if found and o > 0:
                    sent = int(fr[o, 0]) if kl == 0 else 0    # owner's value
                    fprev, sprev = int(fr[o - 1, K - 1]), int(sy[o - 1, K - 1])
                    if sent > fprev:
                        fr[o - 1, K - 1], sy[o - 1, K - 1] = sent, s
                        cu[o, 0] += sent - fprev
                        fr[o, 0], sy[o, 0] = fprev, sprev
    return out_cf.astype(np.int32), out_tot.astype(np.int32)


def tiny_window_mirror(symplane, counts, nsym: int):
    """numpy mirror of csrc/fqz_evolve.cu's tiny_warp_kernel: per
    context, windows of 32 steps, lane i holding the window's i-th
    symbol.  Per symbol j a mask of the lanes holding it, and each
    lane's count of them before it, give every lane its frequencies
    from the window's starting ones.  The halving lane h is the first
    lane whose pre-bump tot (tot + the in-range symbols before it)
    reaches TINY_MAX; lanes after h start from g = halve(f + the counts
    up to and including h) and add their counts since h.  At most one
    halving falls in a window, and only (f, tot) carries to the next.
    Same arguments and results as tiny_evolve_ref, as numpy int32
    arrays."""
    sp = np.asarray(symplane).astype(np.int64)
    C, T = sp.shape
    out_cf = np.zeros((C, T), np.int64)
    out_tot = np.zeros((C, T), np.int64)
    lanes = np.arange(32)
    for c in range(C):
        f = np.ones(nsym, np.int64)
        n = min(int(counts[c]), T)
        for t0 in range(0, n, 32):
            m = min(32, n - t0)
            s = np.full(32, -1, np.int64)
            s[:m] = sp[c, t0:t0 + m]
            mk = s[None, :] == np.arange(nsym)[:, None]      # (nsym, 32)
            before = np.cumsum(mk, 1) - mk                    # lanes < i
            pre = f.sum() + before.sum(0)                     # pre-bump tot
            hs = np.flatnonzero((pre >= TINY_MAX) & (lanes < m))
            fj = f[:, None] + before
            if len(hs):
                h = int(hs[0])
                cle = mk[:, :h + 1].sum(1)
                g = f + cle
                g -= g >> 1
                after = lanes > h
                fj[:, after] = (g[:, None] + before - cle[:, None])[:, after]
                f = g + mk.sum(1) - cle
            else:
                f = f + mk.sum(1)
            tt = fj.sum(0)
            below = np.arange(nsym)[:, None] < s[None, :]
            cum = (fj * below).sum(0)
            fs = (fj * mk).sum(0)
            out_cf[c, t0:t0 + m] = (cum << 16 | fs)[:m]
            out_tot[c, t0:t0 + m] = tt[:m]
    return out_cf.astype(np.int32), out_tot.astype(np.int32)


def tiny_evolve_ref(symplane: torch.Tensor, counts: torch.Tensor,
                    nsym: int):
    """Evolve C independent TinyModels of nsym (2 or 4) symbols
    (native/rc.h TinyModel; fqz_model_jax.tiny_evolve).

    Every frequency starts at 1.  Each step emits (cum of the
    frequencies below the symbol, its frequency, tot before the bump),
    bumps the symbol's frequency by 1, and then, when the pre-bump tot
    was >= 255, halves every frequency (f - (f >> 1)).  A symbol >=
    nsym emits (tot, 0, tot) and bumps nothing.  Update-only events
    evolve the same way; their triples are dropped later.

    Returns (cf, tot): (C, T) int32 as evolve_ref's."""
    C, T = symplane.shape
    dev = symplane.device
    i32 = torch.int32
    freq = torch.ones((C, nsym), dtype=i32, device=dev)
    S = symplane.to(torch.int64)
    act_all = torch.arange(T, device=dev)[None, :] < counts.to(
        torch.int64)[:, None]
    out_cf = torch.zeros((C, T), dtype=i32, device=dev)
    out_tot = torch.zeros((C, T), dtype=i32, device=dev)
    for t in range(T):
        s = S[:, t]
        act = act_all[:, t]
        found = s < nsym
        sc = s.clamp(max=nsym - 1)[:, None]
        incl = freq.cumsum(1, dtype=i32)
        tot = incl[:, -1]
        f = torch.where(found, freq.gather(1, sc)[:, 0], 0)
        cum = torch.where(found, incl.gather(1, sc)[:, 0] - f, tot)
        out_cf[:, t] = torch.where(act, (cum << 16) | f, 0)
        out_tot[:, t] = torch.where(act, tot, 0)
        freq.scatter_add_(1, sc, (act & found).to(i32)[:, None])
        freq = torch.where((act & (tot >= TINY_MAX))[:, None],
                           freq - (freq >> 1), freq)
    return out_cf, out_tot


def group_stream(ctx: np.ndarray, qm: np.ndarray):
    """Stable-group a stream's (ctx, sym) sequence by context, CSR form.

    Returns (uniq (C,), counts (C,) i64, starts (C,) i64 into the
    sorted order, order (n,) i64 stream positions sorted by context,
    syms_sorted (n,)) -- fqz_model_jax.group_stream."""
    order = np.argsort(ctx, kind="stable")
    uniq, starts, counts = np.unique(ctx[order], return_index=True,
                                     return_counts=True)
    return (uniq, counts.astype(np.int64), starts.astype(np.int64),
            order.astype(np.int64), np.ascontiguousarray(qm[order]))


def group_stream_torch(key: torch.Tensor, sym: torch.Tensor):
    """group_stream on key's device, from a stable device sort: (uniq,
    counts, starts, idx, sym[idx]) as tensors there, the values of
    group_stream(key, sym)'s five arrays (counts, starts and idx int64,
    the symbols in their own dtype).  Stability keeps each context's
    events in stream order, the order its model updates in."""
    k, idx = torch.sort(key, stable=True)
    uniq, counts = torch.unique_consecutive(k, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    return uniq, counts, starts, idx, sym[idx]


class DevGrouping(NamedTuple):
    """A stream grouped by context, on a device: counts (C,) int32, each
    context's events; starts (C,), its first event in sorted order;
    ssorted (n,) uint8, the symbols in sorted order; gpos (n,), each
    sorted event's position in the stream.  Starts and positions are
    int32 below 2^31 events and int64 above."""
    counts: torch.Tensor
    starts: torch.Tensor
    ssorted: torch.Tensor
    gpos: torch.Tensor


def group_resident(key: torch.Tensor, sym: torch.Tensor):
    """Group a stream's (key, sym) tensors by key on their device.
    Returns (uniq, DevGrouping), all on that device: uniq (C,) int64, the
    contexts' keys in sorted order.  Raises ValueError when a symbol
    exceeds a byte (the walks' planes are uint8)."""
    if sym.dtype != torch.uint8 and bool((sym > 255).any()):
        raise ValueError("model symbols exceed a byte")
    idt = torch.int32 if len(key) < 1 << 31 else torch.int64
    uniq, counts, starts, idx, ssorted = group_stream_torch(
        key, sym.to(torch.uint8))
    return uniq, DevGrouping(counts.to(torch.int32), starts.to(idt),
                             ssorted, idx.to(idt))


class DevTriples:
    """Pass-2 results on the device, in event order: cf[i] = cum << 16 |
    freq and tot[i] of event i (int32)."""

    def __init__(self, n_total: int, device: torch.device):
        self.device = device
        self.cf = torch.zeros(n_total, dtype=torch.int32, device=device)
        self.tot = torch.zeros(n_total, dtype=torch.int32, device=device)

    def add(self, cf: torch.Tensor, tot: torch.Tensor, posn: torch.Tensor,
            cell: torch.Tensor) -> None:
        """Scatter a plane's flat cells `cell` to event positions `posn`
        (both tensors on this device).  The plane may lie on another
        device (a mesh's range): its cells are gathered there and copied
        here."""
        c = cell.to(cf.device)
        self.cf[posn] = cf.reshape(-1)[c].to(self.device)
        self.tot[posn] = tot.reshape(-1)[c].to(self.device)


def _buckets(g: DevGrouping, which: torch.Tensor, nruns: int):
    """Every row's power-of-4 count bucket (16, 64, 256, ...; the
    highest of a run cut to its longest row), worked out on g's device.
    Returns (rows, plan): rows, the row indices bucket after bucket, runs
    in order and each bucket's rows in ascending order; plan, [(run
    index, first, number of rows, tb)] in that order."""
    dev = g.counts.device
    level = torch.zeros(len(g.counts), dtype=torch.int32, device=dev)
    for k in range(NLEVELS - 1):
        level += g.counts > (16 << 2 * k)
    key = which.to(torch.int32) * NLEVELS + level
    rows = torch.sort(key, stable=True).indices
    nb = torch.bincount(key, minlength=nruns * NLEVELS)
    top = torch.zeros(nruns, dtype=torch.int32, device=dev).scatter_reduce_(
        0, which.to(torch.int64), g.counts, "amax")
    nb, top = devtimer.get(nb), devtimer.get(top)
    plan, first = [], 0
    for k in np.flatnonzero(nb):
        tb = min(16 << 2 * int(k % NLEVELS), int(top[k // NLEVELS]))
        plan.append((int(k // NLEVELS), first, int(nb[k]), tb))
        first += int(nb[k])
    return rows, plan


def _bucket_plane(g: DevGrouping, r: torch.Tensor, seg: torch.Tensor,
                  n_ev: int, tbe: int):
    """One bucket's (len(r), tbe) uint8 symbol plane, zero past each
    row's count, with its n_ev events' sorted positions and flat plane
    cells (int64), row after row: gathered on g's device from the rows
    `r` and their counts `seg` (int32 tensors there)."""
    idt = g.gpos.dtype
    row = torch.repeat_interleave(seg, output_size=n_ev)
    row0 = torch.cumsum(seg, 0, dtype=idt) - seg    # each row's first
    k = (torch.arange(n_ev, dtype=idt, device=seg.device)
         - row0.index_select(0, row))
    src = g.starts[r].index_select(0, row) + k
    cell = row.to(torch.int64) * tbe + k
    plane = torch.zeros(len(seg) * tbe, dtype=torch.uint8, device=seg.device)
    plane[cell] = g.ssorted.index_select(0, src)
    return plane.view(len(seg), tbe), src, cell


def evolve_grouped(g: DevGrouping, runs, which: torch.Tensor,
                   alphabet: torch.Tensor, device: torch.device | Mesh,
                   out: DevTriples) -> None:
    """Pass 2 over a stream grouped on the device, contexts bucketed by
    count, the triples scattered to event order in `out`.

    runs: run(plane, counts, alphabets, steps) -> (cf, tot) (C, tb)
    int32 tensors on plane's device, evolving a bucket plane's rows:
    their counts and alphabets (C,) int32, steps the plane's events.
    which (C,): the index into runs of each of g's rows; alphabet (C,)
    int32: its alphabet size; both on g's device.  Each power-of-4 count
    bucket (16, 64, 256, ...) of a run is one uint8 plane built on g's
    device -- padded cells stay within about 4x the events whatever the
    skew (fqz_model_jax.evolve_grouped).  `device` may be a
    fqzcomp5_tpu_torch.mesh.Mesh: each plane's rows then split over it,
    every range launched before any result is read, and the results
    come back to out's device.

    The buckets are worked out on the device; the host reads back a few
    numbers a bucket, and then queues each bucket's gathers, walk and
    scatter without waiting on the device."""
    if not len(g.counts):
        return
    rows, plan = _buckets(g, which, len(runs))
    seg = g.counts[rows]
    ms = alphabet[rows]
    ranges = [(runs[k], first, n, tb, split_rows(device, n))
              for k, first, n, tb in plan]
    # the events before each range's first row and after its last
    ends = sorted({first + x for _, first, _, _, split in ranges
                   for _, lo, hi in split for x in (lo, hi)} - {0})
    cum = torch.cumsum(seg, 0)[devtimer.put(np.array(ends) - 1, rows.device)]
    before = {0: 0, **dict(zip(ends, devtimer.get(cum).tolist()))}
    for run, first, n, tb, split in ranges:
        e0 = before[first]
        n_ev = before[first + n] - e0
        devtimer.count("plane_events", n_ev)
        plane, src, cell = _bucket_plane(g, rows[first:first + n],
                                         seg[first:first + n], n_ev, tb)
        launched = [run(plane[lo:hi].to(dev),
                        seg[first + lo:first + hi].to(dev),
                        ms[first + lo:first + hi].to(dev),
                        before[first + hi] - before[first + lo])
                    for dev, lo, hi in split]
        for (cf, tt), (_, lo, hi) in zip(launched, split):
            e = slice(before[first + lo] - e0, before[first + hi] - e0)
            out.add(cf, tt, g.gpos.index_select(0, src[e]),
                    cell[e] - lo * tb)


def triples_for_stream(ctx: np.ndarray, qm: np.ndarray, max_sym: int,
                       step_inc: int = 16,
                       device: torch.device | str | Mesh = "cpu"):
    """Full pass 2 for one stream of a <= 128-symbol model family:
    group and evolve on `device`, un-sort.  Returns (cum, freq, tot)
    uint32 arrays in stream order (fqz_model_jax.triples_for_stream)."""
    from fqzcomp5_tpu_torch.ops import model_cuda

    dev = device if isinstance(device, Mesh) else torch.device(device)
    first = first_device(dev)
    _, g = group_resident(
        devtimer.put(np.asarray(ctx, np.int64), first),
        devtimer.put(qm, first))

    def run(sp, ct, ms, steps):
        return model_cuda.evolve_128(sp, ct, ms, step_inc)

    out = DevTriples(len(ctx), first)
    C = len(g.counts)
    evolve_grouped(g, [run], torch.zeros(C, dtype=torch.int32, device=first),
                   torch.full((C,), max_sym, dtype=torch.int32, device=first),
                   dev, out)
    cf = devtimer.get(out.cf).view(np.uint32)
    return cf >> 16, cf & 0xFFFF, devtimer.get(out.tot).view(np.uint32)
