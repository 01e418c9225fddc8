"""The cases that the port's CPU tests and chip_smoke.py share.

Edge cases of the rANS decode walks (the dense order-1 walk, the order-0
walk, the order-0 boundary walk), of the pass-2 window walks
(csrc/fqz_evolve.cu) and of the range coder's deferred 0xFF runs; corrupt
archives; and the daemon's job processes as /proc shows them.  The tests
hold the numpy mirrors against the plain walks on these cases, and
chip_smoke.py runs the kernels on the card against the plain walks on the
same ones.  The port's modules are imported inside the builders, so that
chip_smoke.py --walk-times --root DIR loads the package under DIR after
this module.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SEED = 42   # the cases' seeds derive from it, as chip_smoke.py's do


# ---------------------------------------------------------------------
# the rANS decode walks' cases: streams encoded by the plain walk on the
# CPU, and tables no encoder makes

def normalise(counts, shift):
    """Rows of counts -> rows summing to 1<<shift, every counted symbol
    at least 1 (rows of zeros stay zero)."""
    tot = 1 << shift
    c = counts.astype(np.int64)
    rs = c.sum(-1, keepdims=True)
    k = (c > 0).sum(-1, keepdims=True)
    f = np.where(c > 0, 1 + (c * (tot - k)) // np.maximum(rs, 1), 0)
    fix = np.where(rs[..., 0] > 0, tot - f.sum(-1), 0)
    am = f.argmax(-1)
    np.put_along_axis(f, am[..., None],
                      np.take_along_axis(f, am[..., None], -1)
                      + fix[..., None], -1)
    return f


# the dense order-1 walk's edge cases (shift, A, byte 0 a symbol, where
# csrc/rans_decode_bnd.cu keeps the compact tables): A = 6 and 40 (-3's
# qualities), the shared-memory fit at shift 12 (A = 50 | 51) and at
# shift 10 (139 | 140), the packed form's last A = 64, the counter form
EDGE_T = 40
DENSE_CASES = ((10, 6, False, "shared"), (12, 6, True, "shared"),
               (10, 40, False, "shared"), (12, 40, True, "shared"),
               (12, 50, False, "shared"), (12, 51, True, "global"),
               (10, 64, True, "shared"), (12, 64, False, "global"),
               (10, 100, False, "shared"), (10, 139, True, "shared"),
               (10, 140, False, "global"))


def _compact_rows(w, nw):
    """An encode walk's (words, nwords) on the CPU -> the (B, W) int16
    word rows a decode walk reads."""
    w, nw = w.numpy(), nw.numpy()
    words = np.zeros((len(nw), max(1, int(nw.max()))), np.int16)
    for b, n in enumerate(nw):
        words[b, :n] = w[b, w.shape[1] - n:]
    return words


def dense_case(rng, A: int, shift: int, zero: bool, B: int = 3,
               T: int = EDGE_T, single: bool = True):
    """B order-1 streams of T steps a lane over A bytes (byte 0 among them
    when zero), every byte used, encoded by the plain walk on the CPU;
    with single, the second byte is always followed by the third (a
    single-symbol context, f = tot).  Returns (words (B, W) int16, R0
    (B, 32) int32, tab, A1, last0, dense symbols (B, T, 32) uint8,
    freqs (B, 256, 256)), tab from build_o1_dense_tables of freqs."""
    import torch
    from fqzcomp5_tpu_torch.ops import rans_bnd_torch, rans_torch

    pool = np.arange(1, 256)
    alpha = np.sort(rng.choice(pool, A - zero, replace=False))
    if zero:
        alpha = np.concatenate([[0], alpha])
    sym = rng.integers(0, A, (B, T, 32))
    k = A // 32 + 2
    sym[:, 1:1 + k] = (np.arange(32 * k) % A).reshape(k, 32)
    if single and A > 2:
        for t in range(1, T):
            sym[:, t] = np.where(sym[:, t - 1] == 1, 2, sym[:, t])
    byte = alpha[sym]
    flat = byte.copy()
    flat[:, 1:] += byte[:, :-1] * 256
    counts = np.stack([np.bincount(f.reshape(-1), minlength=65536)
                       for f in flat])
    freqs = normalise(counts.reshape(B, 256, 256), shift)
    Rf, w, nw = rans_torch.encode_walk_ref(
        torch.from_numpy(flat.astype(np.int32)),
        rans_torch.tables_from_numpy(freqs, "freqs", shift=shift), shift)
    tab, got, A2, A1, last0 = rans_bnd_torch.build_o1_dense_tables(freqs,
                                                                   shift)
    if A2 != A or not np.array_equal(got, alpha) or A1 != A + (not zero):
        raise AssertionError(f"dense case A={A}: the tables' alphabet is "
                             f"{A2} symbols, {A1} contexts")
    return (_compact_rows(w, nw), Rf.numpy(), tab, A1, last0,
            sym.astype(np.uint8), freqs)


def scramble_boundaries(rng, tab, A: int, A1: int):
    """Dense tables tab (B, A1 * (A+1)) with the boundary fields of the
    entries 1..A shuffled in about half of each stream's rows (tags, F
    fields and bases kept): rows whose boundaries do not rise."""
    bmask = np.uint32(0x1FFF if A <= 64 else 0x3FFF)
    E = np.asarray(tab).view(np.uint32).reshape(len(tab), A1, A + 1).copy()
    for row in E.reshape(-1, A + 1):
        if rng.random() < 0.5:
            row[1:] = (row[1:] & ~bmask) | rng.permutation(row[1:] & bmask)
    return E.reshape(len(tab), -1).view(np.int32)


def o0_case(rng, T: int = EDGE_T):
    """Four order-0 streams of T steps a lane, encoded by the plain walk:
    qualities, a single symbol (f = 4096 wraps to 0 in s3), DNA and
    uniform bytes.  Returns (words, R0, s3 (B, 4096) int32, plane (B, T,
    32) uint8)."""
    import torch
    from fqzcomp5_tpu_torch.ops import rans_torch

    plane = np.stack([rng.integers(30, 70, (T, 32)), np.full((T, 32), 65),
                      rng.choice([65, 67, 71, 84], (T, 32)),
                      rng.integers(0, 256, (T, 32))]).astype(np.uint8)
    freqs = normalise(np.stack([np.bincount(p.reshape(-1), minlength=256)
                                 for p in plane]), 12)
    Rf, w, nw = rans_torch.encode_walk_ref(
        torch.from_numpy(plane), rans_torch.tables_from_numpy(
            freqs, "freqs", shift=12), 12,
        nsym=torch.full((len(plane),), T * 32, dtype=torch.int32))
    s3 = rans_torch.build_s3(freqs, 12).view(np.int32)
    return _compact_rows(w, nw), Rf.numpy(), s3, plane


# the order-0 boundary walk's edge cases (shift, S, packed): the packed
# buckets 16 and 64 at both shifts, the counter form at S = 16 (the v2
# walk's tables) and at S = 256 (-1's) at both shifts
BND_O0_CASES = ((10, 16, True), (12, 16, True), (10, 64, True),
                (12, 64, True), (12, 16, False), (10, 256, False),
                (12, 256, False))
# the tables each case is also walked with (bnd_o0_variants), none of
# them a round trip
BND_O0_VARIANTS = ("rows below tot", "boundaries out of order",
                   "F inconsistent", "random entries", "f0 = 0",
                   "f0 = tot")


def bnd_o0_case(rng, S: int, shift: int, packed: bool, B: int = 4,
                T: int = EDGE_T):
    """B order-0 streams of T steps a lane over symbols below S, encoded
    by the plain walk at `shift`: random-walk qualities, a single symbol
    0 (f0 = tot), uniform symbols 1..S-1 (f0 = 0) and uniform 0..S-1.
    Returns (words, R0, tab (B, S) int32 of build_dec_tables_p (packed)
    or build_dec_tables, f0 (B,) int32, plane (B, T, 32) uint8, freqs
    (B, 256))."""
    import torch
    from fqzcomp5_tpu_torch.ops import rans_bnd_torch, rans_torch

    kinds = [(np.cumsum(rng.integers(-2, 3, (T, 32)), 0) % (S - 1)) + 1,
             np.zeros((T, 32)), rng.integers(1, S, (T, 32)),
             rng.integers(0, S, (T, 32))]
    plane = np.stack([kinds[b % 4] for b in range(B)]).astype(np.uint8)
    freqs = normalise(np.stack([np.bincount(p.reshape(-1), minlength=256)
                                 for p in plane]), shift)
    Rf, w, nw = rans_torch.encode_walk_ref(
        torch.from_numpy(plane), rans_torch.tables_from_numpy(
            freqs, "freqs", shift=shift), shift,
        nsym=torch.full((B,), T * 32, dtype=torch.int32))
    build = (rans_bnd_torch.build_dec_tables_p if packed
             else rans_bnd_torch.build_dec_tables)
    return (_compact_rows(w, nw), Rf.numpy(), build(freqs, shift, S),
            freqs[:, 0].astype(np.int32), plane, freqs)


def bnd_o0_variants(rng, freqs, tab, S: int, shift: int, packed: bool):
    """Tables of bnd_o0_case's streams that no encoder makes, (label, tab,
    f0) for each of BND_O0_VARIANTS: rows summing to about half of tot
    (every boundary at most m in the upper half of the slots); the
    boundary fields shuffled within each row; random F fields (in the
    counter form 18 bits with the sign bit, so the int32 shift gives F
    past 2^31); random entries and f0 (boundaries past tot, C past m by up
    to 14 bits); and f0 = 0 and f0 = tot on the true tables."""
    from fqzcomp5_tpu_torch.ops import rans_bnd_torch

    tot = 1 << shift
    build = (rans_bnd_torch.build_dec_tables_p if packed
             else rans_bnd_torch.build_dec_tables)
    bmask = np.uint32(0x1FFF if packed else 0x3FFF)
    fshift = 13 if packed else 14
    E = np.asarray(tab).view(np.uint32)
    f0 = freqs[:, 0].astype(np.int32)
    half = freqs // 2
    out = [("rows below tot", build(half, shift, S),
            half[:, 0].astype(np.int32))]
    mixed = E.copy()
    for row in mixed:
        row[:] = (row & ~bmask) | rng.permutation(row & bmask)
    out.append(("boundaries out of order", mixed.view(np.int32), f0))
    fmask = np.uint32(((1 << (13 if packed else 18)) - 1) << fshift)
    fr = rng.integers(0, 1 << 32, E.shape, dtype=np.uint64).astype(np.uint32)
    out.append(("F inconsistent",
                ((E & ~fmask) | (fr & fmask)).view(np.int32), f0))
    out.append(("random entries",
                rng.integers(0, 1 << 32, E.shape, dtype=np.uint64)
                .astype(np.uint32).view(np.int32),
                rng.integers(0, tot + 1, len(E)).astype(np.int32)))
    out.append(("f0 = 0", tab, np.zeros_like(f0)))
    out.append(("f0 = tot", tab, np.full_like(f0, tot)))
    return out


# ---------------------------------------------------------------------
# the range coder's deferred 0xFF runs (the card only)

def straddle_streams(rng, B: int, T: int, a: int, b: int):
    """(cum, freq, tot) (B, T) int64 range-coder steps: random, except
    that from step a to step b stream 0 keeps its coder interval across
    the byte boundary (steering onto it, first, through a multiple of
    2^24), so that every shift_low defers an 0xFF byte, about two a step;
    after b it leaves the boundary downwards, so the run flushes as 0xFF
    bytes a few steps later."""
    tot = rng.integers(2, 65519, (B, T))
    freq = np.minimum(rng.integers(1, 65519, (B, T)), tot)
    cum = (rng.random((B, T)) * (tot - freq + 1)).astype(np.int64)
    X, R = 0, 0xFFFFFFFF        # low + carry * 2^32, and range
    for t in range(T):
        across = X < 1 << 32 < X + R
        if a <= t < b or (t >= b and across):
            tt = 1 << 15
            q = R // tt
            if t >= b:
                c, f = 0, 1
            else:
                bd = 1 << 32 if across else ((X >> 24) + 1) << 24
                c, f = min((bd - X) // q, tt - 1), 1
                if X + c * q == bd and c > 0:
                    c, f = c - 1, 2
            tot[0, t], cum[0, t], freq[0, t] = tt, c, f
        q = R // int(tot[0, t])
        X += int(cum[0, t]) * q
        R = q * int(freq[0, t])
        for _ in range(2):
            if R < 1 << 24:
                X = (X << 8) & 0xFFFFFFFF
                R <<= 8
    return cum, freq, tot


def longest_run(data, val: int) -> int:
    m = np.concatenate([[0], (data == val).astype(np.int8), [0]])
    d = np.flatnonzero(np.diff(m))
    return int((d[1::2] - d[::2]).max()) if len(d) else 0


# ---------------------------------------------------------------------
# the pass-2 window walks' edge cases (csrc/fqz_evolve.cu)

K_MAX_FREQ = (1 << 16) - 17   # AdaptiveModel: halve when tot passes it


def _tiny_lead(rng, nsym, lane, T):
    """A TinyModel row whose first halving falls at window lane `lane`:
    tot starts at nsym and rises by one an in-range step, so the halving
    step is 255 - nsym in-range steps in; out-of-range symbols before
    them (no bump) move it to the lane.  Random in-range symbols
    follow."""
    first = (255 - nsym) % 32
    lead = (lane - first) % 32
    row = rng.integers(0, nsym, T)
    row[:lead] = nsym + 1
    return row


def tiny_window_cases():
    """{name: (symplane (C, T), counts (C,), nsym)} of the TinyModel
    window walk: a halving at every lane 0-31 of a window (nsym 4 and
    2), rows ending inside a window, symbols >= nsym, uniform
    symbols."""
    rng = np.random.default_rng(21)
    cases = {}
    for nsym in (4, 2):
        sp = np.stack([_tiny_lead(rng, nsym, k, 700) for k in range(32)])
        cases[f"halving_each_lane_nsym{nsym}"] = (
            sp, np.full(32, 700), nsym)
    T = 3 * 32 + 7
    cases["rows_end_in_window"] = (
        rng.integers(0, 4, (8, T)),
        np.array([T, 0, 1, 31, 32, 33, 64 + 17, 2 * 32]), 4)
    cases["symbols_past_nsym"] = (
        rng.integers(0, 8, (3, 1500)), np.array([1500, 1499, 290]), 4)
    cases["symbols_past_nsym2"] = (
        rng.integers(0, 5, (3, 1500)), np.array([1500, 700, 1]), 2)
    cases["uniform4"] = (rng.integers(0, 4, (2, 4000)),
                         np.array([4000, 3333]), 4)
    cases["uniform2"] = (rng.integers(0, 2, (2, 4000)),
                         np.array([4000, 2049]), 2)
    return cases


def run255(T, breaks=()):
    """Symbol 255 T times (it climbs to slot 0 in 255 steps and stays),
    with symbol 7 at the given steps."""
    row = np.full(T, 255)
    row[list(breaks)] = 7
    return row


def halvings(row, ms, step=16):
    """Steps of a 256-slot AdaptiveModel row at which the model halves
    (tot needs each symbol's frequency only, not the slot order)."""
    f = (np.arange(256) < ms).astype(np.int64)
    tot, out = int(ms), []
    for t, s in enumerate(row):
        f[s] += step
        tot += step
        if tot > K_MAX_FREQ:
            f -= f >> 1
            tot = int(f.sum())
            out.append(t)
    return out


def run_window_cases():
    """{name: (symplane (C, T), counts (C,), max_sym (C,))} of the
    256-slot walk's slot-0 run window: a run of 255 entering slot 0,
    broken at window lanes 0, 1 and 31; halvings inside runs; max_sym
    129 and 256; uniform symbols; slot 0 changing hands."""
    rng = np.random.default_rng(22)
    cases = {}
    # once 255 holds slot 0 (from step 255), breaks at window lanes 0, 1
    # and 31, alone and in pairs
    brk = [[32 * w + lane for w in range(12, 40, 3)] for lane in (0, 1, 31)]
    brk.append([32 * 20, 32 * 20 + 1, 32 * 25 + 31, 32 * 26])
    cases["run255_breaks_at_lanes_0_1_31"] = (
        np.stack([run255(2000, b) for b in brk]), np.full(4, 2000),
        np.full(4, 256))
    # halvings inside runs.  With STEP 16 tot is max_sym + 16 t up to
    # the first halving whatever the data, so max_sym sets the halvings'
    # window lanes (first 14-30, second 6-30 for max_sym 256-0).  The
    # closed form stops before a halving, so runs that end on their
    # halving step: cut by a break right after it, and a row whose count
    # ends on it.
    ms = np.array([256, 200, 129, 64, 0, 256, 256])
    rows = [run255(6200) for _ in ms]
    first = halvings(rows[5], 256)[0]
    rows[5][first + 1] = 7
    counts = np.full(len(ms), 6200)
    counts[6] = first + 1
    cases["halving_inside_run"] = (np.stack(rows), counts, ms)
    z = np.minimum(rng.zipf(1.3, (3, 3000)) - 1, 255)
    cases["max_sym129"] = (np.minimum(z, 128), np.array([3000, 2500, 77]),
                           np.full(3, 129))
    cases["max_sym256"] = (z, np.array([3000, 2999, 33]), np.full(3, 256))
    cases["uniform256"] = (rng.integers(0, 256, (2, 3000)),
                           np.array([3000, 1000]), np.full(2, 256))
    # slot 0's own symbol changes while runs go on (0 leads, 255 takes
    # over), rows ending inside a window
    mix = np.where(rng.random((2, 3000)) < 0.9,
                   np.where(np.arange(3000) < 1500, 0, 255), 9)
    cases["slot0_changes_rows_end_in_window"] = (
        mix, np.array([3000 - 13, 1500 + 31]), np.full(2, 256))
    return cases


# ---------------------------------------------------------------------
# corrupt archives and the daemon's jobs

def corrupt_corpus(nrec: int, L: int) -> bytes:
    """A FASTQ of nrec reads of L bp (chip_smoke.make_corpus's model, seed SEED
    + 7)
    for the corrupt-archive checks."""
    rng = np.random.default_rng(SEED + 7)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), (nrec, L))
    q = (np.cumsum(rng.integers(-2, 3, (nrec, L)), axis=1) % 40 + 36
         ).astype(np.uint8)
    return b"".join(b"@c%d\n" % k + seq[k].tobytes() + b"\n+\n"
                    + q[k].tobytes() + b"\n" for k in range(nrec))


def _payload_spans(raw: bytes) -> dict:
    """{"seq"/"qual": (offset, length)} of the first block's section
    payloads in an FQZ5 v1.1 archive (cuda_driver._split_block's walk)."""
    from fqzcomp5_tpu_torch.utils import varint

    off = 16 + 12                       # magic, index offset; block head
    (clen,) = struct.unpack_from("<I", raw, off + 5)
    off += 9 + clen                     # names
    lstrat = raw[off]
    off += 1
    if lstrat > 0:
        off += varint.get_u32(raw, off)[1]
    else:
        off += 4 + struct.unpack_from("<I", raw, off)[0]
    spans = {}
    for key in ("seq", "qual"):
        (clen,) = struct.unpack_from("<I", raw, off + 5)
        spans[key] = (off + 9, clen)
        off += 9 + clen
    return spans


def corrupt_archive(raw: bytes, seed: int) -> tuple[bytes, str]:
    """One seeded mutation of a one-block FQZ5 v1.1 archive: (bytes,
    what).  By seed mod 8: 0, 4 stomp bytes of the block's qual payload,
    1, 5 of its seq payload, 2 of the first 24 bytes of its seq payload
    (order byte, sizes, frequency tables); 6 sets the qual payload's
    output size to 2^32 - 1; each recomputes the block's CRC (and sizes
    and index offset), so that the mutation reaches the section decoders
    (tests/test_fuzz_deep.py's _refix).  3 and 7 truncate the archive
    inside the block."""
    from fqzcomp5_tpu_torch.utils import varint

    rng = np.random.default_rng(SEED + 100 + seed)
    bad = bytearray(raw)
    start = 16
    end = min(start + 4 + struct.unpack_from("<I", raw, start)[0], len(raw))
    spans = _payload_spans(raw)
    kind = seed % 8
    if kind in (3, 7):
        cut = int(rng.integers(start + 12, end))
        return bytes(bad[:cut]), f"truncated at {cut} of {len(raw)}"
    if kind == 6:
        off, n = spans["qual"]
        nb = varint.get_u32(raw, off + 1)[1]
        size = varint.put_u32(0xFFFFFFFF)
        bad[off + 1:off + 1 + nb] = size
        d = len(size) - nb
        end += d
        for at, fmt in ((start, "<I"), (off - 4, "<I"), (8, "<Q")):
            struct.pack_into(fmt, bad, at,
                             struct.unpack_from(fmt, raw, at)[0] + d)
        what = "qual payload's output size set to 2^32 - 1"
    else:
        sec = ("qual", "seq", "seq")[kind % 4]
        off, n = spans[sec]
        n = min(n, 24) if kind == 2 else n
        pos = sorted(int(p) for p in off + rng.integers(0, n, 1 + seed % 3))
        for p in pos:
            bad[p] = (bad[p] + int(rng.integers(1, 256))) & 0xFF
        what = f"{sec} payload stomped at {pos}"
    struct.pack_into("<I", bad, start + 8,
                     zlib.crc32(bytes(bad[start + 12:end])) & 0xFFFFFFFF)
    return bytes(bad), what


def job_children(server_pid: int) -> list:
    """The daemon server's job children: its child processes that lead
    their own process group (daemon._run_child)."""
    kids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fp:
                fields = fp.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == server_pid and int(fields[2]) == int(name):
            kids.append(int(name))
    return kids
