"""Plain NumPy decoder of the rANS Nx16 streams of FQZ5 archives.

The format is htscodecs' rANS_static4x16pr family as fqzcomp5 writes it:
an order byte (PACK 0x80, RLE 0x40, CAT 0x20, NOSZ 0x10, STRIPE 0x08,
X32 0x04, order-1 0x01), the output size as a big-endian base-128 varint
unless NOSZ, the PACK and RLE metadata, then a frequency table and N = 4
(or 32 with X32) interleaved 32-bit states over one stream of 16-bit
little-endian words.  Written from the format's description, not from
the program's code: it shares nothing with the program.

Decoding is split so that many streams walk together: ``parse`` turns a
payload into a tree of transforms over "core" jobs (one rANS stream
each), ``decode_cores`` walks every job of a kind (lanes x order) at
once, one NumPy step for all their lanes, and ``finish`` applies the
transforms.  ``uncompress`` does the three for one payload.
"""

from __future__ import annotations

import numpy as np

PACK, RLE, CAT, NOSZ, STRIPE, X32 = 0x80, 0x40, 0x20, 0x10, 0x08, 0x04
RANS_L = 1 << 15
TF_SHIFT = 12


class FormatError(ValueError):
    """The payload breaks the format."""


def get_uv(buf: bytes, off: int) -> tuple[int, int]:
    """(value, offset after it) of the big-endian base-128 varint at off."""
    v = 0
    for k in range(5):
        if off >= len(buf):
            raise FormatError("truncated varint")
        c = buf[off]
        off += 1
        v = (v << 7) | (c & 0x7F)
        if not c & 0x80:
            return v, off
    raise FormatError("varint longer than 5 bytes")


def _alphabet(buf: bytes, off: int) -> tuple[list[int], int]:
    """Symbols of a run-length coded alphabet (a symbol, and after two
    consecutive symbols the count of the run that follows; 0 ends it,
    though a leading 0 is the symbol 0)."""
    syms = []
    rle = 0
    j = buf[off]
    off += 1
    while True:
        syms.append(j)
        if rle:
            rle -= 1
            j += 1
            if j > 255:
                raise FormatError("alphabet run past 255")
        else:
            if off >= len(buf):
                raise FormatError("truncated alphabet")
            nxt = buf[off]
            off += 1
            if nxt == j + 1:
                if off >= len(buf):
                    raise FormatError("truncated alphabet")
                j = nxt
                rle = buf[off]
                off += 1
            else:
                j = nxt
        if j == 0:
            return syms, off


def _normalise(F: np.ndarray, total: int, shift: int) -> np.ndarray:
    """Scale stored frequencies up to 1 << shift (a power-of-two total
    shifted left, as the encoder stored it)."""
    tot = 1 << shift
    if total == 0 or total == tot:
        return F
    k = 0
    while total < tot:
        total *= 2
        k += 1
    if total != tot:
        raise FormatError("frequency total not a power of two")
    return F << k


def _slot_table(F: np.ndarray, shift: int) -> tuple[np.ndarray, np.ndarray]:
    """(symbol, f << 16 | offset in run) of every slot of a cumulative
    frequency table of total 1 << shift."""
    tot = 1 << shift
    if int(F.sum()) != tot:
        raise FormatError("frequencies do not fill the table")
    syms = np.repeat(np.arange(256, dtype=np.uint8), F)
    start = np.repeat(np.cumsum(F) - F, F)
    fy = (np.repeat(F, F).astype(np.int64) << 16) | (np.arange(tot) - start)
    return syms, fy


class Core:
    """One rANS stream to walk: lanes N, order, out_len symbols."""

    def __init__(self, n: int, order: int, out_len: int):
        self.n = n
        self.order = order
        self.out_len = out_len
        self.result: bytes | None = None


def _o0_tables(buf: bytes, off: int):
    syms, off = _alphabet(buf, off)
    F = np.zeros(256, np.int64)
    for s in syms:
        F[s], off = get_uv(buf, off)
    F = _normalise(F, int(F.sum()), TF_SHIFT)
    return F, off


def _core(payload: bytes, n: int, order: int, out_len: int) -> Core:
    """Parse a core payload (tables, states, words) into a Core job."""
    c = Core(n, order, out_len)
    if out_len == 0:
        c.result = b""
        return c
    off = 0
    if order == 0:
        F, off = _o0_tables(payload, 0)
        c.shift = TF_SHIFT
        c.rows = {0: _slot_table(F, TF_SHIFT)}
    else:
        shift = payload[0] >> 4
        if shift not in (10, 12):
            raise FormatError(f"order-1 shift {shift}")
        tab = payload
        toff = 1
        if payload[0] & 1:
            usz, toff = get_uv(payload, 1)
            csz, toff = get_uv(payload, toff)
            inner = _core(payload[toff:toff + csz], 4, 0, usz)
            decode_cores([inner])
            tab = inner.result
            off = toff + csz
            toff = 0
        ctxs, toff = _alphabet(tab, toff)
        present = np.zeros(256, bool)
        present[ctxs] = True
        rows = {}
        for i in ctxs:
            F = np.zeros(256, np.int64)
            dz = 0
            for j in np.flatnonzero(present):
                if dz:
                    dz -= 1
                    continue
                F[j], toff = get_uv(tab, toff)
                if F[j] == 0:
                    dz = tab[toff]
                    toff += 1
            T = int(F.sum())
            if T:
                rows[i] = _slot_table(_normalise(F, T, shift), shift)
        if not payload[0] & 1:
            off = toff
        c.shift = shift
        c.rows = rows
    if off + 4 * n > len(payload):
        raise FormatError("truncated states")
    c.R = np.frombuffer(payload, "<u4", n, off).astype(np.int64)
    if (c.R < RANS_L).any():
        raise FormatError("state below the renormalisation bound")
    words = payload[off + 4 * n:]
    if len(words) % 2:
        words += b"\0"
    c.words = np.frombuffer(words, "<u2").astype(np.int64)
    return c


def decode_cores(cores: list[Core]) -> None:
    """Walk every pending core, all cores of one lane count at once."""
    kinds = {}
    for c in cores:
        if c.result is None:
            kinds.setdefault(c.n, []).append(c)
    for n, group in kinds.items():
        _walk(group, n)


def _walk(group: list[Core], n: int) -> None:
    # order-0: symbol i on lane i % n, full groups of n update every lane;
    # order-1: lane z owns symbols [z * isz, (z + 1) * isz), the last
    # lane also the remainder, and its context is its last symbol (0 at
    # the start).  Both walk out_len // n steps on every lane.  Jobs run
    # longest first, so the jobs still walking are a prefix of the rows.
    group = sorted(group, key=lambda c: -(c.out_len // n))
    steps = [c.out_len // n for c in group]
    J = len(group)
    width = max(1 << c.shift for c in group)
    # one row of slots per (job, context): symbol, frequency, offset in
    # the symbol's run, and the row the symbol leads to (its own row
    # under order-1, the job's one row under order-0)
    rowbase = np.zeros((J, 256), np.int64)
    rows = []
    for j, c in enumerate(group):
        for ctx, tab in c.rows.items():
            rowbase[j, ctx] = len(rows) * width
            rows.append((j, tab))
    sym = np.zeros((len(rows), width), np.uint8)
    fy = np.zeros((len(rows), width), np.int64)
    nxt = np.zeros((len(rows), width), np.int64)
    for r, (j, (s, f)) in enumerate(rows):
        sym[r, :len(s)] = s
        fy[r, :len(f)] = f
        if group[j].order:
            nxt[r, :len(s)] = rowbase[j, s]
        else:
            nxt[r, :] = rowbase[j, 0]
    sym, nxt = sym.ravel(), nxt.ravel()
    f, y = (fy >> 16).ravel(), (fy & 0xFFFF).ravel()
    shift = np.array([c.shift for c in group], np.int64)[:, None]
    mask = (1 << shift) - 1
    R = np.stack([c.R for c in group])
    base = np.repeat(rowbase[:, :1], n, axis=1)
    wlen = np.array([len(c.words) for c in group], np.int64)
    wbase = np.concatenate([[0], np.cumsum(wlen)])
    # words shifted by one: the k-th renormalising lane of a step (k
    # from 1) reads word wptr + k - 1
    words = np.concatenate([[0]] + [c.words for c in group]
                           + [np.zeros(n + 1, np.int64)])
    wptr = wbase[:-1].copy()
    T = steps[0] if J else 0
    out = np.zeros((T, J, n), np.uint8)
    t = 0
    for active in range(J, 0, -1):
        stop = steps[active - 1]
        if stop <= t:
            continue
        Ra, ba, wa = R[:active], base[:active], wptr[:active]
        sh, mk, oa = shift[:active], mask[:active], out[:, :active]
        for t in range(t, stop):
            ix = ba + (Ra & mk)
            oa[t] = sym[ix]
            ba = nxt[ix]
            Ra = f[ix] * (Ra >> sh) + y[ix]
            low = Ra < RANS_L
            k = np.add.accumulate(low.view(np.uint8), axis=1, dtype=np.uint8)
            np.putmask(Ra, low, (Ra << 16) | words[wa[:, None] + k])
            wa = wa + k[:, -1]
        t = stop
        R[:active], base[:active], wptr[:active] = Ra, ba, wa
    if (wptr > wbase[1:]).any():
        raise FormatError("stream read past its end")
    for j, c in enumerate(group):
        G = steps[j]
        body = out[:G, j, :]
        rem = c.out_len - G * n
        if c.order == 0:
            tail = sym[base[j, :rem] + (R[j, :rem] & int(mask[j, 0]))]
            res = np.concatenate([body.ravel(), tail])
        else:
            tail = _o1_tail(c, int(R[j, n - 1]), int(base[j, n - 1]),
                            sym, nxt, f, y, words, int(wptr[j]),
                            int(wbase[j + 1]), rem)
            res = np.concatenate([body.T.ravel(), tail])
        c.result = res.tobytes()


def _o1_tail(c, r, b, sym, nxt, f, y, words, wptr, wend, count):
    """The order-1 symbols past n * isz, all on the last lane."""
    out = np.zeros(count, np.uint8)
    mask = (1 << c.shift) - 1
    for i in range(count):
        ix = b + (r & mask)
        out[i] = sym[ix]
        b = int(nxt[ix])
        r = int(f[ix]) * (r >> c.shift) + int(y[ix])
        if r < RANS_L and wptr < wend:
            r = (r << 16) | int(words[wptr + 1])
            wptr += 1
    return out


# ---------------------------------------------------------------------
# Transforms

class Node:
    """A parsed payload: kind "stripe", "plain" or "cat"."""


def parse(buf: bytes, size: int | None = None) -> Node:
    """Parse one rANS payload; size is the known output size (needed
    where the payload has NOSZ)."""
    if not buf:
        raise FormatError("empty rANS payload")
    node = Node()
    flags = buf[0]
    if flags & STRIPE:
        ulen, off = get_uv(buf, 1)
        N = buf[off]
        off += 1
        if N < 1:
            raise FormatError("stripe of no streams")
        clens = []
        for _ in range(N):
            cl, off = get_uv(buf, off)
            clens.append(cl)
        node.kind = "stripe"
        node.ulen = ulen
        node.parts = []
        for i, cl in enumerate(clens):
            ul = ulen // N + (1 if ulen % N > i else 0)
            node.parts.append(parse(buf[off:off + cl], ul))
            off += cl
        return node
    off = 1
    if flags & NOSZ:
        if size is None:
            raise FormatError("NOSZ payload of unknown size")
        osz = size
    else:
        osz, off = get_uv(buf, off)
    node.osz = osz
    node.flags = flags
    inner = osz
    if flags & PACK:
        nsym = buf[off] or 256
        nmap = nsym if nsym <= 16 else 0
        node.pmap = np.frombuffer(buf[off + 1:off + 1 + nmap], np.uint8)
        if len(node.pmap) != nmap:
            raise FormatError("truncated PACK map")
        node.npacked = nsym
        off += 1 + nmap
        inner, off = get_uv(buf, off)
    node.rle = None
    if flags & RLE:
        umeta, off = get_uv(buf, off)
        rle_len, off = get_uv(buf, off)
        if umeta & 1:
            node.rle = ("raw", buf[off:off + umeta // 2])
            off += umeta // 2
        else:
            cmeta, off = get_uv(buf, off)
            node.rle = ("core", _core(buf[off:off + cmeta],
                                      32 if flags & X32 else 4, 0,
                                      umeta // 2))
            off += cmeta
        inner = rle_len
    node.inner_len = inner
    if flags & CAT:
        node.kind = "cat"
        node.data = buf[off:off + inner]
        if len(node.data) != inner:
            raise FormatError("truncated CAT payload")
    else:
        node.kind = "plain"
        node.core = _core(buf[off:], 32 if flags & X32 else 4, flags & 1,
                          inner)
    return node


def cores_of(node: Node) -> list[Core]:
    if node.kind == "stripe":
        return [c for p in node.parts for c in cores_of(p)]
    out = [node.core] if node.kind == "plain" else []
    if node.rle and node.rle[0] == "core":
        out.append(node.rle[1])
    return out


def finish(node: Node) -> bytes:
    """The decoded bytes of a parsed payload whose cores are walked."""
    if node.kind == "stripe":
        parts = [np.frombuffer(finish(p), np.uint8) for p in node.parts]
        N = len(parts)
        out = np.zeros(node.ulen, np.uint8)
        for i, p in enumerate(parts):
            out[i::N] = p
        return out.tobytes()
    data = node.data if node.kind == "cat" else node.core.result
    if node.rle:
        kind, meta = node.rle
        meta = meta if kind == "raw" else meta.result
        data = _unrle(data, meta)
    if node.flags & PACK:
        data = _unpack(data, node.pmap, node.npacked, node.osz)
    if len(data) != node.osz:
        raise FormatError("decoded size differs from the stated size")
    return data


def _unrle(lits: bytes, meta: bytes) -> bytes:
    n = meta[0] or 256
    saved = set(meta[1:1 + n])
    runs = meta[1 + n:]
    out = bytearray()
    off = 0
    for b in lits:
        if b in saved:
            rl, off = get_uv(runs, off)
            out += bytes([b]) * (rl + 1)
        else:
            out.append(b)
    return bytes(out)


def _unpack(data: bytes, pmap: np.ndarray, nsym: int, osz: int) -> bytes:
    if nsym > 16:
        return data
    if nsym <= 1:
        return bytes([int(pmap[0])]) * osz
    bits = 1 if nsym <= 2 else 2 if nsym <= 4 else 4
    per = 8 // bits
    d = np.frombuffer(data, np.uint8)
    if len(d) * per < osz:
        raise FormatError("packed data shorter than its output")
    vals = (d[:, None] >> (np.arange(per) * bits)) & ((1 << bits) - 1)
    return pmap[vals.ravel()[:osz]].tobytes()


def uncompress(buf: bytes, size: int | None = None) -> bytes:
    node = parse(buf, size)
    decode_cores(cores_of(node))
    return finish(node)
