"""Plain decoder of the FQZ quality stream (htscodecs fqzcomp_qual
format, version 5), as fqzcomp5 writes it.

Header: the output size (varint), then the parameters: version, global
flags (several parameter sets, a selector table, reversal, use of the
bases), per set a 16-bit starting context, flags, the symbol count,
bit sizes and positions of the quality, position, delta, selector and
base parts of the 16-bit context, and the tables that map qualities,
positions and deltas to context bits (run-length coded twice).  Per
read: a selector symbol (several sets), its length as four bytes
(unless fixed and known), a reversal bit, a duplicate bit; then each
quality from the adaptive model of its context.
"""

from __future__ import annotations

from gbench.ref_models import (M32, MAX_FREQ, TOP, Adaptive, CodeError,
                               RangeDecoder)

VERS = 5
G_MULTI, G_STAB, G_REV, G_SEQ = 1, 2, 4, 8
P_DEDUP, P_LEN, P_SEL, P_QMAP, P_PTAB, P_DTAB, P_QTAB = (2, 4, 8, 16, 32,
                                                         64, 128)
CTX_SIZE = 1 << 16
BASE = {ord(c): v for c, v in (("C", 1), ("c", 1), ("G", 2), ("g", 2),
                               ("T", 3), ("t", 3), ("U", 3), ("u", 3))}


def get_uv(buf: bytes, off: int) -> tuple[int, int]:
    v = 0
    for _ in range(6):
        c = buf[off]
        off += 1
        v = (v << 7) | (c & 0x7F)
        if not c & 0x80:
            return v & M32, off
    raise CodeError("varint too long")


def read_array(buf: bytes, off: int, size: int) -> tuple[list[int], int]:
    """A table of size entries stored as runs of runs."""
    R = []
    z = 0
    last = -1
    i = off
    while z < size and i < len(buf):
        run = buf[i]
        R.append(run)
        z += run
        if run == last:
            i += 1
            copy = buf[i]
            z += run * copy
            R.extend([run] * copy)
        last = run
        i += 1
    out = []
    k = 0
    value = 0
    while len(out) < size:
        run_len = 0
        while True:
            if k >= len(R):
                raise CodeError("table runs end early")
            part = R[k]
            k += 1
            run_len += part
            if part != 255:
                break
        out.extend([value] * min(run_len, size - len(out)))
        value += 1
    return out, i


class Param:
    pass


def read_parameters(buf: bytes, off: int):
    vers = buf[off]
    if vers != VERS:
        raise CodeError(f"fqz version {vers}")
    gflags = buf[off + 1]
    off += 2
    nparam = buf[off] if gflags & G_MULTI else 1
    off += 1 if gflags & G_MULTI else 0
    max_sel = nparam if nparam > 1 else 0
    if gflags & G_STAB:
        max_sel = buf[off]
        stab, off = read_array(buf, off + 1, 256)
    else:
        stab = [min(i, nparam - 1) for i in range(256)]
    params = []
    for _ in range(nparam):
        pm = Param()
        pm.context = buf[off] | buf[off + 1] << 8
        pf = buf[off + 2]
        pm.do_sel = bool(pf & P_SEL)
        pm.fixed_len = bool(pf & P_LEN)
        pm.do_dedup = bool(pf & P_DEDUP)
        pm.max_sym = buf[off + 3]
        pm.qbits, pm.qshift = buf[off + 4] >> 4, buf[off + 4] & 15
        pm.qloc, pm.sloc = buf[off + 5] >> 4, buf[off + 5] & 15
        pm.ploc, pm.dloc = buf[off + 6] >> 4, buf[off + 6] & 15
        off += 7
        pm.bbits = pm.bloc = pm.boff = 0
        if gflags & G_SEQ:
            pm.bbits, pm.bloc = buf[off] >> 4, buf[off] & 15
            pm.boff = buf[off + 1] >> 4
            off += 2
        if pf & P_QMAP:
            pm.qmap = list(buf[off:off + pm.max_sym]) + [None] * (
                256 - pm.max_sym)
            off += pm.max_sym
        else:
            pm.qmap = list(range(256))
        pm.qtab = list(range(256))
        if pm.qbits and pf & P_QTAB:
            pm.qtab, off = read_array(buf, off, 256)
        pm.ptab = [0] * 1024
        if pf & P_PTAB:
            pm.ptab, off = read_array(buf, off, 1024)
        pm.dtab = [0] * 256
        if pf & P_DTAB:
            pm.dtab, off = read_array(buf, off, 256)
        pm.ptab = [v << pm.ploc for v in pm.ptab]
        pm.dtab = [v << pm.dloc for v in pm.dtab]
        pm.qmask = (1 << pm.qbits) - 1
        if pm.do_sel and max_sel == 0:
            raise CodeError("selector without selector values")
        params.append(pm)
    return gflags, max_sel, stab, params, off


def decode(payload: bytes, out_size: int, seq: bytes | None = None) -> bytes:
    """The qualities (Phred values) of an FQZ payload; seq: the block's
    bases, for streams whose contexts use them."""
    n, off = get_uv(payload, 0)
    if n != out_size:
        raise CodeError("fqz size differs from the section's")
    gflags, max_sel, stab, params, off = read_parameters(payload, off)
    max_sym = max(pm.max_sym for pm in params)
    if max_sym + 1 > 97:
        raise CodeError("quality alphabet past 96 symbols")
    nq = max_sym + 1
    models = [None] * CTX_SIZE
    lenm = [Adaptive(256) for _ in range(4)]
    revm, dupm = Adaptive(2), Adaptive(2)
    selm = Adaptive(max_sel + 1) if max_sel > 0 else None
    rc = RangeDecoder(payload, off)
    buf, nbuf = payload, len(payload)
    out = bytearray(n)
    rev = []
    first_len = True
    last_len = 0
    seq_pos = 0
    i = 0
    pm = params[0]       # the last read's set decides whether one is coded
    while i < n:
        s = 0
        if pm.do_sel or gflags & G_MULTI:
            s = selm.decode(rc) if selm else 0
        x = stab[min(s, 255)] if gflags & G_STAB else s
        if x >= len(params):
            raise CodeError("selector past the parameter sets")
        pm = params[x]
        rlen = last_len
        if not pm.fixed_len or first_len:
            rlen = (lenm[0].decode(rc) | lenm[1].decode(rc) << 8
                    | lenm[2].decode(rc) << 16 | lenm[3].decode(rc) << 24)
            first_len = False
            last_len = rlen
        if rlen > n - i or rlen == 0:
            raise CodeError("read length past the output")
        if gflags & G_REV:
            rev.append((i, rlen, revm.decode(rc)))
        if pm.do_dedup and dupm.decode(rc):
            if rlen > i:
                raise CodeError("duplicate of nothing")
            out[i:i + rlen] = out[i - rlen:i]
            i += rlen
            seq_pos += rlen
            continue
        bases = [0] * rlen
        if seq is not None and gflags & G_SEQ:
            bases = [BASE.get(c, 0) for c in seq[seq_pos + pm.boff:
                                                 seq_pos + rlen]]
            bases += [0] * (rlen - len(bases))
            sctx = 0
            for c in seq[seq_pos:seq_pos + pm.boff]:
                sctx = (sctx << 2) | BASE.get(c, 0)
        else:
            sctx = 0
        seq_pos += rlen
        # the record's qualities, the model walk inlined
        qshift, qtab, qmask, qloc = pm.qshift, pm.qtab, pm.qmask, pm.qloc
        ptab, dtab, qmap = pm.ptab, pm.dtab, pm.qmap
        bmask, bloc = (1 << pm.bbits) - 1, pm.bloc
        sbits = s << pm.sloc
        last = pm.context
        qctx = delta = prevq = 0
        p = rlen
        code, rng, pos = rc.code, rc.range, rc.pos
        for j in range(rlen):
            m = models[last]
            if m is None:
                m = models[last] = [list(range(nq)), [1] * nq, nq]
            syms, freqs, tot = m
            rng //= tot
            f = code // rng
            if f > MAX_FREQ:
                raise CodeError("frequency past the model's limit")
            acc = 0
            k = 0
            for fr in freqs:
                acc += fr
                if acc > f:
                    break
                k += 1
            else:
                raise CodeError("frequency past the model's total")
            code = (code - (acc - fr) * rng) & M32
            rng *= fr
            while rng < TOP:
                if pos >= nbuf:
                    raise CodeError("range-coded stream ends early")
                code = ((code << 8) | buf[pos]) & M32
                pos += 1
                rng <<= 8
            freqs[k] += 16
            tot += 16
            if tot > MAX_FREQ:
                tot = 0
                for z in range(nq):
                    freqs[z] -= freqs[z] >> 1
                    tot += freqs[z]
            m[2] = tot
            Q = syms[k]
            if k and freqs[k] > freqs[k - 1]:
                freqs[k], freqs[k - 1] = freqs[k - 1], freqs[k]
                syms[k], syms[k - 1] = syms[k - 1], Q
            q = qmap[Q]
            if q is None:
                raise CodeError("symbol outside the quality map")
            out[i + j] = q
            qctx = ((qctx << qshift) + qtab[Q]) & M32
            sctx = ((sctx << 2) | bases[j]) & bmask
            last = (((qctx & qmask) << qloc) + ptab[p if p < 1023 else 1023]
                    + dtab[delta if delta < 255 else 255] + (sctx << bloc)
                    + sbits) & 0xFFFF
            delta += prevq != Q
            prevq = Q
            p -= 1
        rc.code, rc.range, rc.pos = code, rng, pos
        i += rlen
    for start, rl, r in rev:
        if r:
            out[start:start + rl] = out[start:start + rl][::-1]
    return bytes(out)
