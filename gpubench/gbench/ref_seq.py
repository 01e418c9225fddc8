"""Plain decoder of fqzcomp5's SEQ context-model stream of bases.

Bases are coded in runs of three states (upper-case ACGT, lower-case
acgt, anything else): a run length (adaptive models, 255 meaning "255
and more follows"), the run's symbols, then the next state (a 2-symbol
tiny model per state).  A base is a 2-bit symbol of a 4-symbol tiny
model chosen by the previous k bases of its read (k = the strategy's
high nibble; the context restarts from a fixed seed at each read).
With both strands (strategy bit 3), each base also updates, without
coding, the model of the reverse complement context.  Other bytes are
literals of a 256-symbol adaptive model.
"""

from __future__ import annotations

from gbench.ref_models import TOP, M32, Adaptive, CodeError, RangeDecoder, Tiny

SEED_FWD = 0x007616C7
SEED_REV = 0x2C6B62FF


def decode(payload: bytes, lens, both: int, k: int, out_size: int) -> bytes:
    """The bases of a SEQ payload; lens are the reads' lengths."""
    msize = 1 << (2 * k)
    mask = msize - 1
    top_shift = 2 * k - 2
    seed_f = SEED_FWD & mask
    seed_r = (SEED_REV >> (32 - 2 * k)) & mask
    sm = bytearray(b"\x01") * (4 * msize)   # 4 frequencies a context
    state_model = [Tiny(2) for _ in range(3)]
    run_len = [Adaptive(256) for _ in range(3)]
    literal = Adaptive(256)
    rc = RangeDecoder(payload)
    buf = payload
    nbuf = len(buf)
    out = bytearray(out_size)
    last, last2 = seed_f, seed_r
    state = 0
    lens = list(lens)
    nseq = 0
    seq_len = lens[0] if lens else 0
    nseq = 1
    i = 0
    while i < out_size:
        run = 0
        while True:
            r2 = run_len[state].decode(rc)
            run += r2
            if run > out_size:
                raise CodeError("run past the output")
            if r2 != 255:
                break
        run = min(run, out_size - i)
        if state < 2:
            bases = b"acgt" if state == 1 else b"ACGT"
            code, rng, pos = rc.code, rc.range, rc.pos
            for j in range(i, i + run):
                o = last << 2
                f0, f1, f2, f3 = sm[o], sm[o + 1], sm[o + 2], sm[o + 3]
                tot = f0 + f1 + f2 + f3
                rng //= tot
                f = code // rng
                if f < f0:
                    b, cum, fr = 0, 0, f0
                elif f < f0 + f1:
                    b, cum, fr = 1, f0, f1
                elif f < f0 + f1 + f2:
                    b, cum, fr = 2, f0 + f1, f2
                elif f < tot:
                    b, cum, fr = 3, f0 + f1 + f2, f3
                else:
                    raise CodeError("frequency past the model's total")
                code = (code - cum * rng) & M32
                rng *= fr
                while rng < TOP:
                    if pos >= nbuf:
                        raise CodeError("range-coded stream ends early")
                    code = ((code << 8) | buf[pos]) & M32
                    pos += 1
                    rng <<= 8
                sm[o + b] += 1
                if tot >= 255:
                    for x in range(o, o + 4):
                        sm[x] -= sm[x] >> 1
                last = ((last << 2) + b) & mask
                out[j] = bases[b]
                if both:
                    b2 = last2 & 3
                    last2 = (last2 >> 2) + ((3 - b) << top_shift)
                    o2 = last2 << 2
                    t2 = sm[o2] + sm[o2 + 1] + sm[o2 + 2] + sm[o2 + 3]
                    sm[o2 + b2] += 1
                    if t2 >= 255:
                        for x in range(o2, o2 + 4):
                            sm[x] -= sm[x] >> 1
                seq_len -= 1
                if seq_len == 0 and j + 1 < out_size:
                    if nseq >= len(lens):
                        raise CodeError("more bases than the reads hold")
                    seq_len = lens[nseq]
                    nseq += 1
                    last, last2 = seed_f, seed_r
            rc.code, rc.range, rc.pos = code, rng, pos
        else:
            for j in range(i, i + run):
                out[j] = literal.decode(rc)
                seq_len -= 1
                if seq_len == 0 and j + 1 < out_size:
                    if nseq >= len(lens):
                        raise CodeError("more bases than the reads hold")
                    seq_len = lens[nseq]
                    nseq += 1
                    last, last2 = seed_f, seed_r
        i += run
        if i >= out_size:
            break
        ns = state_model[state].decode(rc)
        state = ((2 if ns else 1), (2 if ns else 0), (1 if ns else 0))[state]
    return bytes(out)
