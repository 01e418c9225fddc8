"""Plain decoder of tok3 name streams (htscodecs tokenise_name3 format).

Header: the decoded size u32, the name count u32, an arith flag byte.
Then token streams, each a type byte (bit 7: the next token position;
low 4 bits: the token type; bit 6: a copy of an earlier stream named by
two bytes) and, unless copied, a framed rANS payload (its size as a
varint, then the payload).  A position whose type stream is not stored
repeats MATCH, except for the first name.  Each name starts with a
type (DIFF or DUP) and the distance to the name it refers to; each
later position's type says how to make the token: an alpha string, a
character, digits (with or without leading zeros, or as a delta on the
referred name's token), MATCH (the referred name's token), NOP or END.
"""

from __future__ import annotations

import struct

from gbench import ref_rans

(T_TYPE, T_ALPHA, T_CHAR, T_DIGITS0, T_DZLEN, T_DUP, T_DIFF, T_DIGITS,
 T_DDELTA, T_DDELTA0, T_MATCH, T_NOP, T_END) = range(13)
MAX_TOKENS = 128


class Tok3Error(ValueError):
    pass


def _streams(buf: bytes) -> tuple[int, int, dict]:
    if len(buf) < 9:
        raise Tok3Error("short tok3 stream")
    ulen, nreads = struct.unpack_from("<II", buf, 0)
    if buf[8]:
        raise Tok3Error("arith-coded tok3 streams are not read here")
    desc = {}
    o = 9
    tnum = -1
    while o < len(buf):
        ttype = buf[o]
        o += 1
        if ttype & 128:
            tnum += 1
            if tnum >= MAX_TOKENS:
                raise Tok3Error("too many token positions")
        if ttype & 15 and ttype & 128:
            desc[tnum << 4] = bytes([ttype & 15]) + bytes([T_MATCH]) * (
                nreads - 1) if nreads else b""
        if tnum < 0:
            raise Tok3Error("stream before the first position")
        i = (tnum << 4) | (ttype & 15)
        if ttype & 64:
            j = (buf[o] << 4) | buf[o + 1]
            o += 2
            if j >= i or j not in desc:
                raise Tok3Error("copy of a missing stream")
            desc[i] = desc[j]
            continue
        clen, o = ref_rans.get_uv(buf, o)
        desc[i] = ref_rans.uncompress(buf[o:o + clen])
        o += clen
    return ulen, nreads, desc


class _Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0


def _fixed(v: int, n: int) -> bytes:
    """v as n digits, the first one carrying any excess (as the format's
    decoder writes it)."""
    out = bytearray()
    for k in range(n - 1, -1, -1):
        out.append((v // 10 ** k + 48) & 0xFF)
        v %= 10 ** k
    return bytes(out)


def _var(v: int) -> bytes:
    return str(v).encode() if v else b""


def decode(buf: bytes) -> bytes:
    """The names, each ended by a NUL."""
    ulen, nreads, desc = _streams(buf)
    cur = {k: _Cursor(v) for k, v in desc.items()}
    max_tok = max((k >> 4 for k in desc), default=-1) + 1

    def byte(k):
        c = cur.get(k)
        if c is None or c.pos >= len(c.data):
            raise Tok3Error("token stream ends early")
        c.pos += 1
        return c.data[c.pos - 1]

    def u32(k):
        c = cur.get(k)
        if c is None or c.pos + 4 > len(c.data):
            raise Tok3Error("token stream ends early")
        c.pos += 4
        return struct.unpack_from("<I", c.data, c.pos - 4)[0]

    names = []       # bytes of each name
    toks = []        # per name: list of (type, ival, sval)
    out = bytearray()
    for cnum in range(nreads):
        t0 = byte(0)
        dist = u32(t0)
        if dist > cnum:
            raise Tok3Error("reference before the first name")
        pnum = cnum - dist
        if t0 == T_DUP:
            if pnum == cnum:
                raise Tok3Error("duplicate of itself")
            names.append(names[pnum])
            toks.append(toks[pnum])
            out += names[pnum] + b"\0"
            continue
        prev = toks[pnum] if pnum < cnum else []
        name = bytearray()
        mine = [(0, 0, 0)]
        for ntok in range(1, min(MAX_TOKENS, max_tok)):
            k = ntok << 4
            c = cur.get(k)
            tok = -1                 # an exhausted type stream ends a name
            if c is not None and c.pos < len(c.data):
                tok = c.data[c.pos]
                c.pos += 1
            pk = prev[ntok] if ntok < len(prev) else None
            if tok == T_CHAR:
                c = byte(k | T_CHAR)
                name.append(c)
                mine.append((T_CHAR, c, 0))
            elif tok == T_ALPHA:
                c = cur.get(k | T_ALPHA)
                if c is None:
                    raise Tok3Error("no alpha stream")
                end = c.data.find(b"\0", c.pos)
                if end < 0:
                    raise Tok3Error("unterminated alpha token")
                s = c.data[c.pos:end]
                c.pos = end + 1
                mine.append((T_ALPHA, len(s), len(name)))
                name += s
            elif tok == T_DIGITS0:
                n = byte(k | T_DZLEN)
                v = u32(k | T_DIGITS0)
                name += _fixed(v, n)
                mine.append((T_DIGITS0, v, n))
            elif tok == T_DDELTA0:
                if pk is None:
                    raise Tok3Error("delta on a missing token")
                v = (byte(k | T_DDELTA0) + pk[1]) & 0xFFFFFFFF
                name += _fixed(v, pk[2])
                mine.append((T_DIGITS0, v, pk[2]))
            elif tok == T_DIGITS:
                v = u32(k | T_DIGITS)
                name += _var(v)
                mine.append((T_DIGITS, v, 0))
            elif tok == T_DDELTA:
                if pk is None:
                    raise Tok3Error("delta on a missing token")
                v = (byte(k | T_DDELTA) + pk[1]) & 0xFFFFFFFF
                name += _var(v)
                mine.append((T_DIGITS, v, 0))
            elif tok == T_NOP:
                mine.append((T_NOP, 0, 0))
            elif tok == T_MATCH:
                if pk is None:
                    raise Tok3Error("match on a missing token")
                typ, iv, sv = pk
                if typ == T_CHAR:
                    name.append(iv)
                    mine.append(pk)
                elif typ == T_ALPHA:
                    mine.append((T_ALPHA, iv, len(name)))
                    name += names[pnum][sv:sv + iv]
                elif typ == T_DIGITS:
                    name += _var(iv)
                    mine.append(pk)
                elif typ == T_DIGITS0:
                    name += _fixed(iv, sv)
                    mine.append(pk)
                else:
                    raise Tok3Error("match on a token of no value")
            else:                               # END, or past the types
                mine.append((T_END, 0, 0))
                break
        else:
            raise Tok3Error("name without an end")
        names.append(bytes(name))
        toks.append(mine)
        out += name + b"\0"
    if len(out) != ulen:
        raise Tok3Error("names differ in size from the header")
    return bytes(out)
