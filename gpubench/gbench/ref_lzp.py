"""Plain check of an LZP stream against the bytes it must decode to.

LZP (lzp16e's format, as fqzcomp5 uses it before rANS on names and,
at some presets, on bases): at output position j a 16-bit hash of the
bytes before j names the last earlier position with the same hash.  If
that position is above 0, the next input byte is a flag: 233 with a
1-byte length, or 234 with a 2-byte one, copies that many bytes from it
(forward, overlapping); a length of 0 escapes a literal 233/234; any
other byte is a literal.  With no such position every byte is a literal.

The hash after a byte is ``(u * 0x8ca6b53 << 4) + (u << 5) * 17 ^ c``,
cut to 16 bits.  Both products carry a factor 16, so each byte is pushed
4 bits up: the hash at j depends on the 4 bytes before j alone.  Given
the expected output, every position's hash and predicted position can
be computed at once, and the walk only stops at flag bytes: ``expand``
decodes the stream on the assumption that its output so far is
``expect``'s prefix, which holds by induction while every byte it
produces matches.  So it is a decoder that follows the expected output,
and fails at the first byte that differs.
"""

from __future__ import annotations

import numpy as np

ESC = 233


class LzpMismatch(ValueError):
    """The stream does not decode to the expected bytes."""


def _next_hash(u, c):
    return (((u * 0x8CA6B53) << 4) + ((u << 5) * 17) ^ c) & 0xFFFF


def predictions(expect: np.ndarray) -> np.ndarray:
    """Per output position, the predicted earlier position (-1: none)."""
    n = len(expect)
    c = expect.astype(np.int64)
    h = np.zeros(n, np.int64)        # hash before position j
    u = 0
    for j in range(1, min(4, n)):
        u = _next_hash(u, int(c[j - 1]))
        h[j] = u
    if n > 4:
        u = np.zeros(n - 4, np.int64)
        for k in range(4):
            u = _next_hash(u, c[k:n - 4 + k])
        h[4:] = u
    order = np.argsort(h.astype(np.uint16), kind="stable")
    hs = h[order]
    pred = np.full(n, -1, np.int64)
    same = np.flatnonzero(hs[1:] == hs[:-1]) + 1
    pred[order[same]] = order[same - 1]
    return pred


def expand(stream: bytes, expect: bytes) -> bytes:
    """expect, if stream decodes to it; raises LzpMismatch otherwise."""
    n = len(expect)
    P = np.frombuffer(expect, np.uint8)
    pred = predictions(P)
    inp = np.frombuffer(stream, np.uint8)
    flags = np.flatnonzero((inp == ESC) | (inp == ESC + 1))
    i = j = k = 0
    m = len(inp)
    while j < n:
        while k < len(flags) and flags[k] < i:
            k += 1
        e = int(flags[k]) if k < len(flags) else m
        run = min(e - i, n - j)
        if stream[i:i + run] != expect[j:j + run]:
            raise LzpMismatch(f"literal differs near output byte {j}")
        i += run
        j += run
        if j >= n:
            break
        if i >= m:
            raise LzpMismatch("stream ends before its output")
        p = int(pred[j])
        if p <= 0:                      # no prediction: a raw literal
            if inp[i] != P[j]:
                raise LzpMismatch(f"literal differs at output byte {j}")
            i += 1
            j += 1
            continue
        if inp[i] == ESC:
            ml = int(inp[i + 1]) if i + 1 < m else -1
            i += 2
        else:
            ml = (int(inp[i + 1]) << 8 | int(inp[i + 2])) if i + 2 < m else -1
            i += 3
        if ml < 0:
            raise LzpMismatch("truncated match")
        if ml == 0:                     # escaped literal
            if i >= m or inp[i] != P[j]:
                raise LzpMismatch(f"escaped literal differs at byte {j}")
            i += 1
            j += 1
            continue
        if j + ml > n or expect[j:j + ml] != expect[p:p + ml]:
            raise LzpMismatch(f"match differs at output byte {j}")
        j += ml
    if i != m:
        raise LzpMismatch("stream longer than its output")
    return expect
