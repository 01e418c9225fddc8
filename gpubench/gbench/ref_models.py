"""Plain range decoder and adaptive models of the SEQ and FQZ codecs.

The coder is the 32-bit carry-counting range coder of htscodecs'
c_range_coder.h: five bytes start the code, ``get_freq`` divides the
range by the total, ``decode`` takes out the symbol's interval and
renormalises a byte at a time while the range is below 2^24.

``Adaptive`` is c_simple_model.h's model: 16-bit frequencies in a list
kept roughly sorted by one bubble step after each update, STEP added to
the coded symbol, all halved (rounding up) once the total passes
2^16 - 17.  ``Tiny`` is c_small_model.h's: 8-bit frequencies indexed by
symbol, STEP 1, halved once the total reaches 255.
"""

from __future__ import annotations

TOP = 1 << 24
M32 = 0xFFFFFFFF
MAX_FREQ = (1 << 16) - 17


class CodeError(ValueError):
    """The coded stream is broken."""


class RangeDecoder:
    def __init__(self, buf: bytes, off: int = 0):
        if off + 5 > len(buf):
            raise CodeError("range-coded stream shorter than 5 bytes")
        self.buf = buf
        self.pos = off + 5
        self.code = int.from_bytes(buf[off:off + 5], "big") & M32
        self.range = M32

    def get_freq(self, tot: int) -> int:
        if not tot or self.range < tot:
            raise CodeError("range below the total")
        self.range //= tot
        return self.code // self.range

    def decode(self, cum: int, freq: int) -> None:
        self.code = (self.code - cum * self.range) & M32
        self.range *= freq
        while self.range < TOP:
            if self.pos >= len(self.buf):
                raise CodeError("range-coded stream ends early")
            self.code = ((self.code << 8) | self.buf[self.pos]) & M32
            self.pos += 1
            self.range <<= 8


class Adaptive:
    """An adaptive model of max_sym symbols (0 .. max_sym - 1)."""

    def __init__(self, max_sym: int, step: int = 16):
        self.syms = list(range(max_sym))
        self.freqs = [1] * max_sym
        self.tot = max_sym
        self.step = step

    def decode(self, rc: RangeDecoder) -> int:
        f = rc.get_freq(self.tot)
        if f > MAX_FREQ:
            raise CodeError("frequency past the model's limit")
        freqs = self.freqs
        acc = 0
        i = 0
        n = len(freqs)
        while True:
            if i >= n:
                raise CodeError("frequency past the model's total")
            acc += freqs[i]
            if acc > f:
                break
            i += 1
        fi = freqs[i]
        rc.decode(acc - fi, fi)
        return self._bump(i)

    def _bump(self, i: int) -> int:
        freqs, syms = self.freqs, self.syms
        freqs[i] += self.step
        self.tot += self.step
        if self.tot > MAX_FREQ:
            tot = 0
            for k in range(len(freqs)):
                freqs[k] -= freqs[k] >> 1
                tot += freqs[k]
            self.tot = tot
        s = syms[i]
        if i and freqs[i] > freqs[i - 1]:
            freqs[i], freqs[i - 1] = freqs[i - 1], freqs[i]
            syms[i], syms[i - 1] = syms[i - 1], syms[i]
        return s


class Tiny:
    """A tiny model of n symbols with 8-bit frequencies."""

    def __init__(self, n: int):
        self.freqs = [1] * n

    def decode(self, rc: RangeDecoder) -> int:
        freqs = self.freqs
        tot = sum(freqs)
        f = rc.get_freq(tot)
        if f >= tot:
            raise CodeError("frequency past the model's total")
        s = 0
        acc = freqs[0]
        while acc <= f:
            s += 1
            acc += freqs[s]
        rc.decode(acc - freqs[s], freqs[s])
        self.update(s, tot)
        return s

    def update(self, s: int, tot: int | None = None) -> None:
        freqs = self.freqs
        if tot is None:
            tot = sum(freqs)
        freqs[s] += 1
        if tot >= 255:
            for k in range(len(freqs)):
                freqs[k] -= freqs[k] >> 1
