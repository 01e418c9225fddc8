"""FQZ5 file-format constants and method/section enums.

Parity notes reference the upstream C implementation:
- magics/versions: fqzcomp5.c:154-161
- section enum:    fqzcomp5.c:176-182
- method enum:     fqzcomp5.c:185-208
- learning knobs:  fqzcomp5.c:150-152
"""

from __future__ import annotations

import enum

MAGIC_V11 = b"FQZ5\x01\x01\x00\x00"  # version 1.1 (current, per-block CRC)
MAGIC_V10 = b"FQZ5\x01\x00\x00\x00"  # version 1.0 (legacy, no CRC)
MAGIC_LEN = 8
INDEX_MAGIC = b"FQZ5IDX\x00"
TRAILER_MAGIC = b"FQZ5END\x00"

# File version codes as returned by read_header (fqzcomp5.c:2578-2604)
VERS_V11 = 0      # current, with CRC
VERS_V10 = 1      # legacy, no CRC
VERS_HEADERLESS = 2  # pre-1.0, no header at all

DEFAULT_BLOCK_SIZE = 512_000_000  # fqzcomp5.c:143 BLK_SIZE

# Method-learning state machine constants (fqzcomp5.c:150-152)
METRICS_REVIEW = 100
METRICS_TRIAL = 3

# Per-record flags (mirrors BAM; fqzcomp_qual.h:42-43)
FQZ_FREVERSE = 16
FQZ_FREAD2 = 128


class Section(enum.IntEnum):
    """Per-block data sections (fqzcomp5.c:176-182)."""

    NAME = 0
    LEN = 1
    SEQ = 2
    QUAL = 3


SEC_LAST = 4


class Method(enum.IntEnum):
    """Codec methods selectable per section (fqzcomp5.c:185-208).

    Numeric values are part of the learning state machine's bitmask
    vocabulary and of `-n/-s/-q` CLI semantics, so they must match the
    reference exactly.
    """

    RANS0 = 1
    RANS1 = 2
    RANS64 = 3
    RANS65 = 4
    RANS128 = 5
    RANS129 = 6
    RANS192 = 7
    RANS193 = 8
    RANSXN1 = 9

    LZP3 = 10
    TLZP3 = 11

    TOK3_3 = 12
    TOK3_5 = 13
    TOK3_7 = 14
    TOK3_9 = 15
    TOK3_3_LZP = 16
    TOK3_5_LZP = 17
    TOK3_7_LZP = 18
    TOK3_9_LZP = 19

    SEQ10 = 20
    SEQ12 = 21
    SEQ12B = 22
    SEQ13B = 23
    SEQ14B = 24
    SEQ_CUSTOM = 25

    FQZ0 = 26
    FQZ1 = 27
    FQZ2 = 28
    FQZ3 = 29
    FQZ4 = 30


M_LAST = 31

# rANS order byte flags (rANS_static4x16.h:66-103). Stored in the file.
RANS_ORDER_PACK = 0x80
RANS_ORDER_RLE = 0x40
RANS_ORDER_CAT = 0x20
RANS_ORDER_NOSZ = 0x10
RANS_ORDER_STRIPE = 0x08
RANS_ORDER_X32 = 0x04
# Encoder-only control bits (not stored)
RANS_ORDER_STRIPE_NO0 = 1 << 16
RANS_ORDER_SIMD_AUTO = 1 << 17


def bit(m: Method) -> int:
    return 1 << int(m)


# Default method bitmask used by drivers when nothing explicit is set
# (fqzcomp5.c:2743 rans_methods).
RANS_METHODS = (
    bit(Method.RANS0) | bit(Method.RANS1) | bit(Method.RANS129) | bit(Method.RANS193)
)
