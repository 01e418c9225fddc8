"""Plain reader of an FQZ5 archive, held against the reads it must hold.

The container (fqzcomp5 1.1): an 8-byte magic, the index's offset as a
u64, the blocks, then the index (``FQZ5IDX\\0``, a u32 count, and per
block its offset u64, bases u32 and records u32).  A block: its size
u32 (of what follows), records u32, CRC32 u32 of the rest; names [ulen
u32][strategy u8][clen u32][payload]; lengths [n u8][varint] for a fixed
length, or [0][size u32][varints], one a record, each held against its
record's own length; bases and qualities each [strategy
u8][ulen u32][clen u32][payload].  Qualities are stored as Phred values
(ASCII - 33).  All integers are little-endian.

``check`` reads every block with the plain decoders of this package and
compares each section with the one the input's reads give; all rANS
streams of the archive walk together (``ref_rans.decode_cores``).
Section strategies: names 0 (LZP, then rANS), 1 and 2 (tok3); bases 0
(rANS), 10 (LZP, then rANS), and the SEQ context model (strategy & 7 ==
1); qualities 0 (rANS) or the FQZ model.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from gbench import ref_fqz, ref_lzp, ref_rans, ref_seq, ref_tok3

MAGIC = b"FQZ5\x01\x01\x00\x00"
INDEX_MAGIC = b"FQZ5IDX\x00"
LZP3 = 10


class Reads:
    """The reads a file holds: names (without '@'), bases and qualities
    (ASCII) as (n, width) uint8 planes, and lens, each read's length (all
    the width by default): read k is the first lens[k] bytes of its
    rows."""

    def __init__(self, names: list[bytes], seq: np.ndarray, qual: np.ndarray,
                 lens: np.ndarray | None = None):
        self.names = names
        self.seq = seq
        self.qual = qual
        self.lens = (np.full(len(names), seq.shape[1], np.int64)
                     if lens is None else np.asarray(lens, np.int64))

    def __len__(self) -> int:
        return len(self.names)

    def sections(self, r0: int, n: int) -> dict:
        """The sections of the block of records [r0, r0 + n), each read
        cut to its length."""
        keep = np.arange(self.seq.shape[1]) < self.lens[r0:r0 + n, None]
        return {"names": b"\0".join(self.names[r0:r0 + n]) + b"\0",
                "seq": self.seq[r0:r0 + n][keep].tobytes(),
                "qual": (self.qual[r0:r0 + n][keep] - 33).tobytes()}


class Report:
    """What ``check`` found: blocks and records read, blocks that failed
    (any difference or format error), and the first failure."""

    def __init__(self):
        self.blocks = 0
        self.records = 0
        self.bad_blocks = 0
        self.first_error = ""
        self.kinds = set()        # how the blocks read store bases, quals

    def fail(self, what: str) -> None:
        self.bad_blocks += 1
        if not self.first_error:
            self.first_error = what


class _Block:
    pass


def _u32(buf, off):
    return struct.unpack_from("<I", buf, off)[0], off + 4


def _layout(raw: bytes) -> _Block:
    """A block's fields and sections, unchecked but for its CRC."""
    b = _Block()
    b.nrec, off = _u32(raw, 4)
    crc, off = _u32(raw, off)
    if zlib.crc32(raw[12:]) & 0xFFFFFFFF != crc:
        raise ref_rans.FormatError("block CRC differs")
    b.name_len, off = _u32(raw, off)
    b.name_strat = raw[off]
    clen, off = _u32(raw, off + 1)
    b.name_pay = raw[off:off + clen]
    off += clen
    lstrat = b.len_strat = raw[off]
    off += 1
    if lstrat:
        L, off2 = ref_rans.get_uv(raw, off)
        if off2 - off != lstrat:
            raise ref_rans.FormatError("length varint size")
        off = off2
        b.lens = np.full(b.nrec, L, np.int64)
    else:
        blen, off = _u32(raw, off)
        lens, p = [], off
        for _ in range(b.nrec):
            v, p = ref_rans.get_uv(raw, p)
            lens.append(v)
        b.lens = np.array(lens, np.int64)
        off += blen
    for sec in ("seq", "qual"):
        strat = raw[off]
        ulen, clen = struct.unpack_from("<II", raw, off + 1)
        off += 9
        setattr(b, sec, (strat, ulen, raw[off:off + clen]))
        off += clen
    if off != len(raw):
        raise ref_rans.FormatError("block size differs from its sections")
    return b


def _parse_block(raw: bytes, r0: int, reads: Reads) -> _Block:
    b = _layout(raw)
    if r0 + b.nrec > len(reads):
        raise ref_rans.FormatError("more records than the input holds")
    b.expect = reads.sections(r0, b.nrec)
    want = reads.lens[r0:r0 + b.nrec]
    bad = np.flatnonzero(b.lens != want)
    if len(bad):
        k = bad[0]
        raise ref_rans.FormatError(f"read {r0 + k}'s length is {b.lens[k]}, "
                                   f"not {want[k]}")
    return b


def _kinds(b: _Block) -> set[str]:
    """How the block stores its bases and qualities."""
    strat = b.seq[0]
    seq = "SEQ" if strat & 7 == 1 and strat != LZP3 else "rANS"
    return {seq, "rANS" if b.qual[0] == 0 else "FQZ"}


def _plan(b: _Block) -> None:
    """Parse the block's rANS payloads (b.nodes: part -> node); the
    context-model payloads are decoded in _sections."""
    b.nodes = {}
    if b.name_strat == 0:
        b.nodes["names"] = ref_rans.parse(b.name_pay)
    elif b.name_strat == 2:
        clen1, clenf = struct.unpack_from("<II", b.name_pay, 0)
        rest = len(b.name_pay) - 8 - clen1 - clenf
        if rest < 0:
            raise ref_rans.FormatError("names parts longer than the section")
        b.nodes["name_flags"] = ref_rans.parse(
            b.name_pay[8 + clen1:8 + clen1 + clenf])
        if rest:
            b.nodes["name_comments"] = ref_rans.parse(
                b.name_pay[8 + clen1 + clenf:])
    elif b.name_strat != 1:
        raise ref_rans.FormatError(f"names strategy {b.name_strat}")
    strat, ulen, pay = b.seq
    if strat in (0, LZP3):
        b.nodes["seq"] = ref_rans.parse(pay)
    elif strat & 7 != 1:
        raise ref_rans.FormatError(f"bases strategy {strat}")
    strat, ulen, pay = b.qual
    if strat == 0:
        b.nodes["qual"] = ref_rans.parse(pay)


def _split(names: bytes) -> tuple[bytes, bytes]:
    """(ids, comments) of a NUL-ended name block, as names strategy 2
    stores them: a name's first word (less a /1 or /2 ending) and what
    follows its first space or tab, each NUL-ended; no comments at all
    where no name has a space or tab."""
    recs = names.split(b"\0")[:-1]
    has_com = any(b" " in r or b"\t" in r for r in recs)
    ids, coms = [], []
    for r in recs:
        cut = min((k for k in (r.find(b" "), r.find(b"\t")) if k >= 0),
                  default=len(r))
        w1, w2 = r[:cut], r[cut + 1:] if cut < len(r) else b""
        if len(w1) > 1 and w1[-2:] in (b"/1", b"/2"):
            w1 = w1[:-2]
        ids.append(w1)
        coms.append(w2)
    return (b"".join(i + b"\0" for i in ids),
            b"".join(c + b"\0" for c in coms) if has_com else b"")


def _join(ids: bytes, flags: bytes, comments: bytes) -> bytes:
    out = bytearray()
    coms = comments.split(b"\0") if comments else []
    for r, i in enumerate(ids.split(b"\0")[:-1]):
        f = flags[r] if r < len(flags) else 0
        out += i
        if f & 1:
            out += b"/2" if f & 2 else b"/1"
        if f & 4:
            out += b"\t" if f & 8 else b" "
        if r < len(coms):
            out += coms[r]
        out += b"\0"
    return bytes(out)


def _names(b: _Block) -> bytes:
    if b.name_strat == 0:
        return ref_lzp.expand(ref_rans.finish(b.nodes["names"]),
                              b.expect["names"])
    if b.name_strat == 1:
        return ref_tok3.decode(b.name_pay)
    clen1 = struct.unpack_from("<I", b.name_pay, 0)[0]
    ids = ref_tok3.decode(b.name_pay[8:8 + clen1])
    flags = ref_rans.finish(b.nodes["name_flags"])
    comments = b""
    if "name_comments" in b.nodes:
        comments = ref_lzp.expand(ref_rans.finish(b.nodes["name_comments"]),
                                  _split(b.expect["names"])[1])
    return _join(ids, flags, comments)


def _sections(b: _Block) -> dict:
    """The block's decoded sections (its rANS cores walked)."""
    out = {"names": _names(b)}
    if len(out["names"]) != b.name_len:
        raise ref_rans.FormatError("names length differs from its header")
    strat, ulen, pay = b.seq
    if strat & 7 == 1 and strat != LZP3:
        seq = ref_seq.decode(pay, b.lens, (strat >> 3) & 1, strat >> 4, ulen)
    else:
        seq = ref_rans.finish(b.nodes["seq"])
        if strat == LZP3:
            seq = ref_lzp.expand(seq, b.expect["seq"])
    out["seq"] = seq
    strat, ulen, pay = b.qual
    out["qual"] = (ref_rans.finish(b.nodes["qual"]) if strat == 0
                   else ref_fqz.decode(pay, ulen, seq))
    for sec, (_, ulen, _) in (("seq", b.seq), ("qual", b.qual)):
        if len(out[sec]) != ulen:
            raise ref_rans.FormatError(f"{sec} length differs from header")
    return out


def card_streams(archive: bytes) -> dict[int, tuple[int, int]]:
    """Per rANS order, (symbols, compressed bytes) of the 32-lane streams
    of the archive's base and quality sections, whole or as STRIPE parts:
    the streams the port walks on the card.  A stream's compressed bytes
    are its 32 states and its words, what a walk reads (the tables are
    built on the host)."""
    out = {0: [0, 0], 1: [0, 0]}

    def add(node):
        if node.kind == "stripe":
            for part in node.parts:
                add(part)
        elif node.kind == "plain" and node.core.n == 32:
            c = node.core
            out[c.order][0] += c.out_len
            out[c.order][1] += 4 * c.n + 2 * len(c.words)
    index_off = struct.unpack_from("<Q", archive, 8)[0]
    off = 16
    while off < index_off:
        size = struct.unpack_from("<I", archive, off)[0]
        b = _layout(archive[off:off + 4 + size])
        off += 4 + size
        for strat, _, pay in (b.seq, b.qual):
            if strat == 0:
                add(ref_rans.parse(pay))
    return {k: tuple(v) for k, v in out.items()}


def check(archive: bytes, reads: Reads) -> Report:
    """Read the archive with the plain decoders and compare every block's
    sections with the reads; the report counts the blocks that fail."""
    rep = Report()
    if archive[:8] != MAGIC:
        rep.fail("not an FQZ5 1.1 archive")
        return rep
    index_off = struct.unpack_from("<Q", archive, 8)[0]
    off = 16
    blocks, offsets = [], []
    r0 = 0
    while off < index_off:
        size, _ = _u32(archive, off)
        raw = archive[off:off + 4 + size]
        offsets.append(off)
        off += 4 + size
        try:
            b = _parse_block(raw, r0, reads)
            _plan(b)
        except Exception as e:     # any failure to read is a failed block
            rep.fail(f"block {len(offsets) - 1}: {e}")
            b = None
        if b is not None:
            r0 += b.nrec
            blocks.append((len(offsets) - 1, b))
        else:
            # a block that cannot be read leaves the record count unknown
            return _finish_index(rep, archive, index_off, offsets, None,
                                 len(reads))
    cores = [c for _, b in blocks for node in b.nodes.values()
             for c in ref_rans.cores_of(node)]
    try:
        ref_rans.decode_cores(cores)
    except Exception as e:         # any failure to read is a failed block
        rep.fail(f"rANS walk: {e}")
        return rep
    for k, b in blocks:
        try:
            got = _sections(b)
        except Exception as e:     # any failure to read is a failed block
            rep.fail(f"block {k}: {e}")
            continue
        for sec in ("names", "seq", "qual"):
            if got[sec] != b.expect[sec]:
                rep.fail(f"block {k}: {sec} differ")
                break
        rep.blocks += 1
        rep.records += b.nrec
        rep.kinds |= _kinds(b)
    return _finish_index(rep, archive, index_off, offsets,
                         [b for _, b in blocks], len(reads))


def _finish_index(rep: Report, archive: bytes, index_off: int,
                  offsets: list[int], blocks, nreads: int) -> Report:
    """Hold the index against the blocks, and the records against the
    input's count."""
    if archive[index_off:index_off + 8] != INDEX_MAGIC:
        rep.fail("index missing")
        return rep
    n = struct.unpack_from("<I", archive, index_off + 8)[0]
    if index_off + 12 + 16 * n != len(archive):
        rep.fail("index size differs from the archive's end")
    if n != len(offsets):
        rep.fail("index counts other blocks")
        return rep
    if blocks is None:
        return rep
    for k, b in enumerate(blocks):
        o, us, nr = struct.unpack_from("<QII", archive, index_off + 12 + 16 * k)
        if (o, us, nr) != (offsets[k], b.seq[1], b.nrec):
            rep.fail(f"index entry {k} differs from its block")
    if sum(b.nrec for b in blocks) != nreads:
        rep.fail(f"archive holds {sum(b.nrec for b in blocks)} of "
                 f"{nreads} records")
    return rep
