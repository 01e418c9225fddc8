"""FASTQ/FASTA records as struct-of-arrays batches, plus parse/format.

The `FastqBatch` mirrors the reference `fastq` SoA (fqzcomp5.c:235-249):
concatenated NUL-separated names, concatenated sequence bytes,
concatenated quality bytes already rebased to q-33, per-record lengths
and READ1/READ2 flags. This layout is the batching boundary for all
device codecs.

The parser replicates kseq.h tokenization (kseq.h:177-218) and the
block-packing rule of load_seqs_kseq (fqzcomp5.c:423-623): a record's
accounted size is ``len(name_without_comment) + 1 + len(seq) +
len(qual)`` and a block closes when the next record would exceed
``blk_size`` (the first record is always accepted).
"""

from __future__ import annotations

from fqzcomp5_tpu_torch.utils import lightclass as dataclasses  # noqa: N813 — see lightclass.py
import gzip
import io
from array import array as _stdarray
# typing import dropped: costs ~12ms of CLI cold-start; all uses
# are string annotations (from __future__ import annotations)

from fqzcomp5_tpu_torch.utils.lazy_np import np

from fqzcomp5_tpu_torch.constants import FQZ_FREAD2


@dataclasses.dataclass
class FastqBatch:
    """One block's worth of records, struct-of-arrays."""

    name_buf: bytes = b""     # NUL separated (NUL after every name)
    seq_buf: bytes = b""      # concatenated, no separator
    qual_buf: bytes = b""     # concatenated, values are (ascii - 33)
    lens: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint32))
    flags: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint32))
    fixed_len: int = 0        # >0 if all records share one length
    is_fasta: bool = False

    @property
    def num_records(self) -> int:
        return int(len(self.lens))

    @property
    def name_offsets(self) -> np.ndarray:
        """Start offset of each name inside name_buf."""
        nb = np.frombuffer(self.name_buf, np.uint8)
        ends = np.flatnonzero(nb == 0)
        starts = np.empty_like(ends)
        starts[0] = 0
        starts[1:] = ends[:-1] + 1
        return starts

    def seq_offsets(self) -> np.ndarray:
        off = np.zeros(self.num_records, np.int64)
        np.cumsum(self.lens[:-1], out=off[1:])
        return off

    def names(self) -> list[bytes]:
        return self.name_buf.split(b"\x00")[:-1] if self.name_buf else []


def _compute_flags(names: list[bytes]) -> np.ndarray:
    """READ2 detection (fqzcomp5.c:518-527): name ends '/2', or equals
    the previous record's name."""
    n = len(names)
    flags = np.zeros(n, np.uint32)
    prev = None
    for i, nm in enumerate(names):
        if len(nm) > 1 and nm.endswith(b"/2"):
            flags[i] = FQZ_FREAD2
        elif prev is not None and nm == prev:
            flags[i] = FQZ_FREAD2
        prev = nm
    return flags


def _fixed_len(lens: np.ndarray) -> int:
    if lens.size == 0:
        return -1
    first = int(lens[0])
    return first if bool((lens == first).all()) else 0


@dataclasses.dataclass
class _Record:
    name: bytes        # includes " comment" when present
    name_core_len: int  # length of the name without comment (kseq name.l)
    seq: bytes
    qual: bytes        # raw ASCII (not rebased); empty for FASTA


class Parser:
    """Streaming FASTA/Q tokenizer over (possibly gzipped) byte streams.

    Parsing follows kseq.h: records start at '>' or '@'; the name stops
    at the first whitespace; the rest of the header line is the
    comment; sequence may span multiple lines until a line starting
    '>', '+' or '@'; for FASTQ, quality lines are read until their
    total length reaches the sequence length.

    Clean single-line 4-line FASTQ takes a vectorised numpy fast path
    (fastq_fast.py); anything unusual falls back to the generic
    record-at-a-time tokenizer.
    """

    _CHUNK = 16 << 20

    def __init__(self, fp):
        self._fp = fp
        self._buf = b""
        self._pos = 0
        self._eof = False
        self._pending: Optional[_Record] = None
        self._fast_ok = True       # until proven otherwise
        self._fast_seg = None      # current ParsedRecords
        self._fast_cursor = 0      # consumed records within it

    # -- low-level buffered reading -------------------------------------
    def _fill(self) -> bool:
        if self._eof:
            return False
        chunk = self._fp.read(1 << 20)
        if not chunk:
            self._eof = True
            return False
        self._buf = self._buf[self._pos:] + chunk
        self._pos = 0
        return True

    def _readline(self) -> Optional[bytes]:
        """Return next line without the newline; None at EOF."""
        while True:
            nl = self._buf.find(b"\n", self._pos)
            if nl >= 0:
                line = self._buf[self._pos:nl]
                self._pos = nl + 1
                if line.endswith(b"\r"):
                    line = line[:-1]
                return line
            if not self._fill():
                if self._pos < len(self._buf):
                    line = self._buf[self._pos:]
                    self._pos = len(self._buf)
                    if line.endswith(b"\r"):
                        line = line[:-1]
                    return line
                return None

    def _peek_byte(self) -> int:
        while self._pos >= len(self._buf):
            if not self._fill():
                return -1
        return self._buf[self._pos]

    # -- record-level parsing --------------------------------------------
    _WS = b" \t\x0b\x0c\r"

    def read_record(self) -> Optional[_Record]:
        # Seek next header
        while True:
            c = self._peek_byte()
            if c < 0:
                return None
            if c in (ord(">"), ord("@")):
                break
            self._readline()  # skip junk line (kseq skips any non-header)
        header = self._readline()
        assert header is not None
        header = header[1:]
        # split at first whitespace (kseq KS_SEP_SPACE uses isspace)
        core_len = len(header)
        sep = -1
        for i, b in enumerate(header):
            if b == 32 or 9 <= b <= 13:
                sep = i
                break
        if sep >= 0:
            core_len = sep
            name = header[:sep] + b" " + header[sep + 1:]
            # reference stores name + ' ' + comment (fqzcomp5.c:505-515)
        else:
            name = header
        # sequence lines
        seq_parts = []
        is_fastq = False
        while True:
            c = self._peek_byte()
            if c < 0:
                break
            if c in (ord(">"), ord("@")):
                break
            if c == ord("+"):
                is_fastq = True
                self._readline()  # discard '+' line
                break
            line = self._readline()
            if line:
                seq_parts.append(line)
        seq = b"".join(seq_parts)
        qual = b""
        if is_fastq:
            qparts = []
            qlen = 0
            while qlen < len(seq):
                line = self._readline()
                if line is None:
                    break
                qparts.append(line)
                qlen += len(line)
            qual = b"".join(qparts)
            if len(qual) != len(seq):
                raise ValueError("sequence and quality length mismatch")
        return _Record(name, core_len, seq, qual)

    # -- fast path ---------------------------------------------------------
    def _fast_fill(self) -> bool:
        """Refill self._fast_seg from buffered bytes; False when the
        fast path can't continue (EOF of clean data or odd input)."""
        from fqzcomp5_tpu_torch import fastq_fast

        while True:
            if not self._eof and len(self._buf) - self._pos < self._CHUNK:
                # readinto a NEW bytearray with the carry at its head:
                # one kernel copy instead of read()'s fresh-bytes
                # alloc + a full-chunk concat (~0.08s per 200MB at -1,
                # round 5).  A NEW buffer per refill is load-bearing:
                # earlier segments hold views into the old one until
                # their build_batch runs.
                carry = len(self._buf) - self._pos
                ba = bytearray(carry + self._CHUNK)
                if carry:
                    ba[:carry] = memoryview(self._buf)[self._pos:]
                try:
                    n = self._fp.readinto(memoryview(ba)[carry:])
                except (AttributeError, TypeError):
                    chunk = self._fp.read(self._CHUNK)
                    n = len(chunk)
                    ba[carry:carry + n] = chunk
                if n:
                    del ba[carry + n:]
                    self._buf = ba
                    self._pos = 0
                else:
                    self._eof = True
            avail_len = len(self._buf) - self._pos
            if avail_len == 0:
                return False
            # Numpy-free native path first (the encode CLI's hot path);
            # the vectorised numpy parse remains the fallback.
            if self._eof and not self._buf.endswith(b"\n"):
                # clean tail without trailing newline: virtually add one
                pbuf, poff = self._buf[self._pos:] + b"\n", 0
            else:
                pbuf, poff = self._buf, self._pos
            r = fastq_fast.parse_chunk_raw(pbuf, poff, len(pbuf) - poff)
            if r is None:
                data = np.frombuffer(pbuf, np.uint8)[poff:]
                r = fastq_fast.parse_chunk(data)
            if r is None:
                self._fast_ok = False
                # generic parser produces record fields by
                # slicing _buf; keep them hashable bytes
                self._buf = bytes(self._buf)
                return False
            recs, tail = r
            if recs.n == 0:
                if self._eof:
                    # trailing partial record: generic path handles it
                    self._fast_ok = False
                    self._buf = bytes(self._buf)
                    return False
                continue  # need more bytes for even one record
            self._fast_seg = recs
            self._fast_cursor = 0
            if tail >= avail_len:
                self._pos = len(self._buf)
            else:
                self._pos += tail
            return True

    def _next_fast_records(self, budget: int, force_one: bool):
        """Take records from the fast segment within the size budget.

        force_one: accept the first record even when oversized (the
        reference always takes at least one record per block).
        Returns (ParsedRecords slice or None, remaining_budget)."""
        if self._fast_seg is None or self._fast_cursor >= self._fast_seg.n:
            if not self._fast_fill():
                return None, budget
        seg = self._fast_seg
        cur = self._fast_cursor
        if isinstance(seg.core_len, _stdarray):
            # native segment: C scan, no numpy import on this path
            from fqzcomp5_tpu_torch.codecs import native

            k, total = native.pack_cut(seg.core_len, seg.seq_s,
                                       seg.seq_e, cur, budget,
                                       1 if force_one else 0)
            if k == 0:
                return None, budget
        else:
            acc = np.cumsum(seg.acc_size[cur:])
            k = int(np.searchsorted(acc, budget, side="right"))
            if k == 0:
                if not force_one:
                    return None, budget
                k = 1
            total = int(acc[k - 1])
        taken = seg.slice(cur, cur + k)
        self._fast_cursor = cur + k
        return taken, budget - total

    # -- block packing -----------------------------------------------------
    def next_batch(self, blk_size: int) -> Optional[FastqBatch]:
        """Read one block of records, or None at EOF.

        Uses the reference accounting rule (fqzcomp5.c:470-478).
        """
        from fqzcomp5_tpu_torch import fastq_fast

        if self._fast_ok and self._pending is None:
            segs = []
            budget = blk_size
            while True:
                taken, budget = self._next_fast_records(
                    budget, force_one=not segs)
                if taken is None:
                    break
                segs.append(taken)
                if budget <= 0:
                    break
            if segs:
                return _merge_batches(
                    [fastq_fast.build_batch(s) for s in segs])
            # no clean records: EOF, or unusual input -> generic path
            if self._eof and self._pos >= len(self._buf):
                return None
            self._fast_ok = False
            self._buf = bytes(self._buf)

        names: list[bytes] = []
        seqs: list[bytes] = []
        quals: list[bytes] = []
        total = 0
        while True:
            rec = self._pending
            self._pending = None
            if rec is None:
                rec = self.read_record()
            if rec is None:
                break
            rsize = rec.name_core_len + 1 + len(rec.seq) + len(rec.qual)
            if total > 0 and total + rsize > blk_size:
                self._pending = rec
                break
            total += rsize
            names.append(rec.name)
            seqs.append(rec.seq)
            quals.append(rec.qual)
        if not names:
            return None
        lens = np.array([len(s) for s in seqs], np.uint32)
        qual_buf = b"".join(quals)
        batch = FastqBatch(
            name_buf=b"\x00".join(names) + b"\x00",
            seq_buf=b"".join(seqs),
            qual_buf=(np.frombuffer(qual_buf, np.uint8) - 33).tobytes(),
            lens=lens,
            flags=_compute_flags(names),
            fixed_len=max(_fixed_len(lens), 0),
            is_fasta=not quals[0],
        )
        return batch


def _merge_batches_arr(parts: list[FastqBatch],
                       dup_rule: bool) -> FastqBatch:
    """Numpy-free merge for native-path batches (array('I') fields)."""
    flags = [_stdarray("I", p.flags) for p in parts]
    for i in range(1, len(parts) if dup_rule else 0):
        pb = parts[i - 1].name_buf
        cb = parts[i].name_buf
        if not pb or not cb or flags[i][0]:
            continue
        last_start = pb.rfind(b"\x00", 0, len(pb) - 1) + 1
        first_end = cb.find(b"\x00")
        if first_end < 0:
            first_end = len(cb)
        if pb[last_start:len(pb) - 1] == cb[:first_end]:
            flags[i][0] = FQZ_FREAD2
    lens = _stdarray("I")
    for p in parts:
        lens.frombytes(bytes(memoryview(p.lens)))
    fl = _stdarray("I")
    for f in flags:
        fl.frombytes(bytes(memoryview(f)))
    n = len(lens)
    first = int(lens[0]) if n else 0
    return FastqBatch(
        name_buf=b"".join(p.name_buf for p in parts),
        seq_buf=b"".join(p.seq_buf for p in parts),
        qual_buf=b"".join(p.qual_buf for p in parts),
        lens=lens,
        flags=fl,
        fixed_len=first if n and lens.count(first) == n else 0,
        is_fasta=parts[0].is_fasta,
    )


def _merge_batches(parts: list[FastqBatch],
                   dup_rule: bool = True) -> FastqBatch:
    if len(parts) == 1:
        return parts[0]
    if all(isinstance(p.lens, _stdarray) for p in parts):
        return _merge_batches_arr(parts, dup_rule)
    flags = [np.array(p.flags, np.uint32) for p in parts]
    # boundary duplicate-name rule: first record of each part vs the
    # previous part's final name (not applicable to interleaved parts,
    # whose flags are positional)
    for i in range(1, len(parts) if dup_rule else 0):
        # only the previous part's LAST name and this part's FIRST
        # name matter: scan the NUL framing directly instead of
        # splitting whole multi-MB name buffers
        pb = parts[i - 1].name_buf
        cb = parts[i].name_buf
        if not pb or not cb or flags[i][0]:
            continue
        last_start = pb.rfind(b"\x00", 0, len(pb) - 1) + 1
        first_end = cb.find(b"\x00")
        if first_end < 0:
            first_end = len(cb)
        if pb[last_start:len(pb) - 1] == cb[:first_end]:
            flags[i][0] = FQZ_FREAD2
    lens = np.concatenate([np.asarray(p.lens, np.uint32) for p in parts])
    first = int(lens[0]) if lens.size else 0
    return FastqBatch(
        name_buf=b"".join(p.name_buf for p in parts),
        seq_buf=b"".join(p.seq_buf for p in parts),
        qual_buf=b"".join(p.qual_buf for p in parts),
        lens=lens,
        flags=np.concatenate(flags),
        fixed_len=first if lens.size and bool((lens == first).all()) else 0,
        is_fasta=parts[0].is_fasta,
    )


def scan_blocks(path: str, blk_size: int):
    """Pre-scan block BYTE RANGES without building batches.

    The reference distributes parsed blocks from one reader
    (fqzcomp5.c:3050-3077); the multi-process analog is this scan: one
    cheap pass computes where each block's bytes live, so each process
    can seek and fully parse ONLY the blocks it owns (parse bytes per
    process ~ input/N instead of the replicated O(input) of round 2).

    Returns a list of (start, end, nrec, seq_bytes) tuples — block k's
    records occupy path[start:end] and re-parsing that slice yields
    exactly the batch the streaming Parser would produce — or None when
    the input is not clean single-line 4-line FASTQ (gzip, FASTA,
    multi-line records, truncated tail): callers fall back to the
    replicated-parse path.

    Block packing replicates next_batch exactly: records accumulate
    while ``acc_size`` fits the budget; the first record of a block is
    always accepted (fqzcomp5.c:470-478 accounting).
    """
    from fqzcomp5_tpu_torch import fastq_fast

    CHUNK = 32 << 20
    with open(path, "rb") as fp:
        head = fp.read(2)
        if head == b"\x1f\x8b":
            return None  # gzip: no random access; replicated path
        fp.seek(0)

        out: list[tuple[int, int, int, int]] = []
        base = 0          # absolute offset of buf[0]
        buf = b""
        eof = False
        budget = blk_size
        blk_start = 0     # absolute start of the open block
        blk_nrec = 0
        blk_seq = 0

        def close_block(end_abs: int):
            nonlocal budget, blk_nrec, blk_seq, blk_start
            out.append((blk_start, end_abs, blk_nrec, blk_seq))
            blk_start = end_abs
            budget = blk_size
            blk_nrec = 0
            blk_seq = 0

        while True:
            if not eof and len(buf) < CHUNK:
                chunk = fp.read(CHUNK)
                if chunk:
                    buf += chunk
                else:
                    eof = True
            if not buf:
                break
            pbuf = buf + b"\n" if eof and not buf.endswith(b"\n") else buf
            r = fastq_fast.parse_chunk_raw(pbuf, 0, len(pbuf))
            if r is None:
                r = fastq_fast.parse_chunk(np.frombuffer(pbuf, np.uint8))
            if r is None:
                return None
            recs, tail = r
            if recs.n == 0:
                if eof or len(buf) >= CHUNK:
                    return None  # partial/degenerate input
                continue
            if eof and tail < len(buf):
                return None  # unclean tail after the last record
            # absolute record starts ('@' byte) and per-record seq lens
            rstart = base + np.asarray(recs.name_s, np.int64) - 1
            slens = (np.asarray(recs.seq_e, np.int64)
                     - np.asarray(recs.seq_s, np.int64))
            acc = recs.acc_size
            cur = 0
            n = recs.n
            while cur < n:
                c = np.cumsum(acc[cur:])
                k = int(np.searchsorted(c, budget, side="right"))
                if k == 0:
                    if blk_nrec > 0:
                        close_block(int(rstart[cur]))
                        continue
                    k = 1  # oversized first record: always accepted
                blk_nrec += k
                blk_seq += int(slens[cur:cur + k].sum())
                budget -= int(c[k - 1])
                cur += k
                if budget <= 0:
                    end = (int(rstart[cur]) if cur < n
                           else base + tail)
                    close_block(end)
            buf = buf[tail:]
            base += tail
            if eof and not buf:
                break
        if blk_nrec > 0:
            close_block(base)
        return out


def parse_block_range(path: str, start: int, end: int) -> FastqBatch:
    """Parse one scanned block's byte range into a batch (identical to
    what the streaming Parser produced for that block)."""
    with open(path, "rb") as fp:
        fp.seek(start)
        blob = fp.read(end - start)
    batch = Parser(io.BytesIO(blob)).next_batch(1 << 62)
    assert batch is not None
    return batch


class InterleavedParser:
    """Paired-end reader: alternates R1/R2 records into one batch.

    Mirrors load_seqs_interleaved (fqzcomp5.c:627-865): a block closes
    only on pair boundaries, and R2 records get FQZ_FREAD2 regardless
    of their name.  Clean 4-line inputs use the vectorised fast path
    in both files simultaneously.
    """

    def __init__(self, fp1, fp2):
        self._p1 = Parser(fp1)
        self._p2 = Parser(fp2)
        self._pending: Optional[tuple[_Record, _Record]] = None
        self._fast_ok = True

    def _fast_next_batch(self, blk_size: int) -> Optional[FastqBatch]:
        from fqzcomp5_tpu_torch import fastq_fast

        parts: list[FastqBatch] = []
        budget = blk_size
        while True:
            p1, p2 = self._p1, self._p2
            for p in (p1, p2):
                if (p._fast_seg is None
                        or p._fast_cursor >= p._fast_seg.n):
                    if not p._fast_fill():
                        if not p._fast_ok:
                            # sub-parsers convert their own _buf
                            self._fast_ok = False
                        # EOF (or fallback): stop the fast loop
                        if p is p2 and p1._fast_seg is not None and \
                                p1._fast_cursor < p1._fast_seg.n and \
                                p._eof and self._fast_ok:
                            raise ValueError(
                                "unpaired read: R2 ended before R1")
                        return _merge_batches(parts, dup_rule=False) \
                            if parts else None
            a1 = p1._fast_seg.acc_size[p1._fast_cursor:]
            a2 = p2._fast_seg.acc_size[p2._fast_cursor:]
            m = min(len(a1), len(a2))
            pair_acc = np.cumsum(a1[:m] + a2[:m])
            k = int(np.searchsorted(pair_acc, budget, side="right"))
            if k == 0:
                if parts:
                    return _merge_batches(parts, dup_rule=False)
                k = 1  # always accept the first pair
            s1 = p1._fast_seg.slice(p1._fast_cursor, p1._fast_cursor + k)
            s2 = p2._fast_seg.slice(p2._fast_cursor, p2._fast_cursor + k)
            p1._fast_cursor += k
            p2._fast_cursor += k
            budget -= int(pair_acc[k - 1])
            parts.append(fastq_fast.interleave_batches(
                fastq_fast.build_batch(s1), fastq_fast.build_batch(s2)))
            if budget <= 0:
                return _merge_batches(parts, dup_rule=False)

    def next_batch(self, blk_size: int) -> Optional[FastqBatch]:
        if self._fast_ok and self._pending is None:
            out = self._fast_next_batch(blk_size)
            if out is not None:
                return out
            if self._fast_ok:
                return None  # clean EOF
            # else fall through to the generic pair loop
        names: list[bytes] = []
        seqs: list[bytes] = []
        quals: list[bytes] = []
        flags: list[int] = []
        total = 0
        while True:
            pair = self._pending
            self._pending = None
            if pair is None:
                r1 = self._p1.read_record()
                if r1 is None:
                    break
                r2 = self._p2.read_record()
                if r2 is None:
                    raise ValueError("unpaired read: R2 ended before R1")
                pair = (r1, r2)
            sz = sum(r.name_core_len + 1 + len(r.seq) + len(r.qual)
                     for r in pair)
            if total > 0 and total + sz > blk_size:
                self._pending = pair
                break
            total += sz
            for k, rec in enumerate(pair):
                names.append(rec.name)
                seqs.append(rec.seq)
                quals.append(rec.qual)
                flags.append(FQZ_FREAD2 if k == 1 else 0)
        if not names:
            return None
        lens = np.array([len(s) for s in seqs], np.uint32)
        qual_buf = b"".join(quals)
        return FastqBatch(
            name_buf=b"\x00".join(names) + b"\x00",
            seq_buf=b"".join(seqs),
            qual_buf=(np.frombuffer(qual_buf, np.uint8) - 33).tobytes(),
            lens=lens,
            flags=np.array(flags, np.uint32),
            fixed_len=max(_fixed_len(lens), 0),
            is_fasta=not quals[0],
        )


class GzExactWriter:
    """gzwrite-compatible .gz output stream.

    Python's gzip module stamps FNAME/mtime/XFL/OS fields, so its
    container bytes differ from the reference's zlib gzwrite output
    even though the deflate body is identical (level 6).  This writer
    emits the exact gzwrite framing — header 1f8b 08 00, mtime 0,
    XFL 0, OS 3 (unix), one level-6 raw-deflate stream, CRC32+ISIZE
    trailer — so .gz outputs byte-match the reference binary's
    (fqzcomp5.c output_fastq gzprintf path)."""

    def __init__(self, path: str):
        import zlib

        self._zlib = zlib
        self._fp = open(path, "wb")
        self._fp.write(b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\x03")
        self._co = zlib.compressobj(6, zlib.DEFLATED, -15)
        self._crc = 0
        self._size = 0

    def write(self, data) -> int:
        data = bytes(data)
        self._crc = self._zlib.crc32(data, self._crc)
        self._size += len(data)
        self._fp.write(self._co.compress(data))
        return len(data)

    def close(self) -> None:
        import struct

        self._fp.write(self._co.flush())
        self._fp.write(struct.pack(
            "<II", self._crc & 0xFFFFFFFF, self._size & 0xFFFFFFFF))
        self._fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_input(path: Optional[str]):
    """Open a FASTQ/FASTA input, transparently decoding gzip.

    The reference always routes input through zlib (fqzcomp5.c:5204),
    which passes plain data through; we sniff the gzip magic instead.
    """
    import sys

    if path is None:
        raw: io.BufferedReader = sys.stdin.buffer  # type: ignore[assignment]
        head = raw.peek(2)[:2] if hasattr(raw, "peek") else b""
        if head == b"\x1f\x8b":
            return gzip.open(raw)
        return raw
    fp = open(path, "rb")
    if fp.read(2) == b"\x1f\x8b":
        fp.seek(0)
        return gzip.open(fp)
    fp.seek(0)
    return fp


# ---------------------------------------------------------------------------
# Formatting (decode side). Vectorised with numpy: we build the output
# buffer by scattering name/seq/qual slices at precomputed offsets.
# Matches output_fastq / output_fasta (fqzcomp5.c:3441-3741).
# ---------------------------------------------------------------------------

def format_fastq(batch: FastqBatch, plus_name: bool = False) -> bytes:
    names = batch.names()
    lens = np.asarray(batch.lens, np.uint32).astype(np.int64)
    n = batch.num_records
    out = io.BytesIO()
    sq = np.frombuffer(batch.seq_buf, np.uint8)
    ql = np.frombuffer(batch.qual_buf, np.uint8) + 33
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    seq_mv = memoryview(sq)
    qual_bytes = ql.tobytes()
    qual_mv = memoryview(qual_bytes)
    w = out.write
    for i in range(n):
        w(b"@")
        w(names[i])
        w(b"\n")
        w(seq_mv[offs[i]:offs[i + 1]])
        w(b"\n+")
        if plus_name:
            w(names[i])
        w(b"\n")
        w(qual_mv[offs[i]:offs[i + 1]])
        w(b"\n")
    return out.getvalue()


def format_fasta(batch: FastqBatch) -> bytes:
    names = batch.names()
    lens = np.asarray(batch.lens, np.uint32).astype(np.int64)
    n = batch.num_records
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    seq_mv = memoryview(batch.seq_buf)
    out = io.BytesIO()
    w = out.write
    for i in range(n):
        w(b">")
        w(names[i])
        w(b"\n")
        w(seq_mv[offs[i]:offs[i + 1]])
        w(b"\n")
    return out.getvalue()


def split_batch(batch: FastqBatch) -> tuple[FastqBatch, FastqBatch]:
    """De-interleave: even records -> R1 batch, odd -> R2 batch.

    Vectorised via the range gather helpers (fastq_fast)."""
    from fqzcomp5_tpu_torch.fastq_fast import concat_ranges

    n = batch.num_records
    blens = np.asarray(batch.lens, np.uint32)
    bflags = np.asarray(batch.flags, np.uint32)
    lens = blens.astype(np.int64)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    nb = np.frombuffer(batch.name_buf, np.uint8)
    nul = np.flatnonzero(nb == 0)
    nstart = np.empty(n, np.int64)
    nstart[0] = 0
    nstart[1:] = nul[:-1] + 1
    nend = nul + 1  # include the NUL separator
    sq = np.frombuffer(batch.seq_buf, np.uint8)
    ql = np.frombuffer(batch.qual_buf, np.uint8)
    halves = []
    for parity in (0, 1):
        sel = np.arange(parity, n, 2)
        ls = blens[sel] if sel.size else np.zeros(0, np.uint32)
        halves.append(FastqBatch(
            name_buf=concat_ranges(nb, nstart[sel], nend[sel]).tobytes(),
            seq_buf=concat_ranges(sq, offs[sel], offs[sel + 1]).tobytes(),
            qual_buf=concat_ranges(ql, offs[sel], offs[sel + 1]).tobytes()
            if len(ql) else b"",
            lens=ls,
            flags=bflags[sel] if sel.size else np.zeros(0, np.uint32),
            fixed_len=max(_fixed_len(ls), 0), is_fasta=batch.is_fasta,
        ))
    return halves[0], halves[1]
