"""Vectorised FASTQ parsing/formatting (numpy), with safe fallback.

The generic Parser walks records one at a time in Python; for the
overwhelmingly common case — clean 4-line FASTQ, single-line sequences,
no CR — this module parses whole chunks with numpy array ops:
newline indexing, range-gather/scatter tricks, vectorised flag and
length computation.  Anything unusual falls back to the generic path.
"""

from __future__ import annotations

from fqzcomp5_tpu_torch.utils.lazy_np import np

from fqzcomp5_tpu_torch.constants import FQZ_FREAD2


def _have_native() -> bool:
    global _NATIVE
    if _NATIVE is None:
        try:
            from fqzcomp5_tpu_torch.codecs import native

            native.lib().fqz5_gather_ranges
            _NATIVE = True
        except Exception:
            _NATIVE = False
    return _NATIVE


_NATIVE = None


def concat_ranges(data: np.ndarray, starts, ends) -> np.ndarray:
    """Gather data[starts[i]:ends[i]] for all i, concatenated. O(total)."""
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, data.dtype)
    # adjacent ranges (e.g. whole-buffer record spans) need no copy
    if (len(starts) and total == ends[-1] - starts[0]
            and bool((starts[1:] == ends[:-1]).all())):
        return data[starts[0]:ends[-1]]
    if data.dtype == np.uint8 and _have_native():
        from fqzcomp5_tpu_torch.codecs import native

        return native.gather_ranges(data, starts, ends, total)
    idx = np.ones(total, np.int64)
    idx[0] = starts[0]
    nz = lens > 0
    # positions where a new range begins (skip empty ranges)
    firsts = np.flatnonzero(nz)
    # for each non-empty range after the first, the jump from the end of
    # the previous non-empty range
    if firsts.size > 1:
        prev_end = ends[firsts[:-1]]
        jump = starts[firsts[1:]] - prev_end + 1
        dst = np.cumsum(lens)[firsts[1:]] - lens[firsts[1:]]
        idx[dst] = jump
    idx = np.cumsum(idx)
    return data[idx]


def scatter_ranges(dst: np.ndarray, dst_starts, src_cat: np.ndarray,
                   lens) -> None:
    """Scatter consecutive src slices to dst at dst_starts (vectorised)."""
    lens = np.asarray(lens, np.int64)
    dst_starts = np.asarray(dst_starts, np.int64)
    total = int(lens.sum())
    if total == 0:
        return
    if (dst.dtype == np.uint8 and src_cat.dtype == np.uint8
            and _have_native()):
        from fqzcomp5_tpu_torch.codecs import native

        native.scatter_ranges(dst, dst_starts, src_cat, lens)
        return
    idx = np.ones(total, np.int64)
    nz = lens > 0
    firsts = np.flatnonzero(nz)
    idx[0] = dst_starts[firsts[0]]
    if firsts.size > 1:
        prev_end = dst_starts[firsts[:-1]] + lens[firsts[:-1]]
        jump = dst_starts[firsts[1:]] - prev_end + 1
        at = np.cumsum(lens)[firsts[1:]] - lens[firsts[1:]]
        idx[at] = jump
    idx = np.cumsum(idx)
    dst[idx] = src_cat[:total]


class ParsedRecords:
    """SoA for a chunk of clean 4-line FASTQ records.

    Index fields are stdlib array('q') on the native path (the encode
    CLI stays numpy-free; see utils/lazy_np.py) or int64 ndarrays on
    the fallback path.  ``data`` is either an ndarray over the chunk or
    a ("raw", buf, off) tuple whose offsets the fields are relative to.
    """

    __slots__ = ("data", "name_s", "name_e", "core_len", "seq_s", "seq_e",
                 "qual_s", "_acc")

    def __init__(self, data, name_s, name_e, core_len, seq_s, seq_e, qual_s):
        self.data = data
        self.name_s = name_s
        self.name_e = name_e
        self.core_len = core_len
        self.seq_s = seq_s
        self.seq_e = seq_e
        self.qual_s = qual_s
        self._acc = None

    @property
    def acc_size(self):
        """kseq block accounting: core name + 1 + seq + qual (ndarray;
        only the numpy-using callers — paired/scan — touch this)."""
        if self._acc is None:
            cl = np.asarray(self.core_len, np.int64)
            ss = np.asarray(self.seq_s, np.int64)
            se = np.asarray(self.seq_e, np.int64)
            self._acc = cl + 1 + 2 * (se - ss)
        return self._acc

    @property
    def n(self):
        return len(self.name_s)

    def slice(self, lo, hi):
        return ParsedRecords(self.data, self.name_s[lo:hi],
                             self.name_e[lo:hi], self.core_len[lo:hi],
                             self.seq_s[lo:hi], self.seq_e[lo:hi],
                             self.qual_s[lo:hi])


def parse_chunk_raw(buf, off: int, size: int):
    """Numpy-free chunk parse over buf[off:off+size] (native only).

    Returns (ParsedRecords with ("raw", buf, off) data, tail_offset)
    or None when the chunk isn't clean 4-line FASTQ — or the native
    library is unavailable (caller falls back to parse_chunk)."""
    if size <= 0 or not _have_native():
        return None
    from fqzcomp5_tpu_torch.codecs import native

    r = native.parse_fastq_chunk(buf, off, size)
    if r is None:
        return None
    name_s, name_e, core_len, seq_s, seq_e, qual_s, tail = r
    return ParsedRecords(("raw", buf, off), name_s, name_e, core_len,
                         seq_s, seq_e, qual_s), tail


def parse_chunk(data: np.ndarray):
    """Parse a byte array of complete 4-line records.

    Returns (ParsedRecords, tail_offset) where tail_offset is the start
    of the trailing incomplete record, or None if the chunk isn't clean
    4-line FASTQ (caller falls back to the generic parser).
    """
    if data.size == 0:
        return None
    if _have_native():
        from fqzcomp5_tpu_torch.codecs import native

        r = native.parse_fastq_chunk(data)
        if r is None:
            return None
        name_s, name_e, core_len, seq_s, seq_e, qual_s, tail = r
        return ParsedRecords(data, name_s, name_e, core_len, seq_s,
                             seq_e, qual_s), tail
    # fallback if exotic whitespace anywhere (kseq treats \r\v\f as
    # separators inside headers; the slow path handles those)
    if (data == 13).any() or (data == 11).any() or (data == 12).any():
        return None
    nl = np.flatnonzero(data == 10)
    if nl.size < 4:
        return None
    nfull = (nl.size // 4) * 4
    # line starts/ends
    starts = np.empty(nfull, np.int64)
    starts[0] = 0
    starts[1:] = nl[:nfull - 1] + 1
    ends = nl[:nfull]

    name_s = starts[0::4]
    name_e = ends[0::4]
    seq_s = starts[1::4]
    seq_e = ends[1::4]
    plus_s = starts[2::4]
    plus_e = ends[2::4]
    qual_s = starts[3::4]
    qual_e = ends[3::4]

    if not (data[name_s] == ord("@")).all():
        return None
    if not (data[plus_s] == ord("+")).all():
        return None
    # reference ignores the +line body entirely
    del plus_e
    if not ((seq_e - seq_s) == (qual_e - qual_s)).all():
        return None
    # sequences must not start with @/+ ambiguity is resolved by the
    # 4-line structure itself; but multi-line records would misparse as
    # a name-line check failure above, so we're safe.

    name_s = name_s + 1  # skip '@'

    # comment split: first space or tab inside the name
    ws = np.flatnonzero((data == 32) | (data == 9))
    core_len = (name_e - name_s).astype(np.int64)
    if ws.size:
        k = np.searchsorted(ws, name_s)
        k = np.clip(k, 0, ws.size - 1)
        first_ws = ws[k]
        has = (first_ws >= name_s) & (first_ws < name_e)
        core_len = np.where(has, first_ws - name_s, core_len)

    tail = int(nl[nfull - 1] + 1)
    return ParsedRecords(data, name_s, name_e, core_len, seq_s, seq_e,
                         qual_s), tail


def compute_flags(data: np.ndarray, recs: ParsedRecords) -> np.ndarray:
    """Vectorised FREAD2 flags (suffix '/2' or duplicate-of-previous)."""
    n = recs.n
    flags = np.zeros(n, np.uint32)
    name_s = np.asarray(recs.name_s, np.int64)
    name_e = np.asarray(recs.name_e, np.int64)
    recs = ParsedRecords(recs.data, name_s, name_e,
                         np.asarray(recs.core_len, np.int64),
                         np.asarray(recs.seq_s, np.int64),
                         np.asarray(recs.seq_e, np.int64),
                         np.asarray(recs.qual_s, np.int64))
    lens = name_e - name_s
    long_enough = lens > 1
    last1 = np.where(long_enough, data[np.minimum(
        name_e - 1, len(data) - 1)], 0)
    last2 = np.where(long_enough, data[np.maximum(name_e - 2, 0)], 0)
    flags[(last2 == ord("/")) & (last1 == ord("2")) & long_enough] = FQZ_FREAD2

    # duplicate-name check: filter candidates by (length, byte-sum)
    # before exact verification — exact dups are rare outside
    # interleaved no-suffix data
    if n > 1 and bool((lens == 0).any()):
        # zero-length names break the reduceat segmentation (clamped
        # offsets merge neighbouring segments); rare enough to take
        # the per-record path
        prev = None
        for i in range(n):
            nm = bytes(data[recs.name_s[i]:recs.name_e[i]])
            if not flags[i] and prev is not None and nm == prev:
                flags[i] = FQZ_FREAD2
            prev = nm
        return flags
    if n > 1:
        ncat = concat_ranges(data, recs.name_s, recs.name_e)
        offs = (np.cumsum(lens) - lens)
        sums = np.add.reduceat(ncat.astype(np.int32), offs)
        sums = sums[:n]
        cand = np.flatnonzero((lens[1:] == lens[:-1])
                              & (sums[1:] == sums[:-1]))
        if cand.size:
            # exact verification, still vectorised: gather both names
            # of every candidate pair and segment-reduce the mismatch
            L = lens[cand].astype(np.int64)
            a_cat = concat_ranges(data, recs.name_s[cand],
                                  recs.name_e[cand])
            b_cat = concat_ranges(data, recs.name_s[cand + 1],
                                  recs.name_e[cand + 1])
            # all lens > 0 on this branch, so the segmentation offsets
            # are strictly increasing and in range
            neq = (a_cat != b_cat).astype(np.int32)
            offs2 = np.cumsum(L) - L
            seg = np.add.reduceat(neq, offs2)[:len(cand)]
            flags[cand[seg == 0] + 1] = FQZ_FREAD2
    return flags


def build_batch(recs: ParsedRecords):
    """Materialise a FastqBatch from parsed record ranges."""
    from fqzcomp5_tpu_torch.fastq import FastqBatch

    data = recs.data
    n = recs.n
    raw = isinstance(data, tuple)
    if n and _have_native() and (raw or data.dtype == np.uint8):
        # one C++ pass builds all three buffers + lens + flags
        from fqzcomp5_tpu_torch.codecs import native

        nb, sb, qb, lens32, flags = native.build_soa(
            data[1] if raw else data, recs.name_s, recs.name_e,
            recs.core_len, recs.seq_s, recs.seq_e, recs.qual_s,
            off=data[2] if raw else 0)
        first = int(lens32[0])
        fixed = first if lens32.count(first) == n else 0
        return FastqBatch(name_buf=nb, seq_buf=sb, qual_buf=qb,
                          lens=lens32, flags=flags, fixed_len=fixed,
                          is_fasta=False)
    name_lens = (recs.name_e - recs.name_s).astype(np.int64)
    # name buffer with NUL separators
    nb_total = int(name_lens.sum()) + n
    name_buf = np.zeros(nb_total, np.uint8)
    dst_starts = np.cumsum(name_lens + 1) - (name_lens + 1)
    names_cat = concat_ranges(data, recs.name_s, recs.name_e)
    scatter_ranges(name_buf, dst_starts, names_cat, name_lens)
    # kseq stores "name<SPACE>comment" even for a tab separator
    # (fqzcomp5.c:509): normalise the separator byte
    has_comment = recs.core_len < name_lens
    if has_comment.any():
        sep_pos = (dst_starts + recs.core_len)[has_comment]
        name_buf[sep_pos] = np.where(name_buf[sep_pos] == 9, 32,
                                     name_buf[sep_pos])

    seq_buf = concat_ranges(data, recs.seq_s, recs.seq_e)
    lens32 = (recs.seq_e - recs.seq_s).astype(np.uint32)
    qual_cat = concat_ranges(data, recs.qual_s,
                             recs.qual_s + (recs.seq_e - recs.seq_s))
    qual_buf = (qual_cat - 33).astype(np.uint8)

    flags = compute_flags(data, recs)
    first = int(lens32[0]) if n else 0
    fixed = first if n and bool((lens32 == first).all()) else 0
    return FastqBatch(
        name_buf=name_buf.tobytes(), seq_buf=seq_buf.tobytes(),
        qual_buf=qual_buf.tobytes(), lens=lens32, flags=flags,
        fixed_len=fixed, is_fasta=False)


def format_fastq_fast(batch, plus_name: bool = False) -> bytes:
    """Vectorised FASTQ formatting (inverse of build_batch)."""
    n = batch.num_records
    if n == 0:
        return b""
    if _have_native():
        from fqzcomp5_tpu_torch.codecs import native

        return native.format_fastq(batch.name_buf, batch.seq_buf,
                                   batch.qual_buf, batch.lens, plus_name)
    nb = np.frombuffer(batch.name_buf, np.uint8)
    sq = np.frombuffer(batch.seq_buf, np.uint8)
    ql = np.frombuffer(batch.qual_buf, np.uint8)
    nul = np.flatnonzero(nb == 0)
    name_e = nul
    name_s = np.empty(n, np.int64)
    name_s[0] = 0
    name_s[1:] = nul[:-1] + 1
    name_lens = name_e - name_s
    lens = np.asarray(batch.lens, np.uint32).astype(np.int64)
    soff = np.concatenate([[0], np.cumsum(lens)])

    plus_extra = name_lens if plus_name else np.zeros(n, np.int64)
    rec_lens = 1 + name_lens + 1 + lens + 1 + 1 + plus_extra + 1 + lens + 1
    out_total = int(rec_lens.sum())
    out = np.empty(out_total, np.uint8)
    rec_starts = np.cumsum(rec_lens) - rec_lens

    out[rec_starts] = ord("@")
    scatter_ranges(out, rec_starts + 1, concat_ranges(nb, name_s, name_e),
                   name_lens)
    p = rec_starts + 1 + name_lens
    out[p] = ord("\n")
    scatter_ranges(out, p + 1, concat_ranges(sq, soff[:-1], soff[1:]), lens)
    p = p + 1 + lens
    out[p] = ord("\n")
    out[p + 1] = ord("+")
    if plus_name:
        scatter_ranges(out, p + 2,
                       concat_ranges(nb, name_s, name_e), name_lens)
        p = p + 2 + name_lens
    else:
        p = p + 2
    out[p] = ord("\n")
    qcat = concat_ranges(ql, soff[:-1], soff[1:]) + 33
    scatter_ranges(out, p + 1, qcat, lens)
    out[p + 1 + lens] = ord("\n")
    return out.tobytes()


def interleave_batches(b1, b2):
    """Merge two equal-length batches record-alternating (R1,R2,...).

    Used by the fast paired-end path; R2 records get FQZ_FREAD2
    unconditionally (fqzcomp5.c:1044-1047)."""
    from fqzcomp5_tpu_torch.fastq import FastqBatch

    n = b1.num_records
    assert n == b2.num_records

    def name_bounds(batch):
        nb = np.frombuffer(batch.name_buf, np.uint8)
        nul = np.flatnonzero(nb == 0)
        s = np.empty(len(nul), np.int64)
        s[0] = 0
        s[1:] = nul[:-1] + 1
        return nb, s, nul + 1  # include NUL

    nb1, s1, e1 = name_bounds(b1)
    nb2, s2, e2 = name_bounds(b2)
    nl1 = e1 - s1
    nl2 = e2 - s2
    out_nlens = np.empty(2 * n, np.int64)
    out_nlens[0::2] = nl1
    out_nlens[1::2] = nl2
    ndst = np.cumsum(out_nlens) - out_nlens
    name_buf = np.empty(int(out_nlens.sum()), np.uint8)
    scatter_ranges(name_buf, ndst[0::2], concat_ranges(nb1, s1, e1), nl1)
    scatter_ranges(name_buf, ndst[1::2], concat_ranges(nb2, s2, e2), nl2)

    def interleave_payload(p1, p2, l1, l2):
        a1 = np.frombuffer(p1, np.uint8)
        a2 = np.frombuffer(p2, np.uint8)
        lens = np.empty(2 * n, np.int64)
        lens[0::2] = l1
        lens[1::2] = l2
        dst = np.cumsum(lens) - lens
        out = np.empty(int(lens.sum()), np.uint8)
        o1 = np.cumsum(l1) - l1
        o2 = np.cumsum(l2) - l2
        scatter_ranges(out, dst[0::2], concat_ranges(a1, o1, o1 + l1), l1)
        scatter_ranges(out, dst[1::2], concat_ranges(a2, o2, o2 + l2), l2)
        return out.tobytes()

    l1 = np.asarray(b1.lens, np.uint32).astype(np.int64)
    l2 = np.asarray(b2.lens, np.uint32).astype(np.int64)
    seq_buf = interleave_payload(b1.seq_buf, b2.seq_buf, l1, l2)
    qual_buf = b""
    if not b1.is_fasta:
        qual_buf = interleave_payload(b1.qual_buf, b2.qual_buf, l1, l2)

    lens = np.empty(2 * n, np.uint32)
    lens[0::2] = b1.lens
    lens[1::2] = b2.lens
    flags = np.zeros(2 * n, np.uint32)
    flags[1::2] = FQZ_FREAD2
    first = int(lens[0]) if lens.size else 0
    return FastqBatch(
        name_buf=name_buf.tobytes(), seq_buf=seq_buf, qual_buf=qual_buf,
        lens=lens, flags=flags,
        fixed_len=first if lens.size and bool((lens == first).all()) else 0,
        is_fasta=b1.is_fasta)
