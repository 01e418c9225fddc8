"""FQZ5 container framing: header, blocks, index, trailer, CRC walk.

Byte-compatible with the reference format (spec: fqzcomp5.c:35-82;
write_header/read_header fqzcomp5.c:2563-2604; write_index/read_index
fqzcomp5.c:2606-2672; write_trailer/read_trailer fqzcomp5.c:2683-2733).
All integers are little-endian.
"""

from __future__ import annotations

from fqzcomp5_tpu_torch.utils import lightclass as dataclasses  # noqa: N813 — see lightclass.py
import struct
import zlib
# typing import dropped: costs ~12ms of CLI cold-start; all uses
# are string annotations (from __future__ import annotations)

from fqzcomp5_tpu_torch.constants import (
    INDEX_MAGIC,
    MAGIC_LEN,
    MAGIC_V10,
    MAGIC_V11,
    TRAILER_MAGIC,
    VERS_HEADERLESS,
    VERS_V10,
    VERS_V11,
)


@dataclasses.dataclass
class IndexEntry:
    offset: int     # file offset of block start
    usize: int      # uncompressed size (total bases)
    nrecords: int


@dataclasses.dataclass
class FileIndex:
    entries: list[IndexEntry] = dataclasses.field(default_factory=list)

    def add(self, offset: int, usize: int, nrecords: int) -> None:
        self.entries.append(IndexEntry(offset, usize, nrecords))

    @property
    def nblocks(self) -> int:
        return len(self.entries)


def crc32(data: bytes, value: int = 0) -> int:
    """zlib-polynomial CRC32 as used for per-block checksums."""
    return zlib.crc32(data, value) & 0xFFFFFFFF


def write_header(fp: BinaryIO) -> None:
    fp.write(MAGIC_V11)
    fp.write(struct.pack("<Q", 0))  # index offset patched at EOF


def read_header(fp: BinaryIO) -> tuple[int, int]:
    """Returns (file_version, index_offset).

    file_version: VERS_V11 (0), VERS_V10 (1), or VERS_HEADERLESS (2,
    in which case the stream is rewound to offset 0).
    """
    magic = fp.read(MAGIC_LEN)
    if magic == MAGIC_V11:
        (off,) = struct.unpack("<Q", fp.read(8))
        return VERS_V11, off
    if magic == MAGIC_V10:
        (off,) = struct.unpack("<Q", fp.read(8))
        return VERS_V10, off
    fp.seek(0)
    return VERS_HEADERLESS, 0


def write_index(fp: BinaryIO, idx: FileIndex) -> None:
    if idx.nblocks == 0:
        return
    fp.write(INDEX_MAGIC)
    fp.write(struct.pack("<I", idx.nblocks))
    for e in idx.entries:
        fp.write(struct.pack("<QII", e.offset, e.usize, e.nrecords))


def read_index(fp: BinaryIO, index_offset: int) -> Optional[FileIndex]:
    if index_offset == 0:
        return None
    fp.seek(index_offset)
    if fp.read(len(INDEX_MAGIC)) != INDEX_MAGIC:
        return None
    raw = fp.read(4)
    if len(raw) != 4:
        return None
    (nblocks,) = struct.unpack("<I", raw)
    idx = FileIndex()
    for _ in range(nblocks):
        raw = fp.read(16)
        if len(raw) != 16:
            return None
        off, usize, nrec = struct.unpack("<QII", raw)
        idx.add(off, usize, nrec)
    return idx


def patch_index_offset(fp: BinaryIO, index_offset: int) -> None:
    """Write the index offset back into the header (fqzcomp5.c:3190-3200)."""
    fp.seek(MAGIC_LEN)
    fp.write(struct.pack("<Q", index_offset))
    fp.seek(0, 2)


def write_trailer(fp: BinaryIO, overall_crc: int, nblocks: int) -> None:
    fp.write(TRAILER_MAGIC)
    fp.write(struct.pack("<II", overall_crc, nblocks))


def read_trailer(fp: BinaryIO) -> Optional[tuple[int, int]]:
    magic = fp.read(len(TRAILER_MAGIC))
    if magic != TRAILER_MAGIC:
        return None
    raw = fp.read(8)
    if len(raw) != 8:
        return None
    return struct.unpack("<II", raw)


def iter_raw_blocks(fp: BinaryIO, index_offset: int) -> Iterator[bytes]:
    """Yield whole serialized blocks (including the leading size u32).

    Stops at the index offset (if any) or EOF, matching the decode
    drivers' read loop (fqzcomp5.c:3769-3797).
    """
    while True:
        pos = fp.tell()
        if index_offset > 0 and pos >= index_offset:
            return
        raw = fp.read(4)
        if len(raw) != 4:
            return
        (block_size,) = struct.unpack("<I", raw)
        body = fp.read(block_size)
        if len(body) != block_size:
            raise IOError("truncated block")
        yield raw + body


@dataclasses.dataclass
class BlockSummary:
    nrecords: int
    crc_ok: Optional[bool]       # None when file has no CRCs
    name_usize: int = 0
    seq_usize: int = 0
    qual_usize: int = 0
    csize: int = 0


def summarize_block(raw: bytes, has_crc: bool) -> BlockSummary:
    """Parse section metas of one serialized block without decoding.

    Mirrors the walk in inspect_file (fqzcomp5.c:4345-4606).
    """
    (block_size,) = struct.unpack_from("<I", raw, 0)
    (nrec,) = struct.unpack_from("<I", raw, 4)
    off = 8
    crc_ok = None
    if has_crc:
        (stored_crc,) = struct.unpack_from("<I", raw, off)
        off += 4
        crc_ok = crc32(raw[off:]) == stored_crc
    s = BlockSummary(nrecords=nrec, crc_ok=crc_ok, csize=block_size)
    end = len(raw)
    try:
        # Names: [u32 ulen][u8 strat][u32 clen][data]
        (s.name_usize,) = struct.unpack_from("<I", raw, off)
        off += 4 + 1
        (nclen,) = struct.unpack_from("<I", raw, off)
        off += 4 + nclen
        # Lengths
        lstrat = raw[off]
        off += 1
        if lstrat > 0:
            # fixed-length varint, lstrat holds its byte count
            off += lstrat
        else:
            (blen,) = struct.unpack_from("<I", raw, off)
            off += 4 + blen
        # Seq: [u8 strat][u32 ulen][u32 clen][data]
        off += 1
        (s.seq_usize,) = struct.unpack_from("<I", raw, off)
        off += 4
        (sclen,) = struct.unpack_from("<I", raw, off)
        off += 4 + sclen
        # Qual
        off += 1
        (s.qual_usize,) = struct.unpack_from("<I", raw, off)
        off += 4
        (qclen,) = struct.unpack_from("<I", raw, off)
        off += 4 + qclen
        if off > end:
            raise ValueError
    except (struct.error, ValueError, IndexError):
        pass  # truncated metadata; report what we have (reference tolerates)
    return s
